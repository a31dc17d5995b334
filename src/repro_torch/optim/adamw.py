"""AdamW with optional 8-bit (block-quantized) moments (port of
``repro.optim.adamw``).

The 8-bit mode stores m and v as int8 codes with an f32 absmax scale per
256-element block of the **last** axis (Dettmers-style), cutting the
optimizer's memory 4× against f32. Gradient clipping is global-norm; weight
decay is decoupled (AdamW) and applies to leaves with two or more dims.

Parameters, gradients and moments are dicts of tensors with the same keys;
at each parameter's position the moments hold a tensor (f32 or bf16) or a
:class:`QTensor`. A 0-d parameter's moments have shape (1,), as in the JAX
package. Where JAX donates its state, :func:`adamw_update` writes the new
parameters and moments into the old tensors in place (under
``torch.no_grad()``) and returns them.

Sharded parameters (``models.shard_params``) get moments of the same
blocks, marked with the same shardings; the update is elementwise on the
blocks, and :func:`global_norm` sums each leaf's squares over the mesh
dims it is split on (a replicated leaf is counted once). An int8 moment
is quantized as the whole tensor's: where the parameter's last dim is
split and its block is not a whole number of 256-element quantization
blocks, the moment keeps that dim whole (replicated over its mesh dims),
and the update gathers the gradient's last dim and keeps the parameter's
block of the step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models import sharding
from ..models.params import tree_paths

QBLOCK = 256  # elements per quantization block (last axis)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: str = "float32"     # float32 | bfloat16 | int8


class QTensor(NamedTuple):
    """Last-axis blockwise-quantized tensor. A named tuple, so the
    checkpoint's tree walk saves its codes and scales as arrays and
    ``orig_last`` as a scalar."""

    codes: torch.Tensor   # int8, lead_dims + (padded_last,)
    scales: torch.Tensor  # f32, lead_dims + (num_blocks,)
    orig_last: int        # unpadded last-dim size


def _quantize(x: torch.Tensor) -> QTensor:
    lead = tuple(x.shape[:-1])
    last = x.shape[-1] if x.dim() else 1
    xf = x.float().reshape(lead + (last,))
    nb = -(-last // QBLOCK)
    pad = nb * QBLOCK - last
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    blocks = xf.reshape(lead + (nb, QBLOCK))
    scales = blocks.abs().amax(dim=-1) / 127.0
    safe = torch.where(scales > 0, scales, 1.0)
    # torch.round rounds half to even, as jnp.round does.
    codes = torch.clamp(torch.round(blocks / safe[..., None]), -127,
                        127).to(torch.int8)
    return QTensor(codes=codes.reshape(lead + (nb * QBLOCK,)), scales=scales,
                   orig_last=last)


def _dequantize(q: QTensor, shape) -> torch.Tensor:
    lead = tuple(q.codes.shape[:-1])
    nb = q.scales.shape[-1]
    blocks = q.codes.float().reshape(lead + (nb, QBLOCK))
    out = (blocks * q.scales[..., None]).reshape(lead + (nb * QBLOCK,))
    return out[..., :q.orig_last].reshape(shape)


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: dict             # congruent with params; tensors or QTensors
    v: dict


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(_DTYPES[dtype])


def _decode(x, shape, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(x, shape)
    return x.float()


def _store(old, new) -> None:
    """Write ``new`` (a tensor or QTensor) into ``old`` in place."""
    if isinstance(old, QTensor):
        old.codes.copy_(new.codes)
        old.scales.copy_(new.scales)
    else:
        old.copy_(new)


def _at(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def _map_params(params: dict, fn) -> dict:
    """``fn(p)`` at every parameter position, as a dict of the params'
    keys."""
    return {k: _map_params(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _shape(p: torch.Tensor) -> tuple:
    return tuple(p.shape) if p.dim() else (1,)


def _whole_last(p: torch.Tensor) -> tuple:
    """The live mesh dims of a block's last dim when an int8 moment must
    keep it whole (the block is not a whole number of quantization blocks),
    else ()."""
    s = sharding.sharding_of(p)
    if s is None or not p.dim():
        return ()
    axes = sharding.live(s.mesh, s.axes(p.dim() - 1))
    return axes if axes and p.shape[-1] % QBLOCK else ()


def _moment_sharding(p: torch.Tensor, dtype: str):
    s = sharding.sharding_of(p)
    if dtype == "int8" and _whole_last(p):
        return s.with_entry(p.dim() - 1, None)
    return s


def _check_moment(path, p: torch.Tensor, q: QTensor, last: int) -> None:
    """An int8 moment must quantize the block's rows and either its last
    dim or the whole tensor's."""
    if tuple(q.codes.shape[:-1]) != tuple(_shape(p)[:-1]) or \
            q.orig_last != last:
        raise ValueError(
            f"int8 moments of {'/'.join(path)}: codes of shape "
            f"{tuple(q.codes.shape)} for a last dim of {q.orig_last}, the "
            f"parameter's block is {tuple(p.shape)} (last dim {last} in "
            f"{QBLOCK}-element quantization blocks): made for another "
            "layout; make the state with adamw_init on these blocks")


def _mark(moment, s):
    """A moment (tensor or QTensor) marked with its parameter's sharding."""
    if s is None:
        return moment
    if isinstance(moment, QTensor):
        sharding.with_sharding(moment.codes, s)
        sharding.with_sharding(moment.scales, s)
        return moment
    return sharding.with_sharding(moment, s)


def adamw_init(params: dict, config: AdamWConfig) -> AdamWState:
    """Zero moments at every parameter's position (shape (1,) for a 0-d
    one), in ``config.state_dtype``, on the parameters' devices, with the
    parameters' shardings (an int8 moment of a block split on its last dim
    into part of a quantization block: that dim whole)."""

    def zero_like(p):
        s = _moment_sharding(p, config.state_dtype)
        shape = _shape(p)
        if s is not sharding.sharding_of(p):
            shape = shape[:-1] + (sharding.sharding_of(p).global_shape(
                p.shape)[-1],)
        return _mark(_encode(torch.zeros(shape, dtype=torch.float32,
                                         device=p.device), config.state_dtype),
                     s)

    leaves = [p for _, p in tree_paths(params)]
    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_map_params(params, zero_like),
                      v=_map_params(params, zero_like))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in key order, of each leaf's sum of
    squares in f32. Blocks of sharded leaves: the sums of the leaves split
    over the same mesh dims are summed over those dims (one all-reduce per
    set of dims), so a replicated leaf counts once."""
    total = None
    split: dict = {}
    for _, g in tree_paths(tree):
        s = g.float().square().sum()
        sh = sharding.sharding_of(g)
        axes = () if sh is None else tuple(sorted(
            {a for d in range(g.dim()) for a in sharding.live(sh.mesh,
                                                              sh.axes(d))}))
        if axes:
            mesh, acc = split.get(axes, (sh.mesh, None))
            split[axes] = (mesh, s if acc is None else acc + s)
            continue
        total = s if total is None else total + s
    for axes, (mesh, acc) in split.items():
        acc = sharding.reduce(acc, axes, mesh)
        total = acc if total is None else total + acc
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState,
                 config: AdamWConfig, lr=None):
    """One AdamW step. Returns ``(params, state, metrics)``: the same
    parameter and moment tensors, updated in place, a new step count, and
    ``{"grad_norm", "clip_factor"}``."""
    lr = config.learning_rate if lr is None else lr
    gnorm = global_norm(grads)
    clip = torch.clamp(config.grad_clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    step = state.step + 1
    b1, b2 = config.beta1, config.beta2
    stepf = step.float()
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    bc1 = 1.0 - torch.pow(one * b1, stepf)
    bc2 = 1.0 - torch.pow(one * b2, stepf)
    dtype = config.state_dtype
    for path, p in tree_paths(params):
        g = _at(grads, path)
        m, v = _at(state.m, path), _at(state.v, path)
        shape = _shape(p)
        g32 = g.float().reshape(shape) * clip
        axes = _whole_last(p) if dtype == "int8" else ()
        if dtype == "int8":
            last = shape[-1] * (sharding.axes_size(
                sharding.sharding_of(p).mesh, axes) if axes else 1)
            _check_moment(path, p, m, last)
        if axes:   # the moments hold the whole last dim
            mesh = sharding.sharding_of(p).mesh
            g32 = sharding._gather_raw(g32, -1 % g32.dim(), mesh, axes)
            shape = tuple(g32.shape)
        m32 = b1 * _decode(m, shape, dtype) + (1 - b1) * g32
        v32 = b2 * _decode(v, shape, dtype) + (1 - b2) * g32 * g32
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + config.eps)
        if axes:
            update = sharding._narrow_block(update, update.dim() - 1, mesh,
                                            axes)
            shape = _shape(p)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            update = update + config.weight_decay * p.float()
        new_p = p.float().reshape(shape) - lr * update
        p.copy_(new_p.reshape(p.shape))
        _store(m, _encode(m32, dtype))
        _store(v, _encode(v32, dtype))
    metrics = {"grad_norm": gnorm, "clip_factor": clip}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def state_bytes(state: AdamWState) -> int:
    """The optimizer state's bytes: every tensor, QTensor codes and scales
    included (``orig_last`` is not an array)."""
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, tuple):
            for v in node:
                walk(v)

    walk(state)
    return total
