"""Parameter-spec trees: one source of truth for shape, init and dtype
(port of ``repro.models.params``).

``ParamSpec`` describes a single tensor; model assembly builds a nested dict
of specs, from which :func:`init_params` materialises the parameters: a dict
of tensors with the same keys, the stacked group dim first. The spec's
``axes`` name the logical sharding axes of the JAX package; the port runs on
one device and keeps them only so the trees stay comparable
(``abstract_params`` and ``param_shardings`` wait for the multi-GPU item).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

#: Leaves at least this large are drawn one leading slice at a time, so the
#: f32 draw never holds a whole stacked leaf (qwen2-7b's ``wi`` is 1.9 B
#: elements).
SLICED_INIT_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | scaled:<f> | const:<v> |
                               # mamba_a_log | mamba_dt_bias | uniform_fan
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a JAX dtype name ("float32", "bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _materialize(spec: ParamSpec, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype)
    kind, _, arg = spec.init.partition(":")
    if kind == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if kind == "const":
        return torch.full(spec.shape, float(arg), dtype=dtype, device=device)
    if kind == "mamba_a_log":
        # A = -exp(A_log); A_log = log(1..N) broadcast over the channels.
        a = torch.log(torch.arange(1, spec.shape[-1] + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(spec.shape).to(dtype)
    if kind == "normal" or kind == "scaled":
        std = 0.02 if kind == "normal" else float(arg)

        def draw(shape):
            return torch.randn(shape, generator=gen, device=device) * std
    elif kind == "uniform_fan":
        # The JAX package's fan_in is the leading dim (of a stacked leaf,
        # the number of layer groups).
        bound = 1.0 / math.sqrt(max(spec.shape[0] if spec.shape else 1, 1))

        def draw(shape):
            u = torch.rand(shape, generator=gen, device=device)
            return u * (2 * bound) - bound
    elif kind == "mamba_dt_bias":
        # softplus^-1(dt) for dt ~ logU[1e-3, 1e-1].
        def draw(shape):
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            return dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    if len(spec.shape) < 2 or math.prod(spec.shape) < SLICED_INIT_ELEMENTS:
        return draw(spec.shape).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for i in range(spec.shape[0]):
        out[i] = draw(spec.shape[1:])
    return out


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_paths(tree, prefix=()):
    if _is_spec(tree) or isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for k in sorted(tree.keys()):
        yield from tree_paths(tree[k], prefix + (k,))


def init_params(spec_tree, generator: torch.Generator,
                device: DeviceLike = None):
    """Materialise a spec tree on ``device`` (default: the card), one leaf at
    a time in sorted path order, from ``generator`` (whose device must be
    the target's). Large leaves are drawn one leading slice at a time. The
    numbers differ from ``jax.random``'s for the same seed; the parity tests
    carry the JAX parameters across instead (``interop.lm_params_from_numpy``).
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {dev}")
    out: dict = {}
    for path, spec in tree_paths(spec_tree):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _materialize(spec, generator, dev)
    return out


def param_count(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_paths(spec_tree))


def param_bytes(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
               for _, s in tree_paths(spec_tree))


def stack_specs(spec_tree, num: int, axis_name: str = "layers"):
    """Add a leading stacked dim (one entry per layer group)."""
    def build(tree):
        if _is_spec(tree):
            return ParamSpec(shape=(num,) + tree.shape, axes=(axis_name,) + tree.axes,
                             init=tree.init, dtype=tree.dtype)
        return {k: build(v) for k, v in tree.items()}

    return build(spec_tree)
