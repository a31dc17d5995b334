"""Parameter-spec trees: one source of truth for shape, init and dtype
(port of ``repro.models.params``).

``ParamSpec`` describes a single tensor; model assembly builds a nested dict
of specs, from which :func:`init_params` materialises the parameters: a dict
of tensors with the same keys, the stacked group dim first. The spec's
``axes`` name its logical sharding axes: :func:`param_shardings` maps them
to a mesh's :class:`~.sharding.NamedSharding` (``ShardingRules``), and
:func:`abstract_params` gives meta tensors of the global shapes that carry
them. :func:`shard_params` keeps each rank's block of whole parameters (the
JAX package's ``jax.device_put(params, shardings)``), :func:`gather_params`
puts the blocks back together, and :func:`init_params` with ``shardings``
draws each leaf whole and keeps only its block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .sharding import ShardingRules, make_sharding, reshard, with_sharding

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


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def build_tree(tree, fn):
    """``fn(path, leaf)`` at every leaf of a dict tree, same keys."""
    out: dict = {}
    for path, leaf in tree_paths(tree):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = fn(path, leaf)
    return out


def init_params(spec_tree, generator: torch.Generator,
                device: DeviceLike = None, shardings=None):
    """Materialise a spec tree on ``device`` (default: the card), one leaf at
    a time in sorted path order, from ``generator`` (whose device must be
    the target's). Large leaves are drawn one leading slice at a time. The
    numbers differ from ``jax.random``'s for the same seed; the parity tests
    carry the JAX parameters across instead (``interop.lm_params_from_numpy``).
    With ``shardings`` (:func:`param_shardings`' tree) each rank draws
    every leaf whole, as one device would, and keeps only its block.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {dev}")

    def leaf(path, spec):
        t = _materialize(spec, generator, dev)
        return t if shardings is None else reshard(t, _at(shardings, path))

    return build_tree(spec_tree, leaf)


def param_shardings(spec_tree, mesh, rules: Optional[ShardingRules] = None):
    """The :class:`~.sharding.NamedSharding` of every leaf on ``mesh``: its
    axes under ``rules``, a dim its mesh dims do not divide left whole."""
    return build_tree(spec_tree, lambda _, spec: make_sharding(
        spec.axes, mesh, rules, shape=spec.shape))


def abstract_params(spec_tree, mesh=None,
                    rules: Optional[ShardingRules] = None):
    """Meta tensors of the global shapes and dtypes, each carrying its
    sharding on ``mesh`` (none without one)."""
    return build_tree(spec_tree, lambda _, spec: with_sharding(
        torch.empty(spec.shape, dtype=torch_dtype(spec.dtype), device="meta"),
        make_sharding(spec.axes, mesh, rules, shape=spec.shape)
        if mesh is not None else None))


def shard_params(params, shardings):
    """Each rank's block of whole ``params`` under ``shardings`` (the
    parameters' tree of :class:`~.sharding.NamedSharding`), marked with its
    sharding; a whole block shares the parameter's storage."""
    return build_tree(params, lambda path, t: reshard(t, _at(shardings, path)))


def gather_params(params):
    """The whole parameters of sharded blocks (the inverse of
    :func:`shard_params`; every rank of the mesh takes part)."""
    return build_tree(params, lambda _, t: reshard(t, None))


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
