"""Logical-axis sharding of the LM (port of ``repro.models.sharding``).

Every parameter and major activation is annotated with *logical* axis
names; :class:`ShardingRules` maps logical names to mesh dims. The JAX
package hands the annotated program to GSPMD. The port is SPMD over
``torch.distributed`` (one process per rank, every rank calling the same
function with the same arguments, as ``repro_torch.distributed``): each
rank holds its **local block** of every tensor, and the model code issues
the collective each layout change needs, through
``repro_torch.distributed.mesh``'s ``all_reduce`` and ``broadcast`` on the
mesh dims' process groups (gloo on CUDA tensors has no ``all_gather``).

* A sharded tensor carries its :class:`NamedSharding` as an attribute
  (:func:`with_sharding` / :func:`sharding_of`); a tensor without one is
  replicated. ``models.params.shard_params`` makes such blocks.
* :func:`use_sharding` activates ``(mesh, rules)`` in a context variable;
  without it every function here is a no-op and the model runs as on one
  device, bit for bit.
* Under a context, activations are split on the batch dim over the
  ``batch`` rule's mesh dims from the model's entry on, and every weight is
  used in its *compute layout* (:func:`use`): the rules' spec with the
  batch dims (the FSDP ``embed_w`` dims) gathered. The heads, ffn, experts
  and vocab dims stay on their tensor-parallel dims, so a projection into
  them is column-parallel and one out of them leaves a partial sum that
  :func:`logical_constraint` reduces.
* Collectives are autograd functions, placed as in Megatron-LM: a
  replicated activation entering a tensor-parallel region goes through
  :func:`enter` (identity; the backward sums the gradient over the dims),
  a partial sum leaves through :func:`reduce` (a sum in f32 rounded once to
  the input's dtype; the backward is the identity), a gather's backward
  keeps the rank's block, and an FSDP gather's backward sums over the data
  dims first (a reduce-scatter). Every rank's loss is then the same value,
  and each rank's gradients are those of its own block (summed over the
  data dims by the train step).
* A dim whose mesh dims have size 1 issues no collective: a world of 1 runs
  the single-device arithmetic.

Each rule (:meth:`ShardingRules.spec`, :func:`make_sharding`) is a pure
function of the names, the mesh's dim names and its shape: a
:class:`MeshShape` stands in for a mesh where no world is needed.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from ..distributed import mesh as M

Axis = Union[None, str, Tuple[str, ...]]

#: The tensor attribute that holds a block's sharding.
_ATTR = "_repro_sharding"


class PartitionSpec(tuple):
    """One mesh-dim entry per tensor dim: None (replicated), a dim name,
    or a tuple of dim names (the flattening of several, row-major)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class MeshShape(NamedTuple):
    """A mesh's dim names and sizes without ranks: what the rules read
    (a ``DeviceMesh`` has the same two attributes)."""
    mesh_dim_names: tuple
    shape: tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical name -> mesh axis (or tuple of axes, or None = replicate)."""

    # Weights
    embed_w: Axis = "data"        # FSDP: shard the embed dim of every weight
    vocab: Axis = "model"
    heads: Axis = "model"
    kv_heads: Axis = "model"
    ffn: Axis = "model"
    experts: Axis = "model"
    ssm_inner: Axis = "model"
    rwkv_heads: Axis = "model"
    layers: Axis = None
    # Activations
    batch: Axis = ("pod", "data")
    seq: Axis = None              # seq dim of qkv/ffn activations (leave None)
    res_seq: Axis = None          # residual-stream seq dim only (Megatron SP)
    embed_act: Axis = None        # residual-stream embed dim (alternative SP)
    cache_seq: Axis = None        # long-context decode: shard KV cache length
    # Misc small dims
    head_dim: Axis = None
    ssm_state: Axis = None
    conv: Axis = None
    capacity: Axis = None
    dt_rank: Axis = None
    lora: Axis = None

    def spec(self, *names: Optional[str],
             mesh_axes: Optional[tuple] = None) -> PartitionSpec:
        axes = []
        used: set = set()
        for name in names:
            if name is None:
                axes.append(None)
                continue
            ax = getattr(self, name)
            # Drop axes absent from this mesh ("pod" on a single-pod mesh)
            # and axes already consumed by an earlier dim.
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax
                           if a not in used and (mesh_axes is None or a in mesh_axes))
                ax = ax or None
                if ax is not None and len(ax) == 1:
                    ax = ax[0]      # 1-tuples as the bare axis name
            elif ax in used or (mesh_axes is not None and ax is not None
                                and ax not in mesh_axes):
                ax = None
            if isinstance(ax, tuple):
                used.update(ax)
            elif ax is not None:
                used.add(ax)
            axes.append(ax)
        return PartitionSpec(*axes)


def entry_axes(entry: Axis) -> tuple:
    """A spec entry as a tuple of dim names (() for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def axes_size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def live(mesh, axes) -> tuple:
    """The dims of ``axes`` with more than one rank: those that need a
    collective."""
    sizes = _sizes(mesh)
    return tuple(a for a in axes if sizes[a] > 1)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any                 # a DeviceMesh, or a MeshShape for the rules
    spec: PartitionSpec

    def axes(self, dim: int) -> tuple:
        return entry_axes(self.spec[dim]) if dim < len(self.spec) else ()

    def shard_shape(self, shape) -> tuple:
        """The local block's shape of a tensor of global ``shape``."""
        return tuple(n // axes_size(self.mesh, self.axes(d))
                     for d, n in enumerate(shape))

    def global_shape(self, local_shape) -> tuple:
        return tuple(n * axes_size(self.mesh, self.axes(d))
                     for d, n in enumerate(local_shape))

    def block(self, shape) -> tuple:
        """This rank's slices of a tensor of global ``shape``."""
        return tuple(_block_slice(self.mesh, self.axes(d), n)
                     for d, n in enumerate(shape))

    def with_entry(self, dim: int, entry: Axis) -> "NamedSharding":
        """This sharding with dim ``dim``'s entry replaced."""
        spec = list(self.spec) + [None] * (dim + 1 - len(self.spec))
        spec[dim] = entry
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def drop_leading(self) -> "NamedSharding":
        """The sharding of one index of the leading dim (a layer group),
        which must not be sharded."""
        if live(self.mesh, self.axes(0)):
            raise NotImplementedError(
                f"sharding the stacked layer dim ({self.spec[0]!r}): the "
                "port's model loops over the layer groups on every rank")
        return NamedSharding(self.mesh, PartitionSpec(*self.spec[1:]))


def _shard_index(mesh, axes) -> int:
    """This rank's row-major index over ``axes``."""
    idx = 0
    for a in axes:
        idx = idx * _sizes(mesh)[a] + mesh.get_local_rank(a)
    return idx


def _block_slice(mesh, axes, n: int) -> slice:
    size = axes_size(mesh, axes)
    if size == 1:
        return slice(None)
    if n % size:
        raise ValueError(f"a dim of {n} does not split over {axes} ({size})")
    i = _shard_index(mesh, axes)
    return slice(i * (n // size), (i + 1) * (n // size))


def with_sharding(t: torch.Tensor, sharding: Optional[NamedSharding]):
    """``t`` marked as a block with ``sharding`` (returned)."""
    setattr(t, _ATTR, sharding)
    return t


def sharding_of(t) -> Optional[NamedSharding]:
    return getattr(t, _ATTR, None)


# ---------------------------------------------------------------------------
# The active (mesh, rules)
# ---------------------------------------------------------------------------

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[ShardingRules] = None):
    """Activate ``(mesh, rules)`` for the model's constraints and
    :func:`make_sharding`; ``mesh`` None deactivates."""
    token = _CTX.set((mesh, rules or ShardingRules()) if mesh is not None
                     else None)
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[tuple]:
    return _CTX.get()


def make_sharding(names: tuple, mesh=None,
                  rules: Optional[ShardingRules] = None,
                  shape: Optional[tuple] = None) -> Optional[NamedSharding]:
    """The :class:`NamedSharding` of a logical-axes tuple. With ``shape``,
    a dim that its mesh axes do not divide evenly is left unsharded."""
    ctx = _CTX.get()
    if mesh is None and ctx is not None:
        mesh, rules = ctx
    if mesh is None:
        return None
    rules = rules or ShardingRules()
    spec = rules.spec(*names, mesh_axes=tuple(mesh.mesh_dim_names))
    if shape is not None:
        fitted = []
        entries = tuple(spec) + (None,) * (len(shape) - len(spec))
        for dim, ax in zip(shape, entries):
            size = axes_size(mesh, entry_axes(ax))
            fitted.append(ax if ax is not None and size and dim % size == 0
                          else None)
        spec = PartitionSpec(*fitted)
    return NamedSharding(mesh, spec)


def batch_axes(mesh, rules: ShardingRules) -> tuple:
    """The mesh dims the batch is split over (the ``batch`` rule's)."""
    return entry_axes(rules.spec("batch",
                                 mesh_axes=tuple(mesh.mesh_dim_names))[0])


def live_batch_axes() -> tuple:
    """The mesh dims of more than one rank that the batch is split over
    under the active context (() without one)."""
    ctx = _CTX.get()
    if ctx is None:
        return ()
    return live(ctx[0], batch_axes(*ctx))


#: Small weight dims that the rules may split for storage only:
#: ``params.shard_params`` splits them as the spec says, and :func:`use`
#: gathers them whole for compute (the backward keeps the rank's block), so
#: the arithmetic is that of the whole weight.
STORAGE_NAMES = ("layers", "head_dim", "ssm_state", "conv", "dt_rank",
                 "lora")
#: Activation dims that compute keeps whole; ``seq`` shows only in the
#: layout of the logits that the forward returns.
WHOLE_NAMES = ("seq", "capacity")
#: The residual stream's layout (sequence parallelism): each block's output
#: is reduced and cut to the rank's block, and gathered whole again at the
#: next block's entry.
RESIDUAL = ("batch", "res_seq", "embed_act")


def check_rules(mesh, rules: ShardingRules) -> None:
    """Refuse the rules the port's design cannot run: ``embed_w`` (the
    FSDP dims, gathered over the data dims only) outside the batch dims,
    and any other name on a batch dim (the port splits activations on the
    batch alone over those dims)."""
    names = tuple(mesh.mesh_dim_names)
    bat = set(batch_axes(mesh, rules))
    if not set(entry_axes(rules.spec("embed_w", mesh_axes=names)[0])) <= bat:
        raise NotImplementedError(
            f"ShardingRules.embed_w={rules.embed_w!r} outside the batch dims "
            f"{sorted(bat)}: the port gathers embed_w over the data dims only")
    for field in dataclasses.fields(rules):
        name = field.name
        if name in ("batch", "embed_w"):
            continue
        shared = set(entry_axes(rules.spec(name, mesh_axes=names)[0])) & bat
        if live(mesh, tuple(shared)):
            raise NotImplementedError(
                f"ShardingRules.{name}={getattr(rules, name)!r} shares a "
                f"batch dim {sorted(shared)}: the port splits only the batch "
                "over the batch dims, and every other dim over the rest")


def residual_layout(seq: int, d: int) -> tuple:
    """The live mesh dims that split the residual stream's (batch, seq, d)
    under the active context: () for the batch (already the rank's rows),
    then the ``res_seq`` and ``embed_act`` dims where they divide ``seq``
    and ``d`` (all () without a context)."""
    ctx = _CTX.get()
    if ctx is None:
        return ((), (), ())
    mesh, rules = ctx
    spec = rules.spec(*RESIDUAL, mesh_axes=tuple(mesh.mesh_dim_names))
    out = [()]
    for n, entry in zip((seq, d), spec[1:]):
        axes = live(mesh, entry_axes(entry))
        out.append(axes if axes and n % axes_size(mesh, axes) == 0 else ())
    return tuple(out)


def whole(x: torch.Tensor, layout: tuple) -> torch.Tensor:
    """``x`` gathered whole on every dim that ``layout`` splits (the
    backward keeps the rank's block of the gradient)."""
    for d, axes in enumerate(layout):
        if axes:
            x = gather(x, d, axes)
    return x


# ---------------------------------------------------------------------------
# Collectives (autograd functions over the live dims)
# ---------------------------------------------------------------------------

def _sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """x summed over ``axes`` in f32 (integers as they are), returned in
    x's dtype; x is not modified."""
    if not axes:
        return x
    if x.is_floating_point():
        y = x.detach().float().clone(memory_format=torch.contiguous_format)
    else:
        y = x.detach().clone(memory_format=torch.contiguous_format)
    M.all_reduce(y, mesh, axes)
    return y.to(x.dtype)


def _gather_raw(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` put together over ``axes``: each
    owner broadcasts its block, bytes as they are (the innermost dim
    first, so the blocks land row-major)."""
    for a in reversed(axes):
        x = x.detach().contiguous()
        raw = x.view(torch.uint8)
        parts = []
        for i in range(_sizes(mesh)[a]):
            buf = raw if i == mesh.get_local_rank(a) else torch.empty_like(raw)
            M.broadcast(buf, mesh, a, src=i)
            parts.append(buf.view(x.dtype))
        x = torch.cat(parts, dim=dim)
    return x


def _narrow_block(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    sl = _block_slice(mesh, axes, x.shape[dim])
    return x.narrow(dim, sl.start, sl.stop - sl.start)


def _pad_sum(g: torch.Tensor, dim: int, lo: int, full: int, mesh, axes):
    """g placed at [lo, lo + len) of a zero tensor of ``full`` along
    ``dim``, summed over ``axes``."""
    shape = list(g.shape)
    shape[dim] = full
    out = g.new_zeros(shape, dtype=torch.float32)
    out.narrow(dim, lo, g.shape[dim]).copy_(g)
    M.all_reduce(out, mesh, axes)
    return out.to(g.dtype)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, sum_grad):
        ctx.args = (dim, mesh, axes, sum_grad)
        return _gather_raw(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, sum_grad = ctx.args
        if sum_grad:
            g = _sum(g, mesh, axes)
        return _narrow_block(g, dim, mesh, axes).contiguous(), None, None, \
            None, None


class _Narrow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, lo, n, mesh, axes):
        ctx.args = (dim, lo, x.shape[dim], mesh, axes)
        return x.narrow(dim, lo, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, lo, full, mesh, axes = ctx.args
        return _pad_sum(g, dim, lo, full, mesh, axes), None, None, None, \
            None, None


class _PartialMM(torch.autograd.Function):
    """a @ b of 2-D bf16 operands with its f32 sums left unrounded: on the
    card one bf16 GEMM with an f32 output (cuBLAS on the tensor cores,
    accumulating in f32), on the CPU an f32 GEMM of their f32 copies (each
    product of two bf16 values is exact in f32); the backward is the bf16
    GEMMs' of the unsharded path."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.T, a.T @ g


def row_parallel(x: torch.Tensor, w: torch.Tensor, axes,
                 mesh=None) -> torch.Tensor:
    """``x @ w`` (w 2-D, cast to x's dtype) whose contraction is split
    over ``axes``: a partial sum for :func:`logical_constraint` to reduce,
    in f32 where x is narrower, so that the sum over the ranks rounds once,
    as one GEMM with f32 accumulation does."""
    w = w.to(x.dtype)
    if not axes or x.dtype == torch.float32:
        return x @ w
    mesh = mesh if mesh is not None else current()[0]
    if not live(mesh, axes):
        return x @ w
    out = _PartialMM.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def reduce(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """A pending partial sum over ``axes`` summed (f32, rounded once to
    x's dtype); the backward passes the gradient through."""
    if not axes:
        return x
    mesh = mesh if mesh is not None else current()[0]
    axes = live(mesh, axes)
    return _Reduce.apply(x, mesh, axes) if axes else x


def all_max(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The elementwise max of x over ``axes`` (outside autograd)."""
    if not axes:
        return x
    mesh = mesh if mesh is not None else current()[0]
    axes = live(mesh, axes)
    if not axes:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    return M.all_reduce(y, mesh, axes, "max")


def enter(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """A replicated ``x`` entering a region that is parallel over ``axes``:
    the identity, whose backward sums the gradient over ``axes``."""
    if not axes:
        return x
    mesh = mesh if mesh is not None else current()[0]
    axes = live(mesh, axes)
    return _Enter.apply(x, mesh, axes) if axes else x


def gather(x: torch.Tensor, dim: int, axes, mesh=None,
           sum_grad: bool = False) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` gathered over ``axes``. The
    backward keeps the rank's block of the gradient, summed over ``axes``
    first when ``sum_grad`` (an FSDP gather: each data rank's gradient is a
    part of the whole)."""
    if not axes:
        return x
    mesh = mesh if mesh is not None else current()[0]
    axes = live(mesh, axes)
    return _Gather.apply(x, dim % x.dim(), mesh, axes, sum_grad) if axes \
        else x


def narrow(x: torch.Tensor, dim: int, lo: int, n: int, axes,
           mesh=None) -> torch.Tensor:
    """``x.narrow(dim, lo, n)`` of a replicated ``x`` by each rank of a
    region parallel over ``axes`` (rank-dependent ``lo``); the backward sums
    the ranks' zero-padded gradients over ``axes``."""
    if axes:
        mesh = mesh if mesh is not None else current()[0]
        axes = live(mesh, axes)
    if not axes:
        return x.narrow(dim, lo, n)
    return _Narrow.apply(x, dim % x.dim(), lo, n, mesh, axes)


def split(x: torch.Tensor, dim: int, axes, mesh=None) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``
    (:func:`narrow` at the rank's offset)."""
    if not axes:
        return x
    mesh = mesh if mesh is not None else current()[0]
    sl = _block_slice(mesh, live(mesh, axes), x.shape[dim])
    if sl == slice(None):
        return x
    return narrow(x, dim, sl.start, sl.stop - sl.start, axes, mesh)


def block_offset(n: int, axes, mesh=None) -> int:
    """The first index of this rank's block of a dim of ``n`` split over
    ``axes``."""
    if not axes:
        return 0
    mesh = mesh if mesh is not None else current()[0]
    sl = _block_slice(mesh, live(mesh, axes), n)
    return sl.start or 0


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def layout(t: torch.Tensor) -> tuple:
    """The live mesh dims of each dim of ``t`` (a tuple of tuples; all
    empty for a tensor without a sharding)."""
    s = sharding_of(t)
    if s is None:
        return ((),) * t.dim()
    return tuple(live(s.mesh, s.axes(d)) for d in range(t.dim()))


def use(w: torch.Tensor, *names: Optional[str]):
    """A weight block in its compute layout under the active context:
    ``(tensor, axes)``, ``axes[d]`` the live mesh dims that split dim d.
    The compute layout is the rules' spec of ``names`` fitted to the
    global shape, without the batch dims and the :data:`STORAGE_NAMES`:
    dims sharded over the data dims (FSDP) are gathered, with a
    reduce-scatter backward; a storage dim is gathered, its backward
    keeping the rank's block; a tensor-parallel dim the weight holds
    otherwise than the rules say is gathered or split.
    Without a context: ``w`` as it is, no dim split.
    """
    ctx = current()
    if ctx is None:
        return w, ((),) * w.dim()
    mesh, rules = ctx
    cur = layout(w)
    s = sharding_of(w)
    shape = s.global_shape(w.shape) if s is not None else tuple(w.shape)
    target = make_sharding(tuple(None if n in STORAGE_NAMES else n
                                 for n in names), mesh, rules, shape=shape)
    bat = set(batch_axes(mesh, rules))
    out = tuple(tuple(a for a in live(mesh, target.axes(d)) if a not in bat)
                for d in range(w.dim()))
    moved = [d for d in range(w.dim()) if cur[d] != out[d]]
    # Every gather before any split: a mesh dim may move between dims.
    for d in moved:
        have = cur[d]
        fsdp = tuple(a for a in have if a in bat)
        if fsdp:
            if len(fsdp) != len(have):
                raise NotImplementedError(
                    f"a weight dim split over batch and model dims {have}")
            w = gather(w, d, fsdp, mesh, sum_grad=True)
        elif have:
            w = gather(w, d, have, mesh)
    for d in moved:
        if out[d]:
            w = split(w, d, out[d], mesh)
    return w, out


def local_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (dim 0) under the active
    context: the batch dims' row-major block (x without one)."""
    ctx = current()
    if ctx is None:
        return x
    mesh, rules = ctx
    axes = live(mesh, batch_axes(mesh, rules))
    if not axes:
        return x
    n = x.shape[0]
    if n % axes_size(mesh, axes):
        raise ValueError(f"a batch of {n} does not split over the batch dims "
                         f"{axes} ({axes_size(mesh, axes)} ranks)")
    return x[_block_slice(mesh, axes, n)]


def logical_constraint(x: torch.Tensor, *names: Optional[str],
                       layout: Optional[tuple] = None,
                       partial=(), output: bool = False) -> torch.Tensor:
    """Make x's block match the rules' spec of ``names`` under the active
    context; the identity without one.

    ``layout`` gives the live mesh dims x's dims are split over now (None:
    replicated), ``partial`` the mesh dims over which x is a pending
    partial sum. A dim named ``"batch"`` is already split (the model splits
    the batch at its entry). In order: the partial sum is reduced, then
    the other dims are gathered, then split to the spec (a dim the spec's
    dims do not divide stays whole, as ``make_sharding`` leaves it). The
    :data:`WHOLE_NAMES` stand for None (compute keeps them whole) but in
    the model's ``output``, the logits.
    """
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    names = tuple(names[:x.dim()]) + (None,) * (x.dim() - len(names))
    if not output:
        names = tuple(None if n in WHOLE_NAMES else n for n in names)
    cur = tuple(layout) if layout is not None else ((),) * x.dim()
    x = reduce(x, partial, mesh)
    spec = rules.spec(*names, mesh_axes=tuple(mesh.mesh_dim_names))
    moves = []
    for d, name in enumerate(names):
        if name == "batch":
            continue
        have = live(mesh, cur[d])
        want = live(mesh, entry_axes(spec[d]))
        if have == want:
            continue
        size = x.shape[d] * axes_size(mesh, have)
        if want and size % axes_size(mesh, want):
            want = ()
        if have != want:
            moves.append((d, have, want))
    # Every gather before any split: a dim split over a mesh dim that
    # another dim is gathered over would gather blocks of different rows.
    for d, have, _ in moves:
        if have:
            x = gather(x, d, have, mesh)
    for d, _, want in moves:
        if want:
            x = split(x, d, want, mesh)
    return x


def reshard(t: torch.Tensor, dst: Optional[NamedSharding]) -> torch.Tensor:
    """``t`` (a block with its attached sharding, or a whole tensor) as the
    block of ``dst`` (None: the whole tensor), outside autograd; the result
    carries ``dst``."""
    src = sharding_of(t)
    ref = dst if dst is not None else src
    out = t.detach()
    moves = []
    for d in range(t.dim() if ref is not None else 0):
        have = live(ref.mesh, src.axes(d)) if src is not None else ()
        want = live(ref.mesh, dst.axes(d)) if dst is not None else ()
        if have != want:
            moves.append((d, have, want))
    # Every gather before any cut, as in logical_constraint.
    for d, have, _ in moves:
        if have:
            out = _gather_raw(out, d, ref.mesh, have)
    for d, _, want in moves:
        if want:
            out = _narrow_block(out, d, ref.mesh, want)
    if (out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
            and out.numel() != t.numel()):
        out = out.clone(memory_format=torch.contiguous_format)
    return with_sharding(out, dst)
