"""Op-level cost counting of eager execution: the counterpart of the JAX
package's ``repro.roofline.hlo_cost``, which walks compiled HLO text. The
port has no HLO; :class:`count_costs` is a ``TorchDispatchMode`` that sees
every ATen op the program runs, on the card, the CPU or the meta device:

* **flops**: matmul-like ops only (``torch.utils.flop_counter``'s
  formulas: 2 × result × contraction for ``mm``/``bmm``/``addmm``, ...),
  as the HLO walker counts ``dot`` ops only. Every loop iteration
  dispatches its ops, so a Python loop of ten matmuls counts ten: the
  "loop-aware" property the walker rebuilds from trip counts.
* **bytes**: each op's input and output bytes (view ops move none), the
  walker's conservative count.
* **wire bytes**: each collective of ``distributed.mesh`` (``all_reduce``,
  ``broadcast``) with its operand's bytes and group size, converted by
  ``analysis.wire_bytes``' ring formulas.
* **scopes**: flops and bytes by the innermost :func:`named_scope`, named
  as the JAX package's ``jax.named_scope`` (``chunked_attention``,
  ``decode_attention``, ``mamba_block``, ``mlp``, ``moe_ffn``,
  ``_wkv_scan``, ``_wkv_chunked``, ``_logits``); "other" outside them.
* **kernels**: a hand-written kernel's wrapper counts itself at its entry
  by its own formula (:func:`kernel`), and nothing inside is counted, so a
  call to the kernel and one to its plain version count the same work.
* **memory**: the bytes of the ``arguments`` given, and the peak of what
  is live (the arguments and every storage made under the counter while a
  tensor holds it; autograd's saved tensors included).

On the meta device (a dry run) an op that makes fresh outputs from meta
inputs is a pure function of their shapes, strides and dtypes and of its
other arguments: the counter runs each such signature's meta kernel once
and makes later outputs as empty meta tensors of the recorded layout,
since the kernels' Python shape rules dominate a dry run's time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: The scope names the JAX package's ``jax.named_scope`` gives.
SCOPES = ("chunked_attention", "decode_attention", "_wkv_scan",
          "_wkv_chunked", "moe_ffn", "mamba_block", "mlp", "_logits")

#: The counter in effect (None: nothing is counted, and the markers below
#: cost one global read).
_ACTIVE: Optional["count_costs"] = None


def named_scope(name: str):
    """Decorate a function: while a counter runs, the ops it dispatches are
    counted under ``name`` (the innermost scope wins)."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            counter = _ACTIVE
            if counter is None:
                return fn(*args, **kwargs)
            counter.scopes.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                counter.scopes.pop()
        return run
    return deco


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """A kernel's call at its wrapper's entry: ``flops`` and ``nbytes``
    counted once under the current scope, and no op inside counted."""
    counter = _ACTIVE
    if counter is None or counter.muted:
        yield
        return
    counter._add(counter._scope(), flops, nbytes)
    counter.cost.kernels[name] = counter.cost.kernels.get(name, 0) + 1
    counter.muted += 1
    try:
        yield
    finally:
        counter.muted -= 1


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    ops: int = 0
    collective_bytes_by_op: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    scope_flops: dict = dataclasses.field(default_factory=dict)
    scope_bytes: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return flop_registry


#: Namespaces of the collectives' own ops (their bytes go to the wire).
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _signature(func, args, kwargs):
    """A hashable key of an op's call on meta tensors, or None (a tensor
    off the meta device, or an argument without a hash)."""
    def key(a):
        if isinstance(a, torch.Tensor):
            if not a.is_meta:
                raise TypeError
            return ("T", tuple(a.shape), a.stride(), a.dtype,
                    a.storage_offset())
        if isinstance(a, (list, tuple)):
            return tuple(key(x) for x in a)
        hash(a)
        return a

    try:
        return (func, key(args), tuple(sorted((k, key(v))
                                              for k, v in kwargs.items())))
    except TypeError:
        return None


def _layout(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_layout(x) for x in out))
    return ("V", out)


def _remake(layout):
    if layout[0] == "T":
        return torch.empty_strided(layout[1], layout[2], dtype=layout[3],
                                   device="meta")
    if layout[0] == "V":
        return layout[1]
    return layout[0](_remake(x) for x in layout[1])


def _fresh(func) -> bool:
    """An op whose outputs are new tensors: no view, no mutation, no
    output aliasing an input."""
    schema = func._schema
    return not (func.is_view or schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns))


class count_costs(TorchDispatchMode):
    """``with count_costs(arguments=...) as c: ...`` counts every op run
    inside into ``c.cost`` (:class:`OpCost`). ``arguments`` (a tree of
    tensors: the parameters, the optimizer state, the batch) gives the
    argument bytes and the live bytes at the start."""

    def __init__(self, arguments=None):
        super().__init__()
        self.cost = OpCost()
        self.scopes: list = []
        self.muted = 0
        self._live: dict = {}
        self._live_bytes = 0
        self._arguments = arguments
        self._registry = _flop_registry()
        self._prev = None
        self._memo: dict = {}

    # -- bookkeeping -------------------------------------------------------
    def _scope(self) -> str:
        return self.scopes[-1] if self.scopes else "other"

    def _add(self, scope: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        if flops:
            c.scope_flops[scope] = c.scope_flops.get(scope, 0.0) + flops
        if nbytes:
            c.scope_bytes[scope] = c.scope_bytes.get(scope, 0.0) + nbytes

    def _hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()

        def freed(_, key=key):
            entry = self._live.pop(key, None)
            if entry is not None:
                self._live_bytes -= entry[0]

        self._live[key] = (n, weakref.ref(st, freed))
        self._live_bytes += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live_bytes)

    def collective(self, op: str, nbytes: int, group: int) -> None:
        """A collective of ``distributed.mesh`` (its listener)."""
        from .analysis import wire_bytes

        kind = "broadcast" if op == "broadcast" else "all-reduce"
        w = wire_bytes(kind, nbytes, group)
        c = self.cost
        c.wire_bytes += w
        c.collective_bytes_by_op[kind] = c.collective_bytes_by_op.get(
            kind, 0.0) + w
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        from ..distributed import mesh as M

        self._prev = _ACTIVE
        _ACTIVE = self
        M.COLLECTIVES.listeners.append(self.collective)
        seen = set()
        for t in _tensors(self._arguments):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                self.cost.argument_bytes += t.untyped_storage().nbytes()
            self._hold(t)
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        from ..distributed import mesh as M

        _ACTIVE = self._prev
        M.COLLECTIVES.listeners.remove(self.collective)
        # Hold nothing past the run: the arguments, and the storages'
        # weak references (whose callbacks refer back to the counter).
        self._arguments = None
        self._live.clear()
        self._memo.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        sig = _signature(func, args, kwargs) if _fresh(func) else None
        if sig is not None and sig in self._memo:
            out = _remake(self._memo[sig])
        else:
            out = func(*args, **kwargs)
            if sig is not None and all(t.is_meta for t in _tensors(out)):
                self._memo[sig] = _layout(out)
        if self.muted or func.namespace in _COMM_NAMESPACES:
            return out
        self.cost.ops += 1
        flops = 0.0
        count = self._registry.get(func._overloadpacket)
        if count is not None:
            flops = float(count(*args, **kwargs, out_val=out))
        nbytes = 0
        if not func.is_view:
            nbytes = (sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
                      + sum(tensor_bytes(t) for t in _tensors(out)))
            for t in _tensors(out):
                self._hold(t)
        self._add(self._scope(), flops, nbytes)
        return out
