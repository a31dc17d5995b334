"""Coupling-store subsystem: every J tier behind one descriptor. Port of
``repro.core.coupling``.

Tiers of the fused sweep, and what each is on one H100:

* ``dense``        — J as an (N, N) f32 tensor in device memory.
* ``bitplane``     — packed signed bit-planes (2·B bits per coupler instead
                     of 32) in device memory, W = ceil(N/32) words per row.
* ``bitplane_hbm`` — the same planes with W padded to
                     :data:`STREAM_ALIGN_WORDS`; the sweep counts each step's
                     unique rows per replica group (``coalesce``).
* ``bitplane_sharded`` / ``bitplane_sharded_2d`` — the planes row-sharded
  over the ranks of a mesh (within each replica group of a 2-D mesh),
  served by :mod:`repro_torch.distributed.solver_sharded`, never by the
  single-device sweep; "auto" never resolves to them.

On the TPU the tiers are VMEM budgets (``DENSE_COUPLING_MAX_N = 2000``,
``BITPLANE_VMEM_MAX_N = 8000``). On the H100 the store lives in global
memory on every tier, so "auto" weighs what each tier costs a user: its
build (a dense J is used where it lies; planes are encoded on the host,
1.30 s at N=4096 and 97 s at N=32768) and its steps. The thresholds are
readings on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit, taken by
``scripts/tier_crossover.py`` (N from 4,096 to 32,768; the dense J of
``complete_bipolar(N, seed=N)`` and ``sparse_bipolar_edges(N, 8·N,
seed=N)``; RSA and RWA, R = 8), under one rule. A tier costs its build
seconds plus 20,000 × its µs/step (a 4,096-step solve, host clock); a lower
tier wins at N where it costs no more than the tiers above it; a mode's
crossover is the largest N read at which the lower tier wins, as it does at
every N read below it; a threshold is the smaller of the RSA and RWA
crossovers:

* dense against the cheaper plane tier, on the dense J: dense won at every
  N read in both modes (where 20,000 plane steps save anything, the encode
  costs 66 times what they save or more), so :data:`DENSE_COUPLING_MAX_N`
  is the largest N read, 32,768, within :data:`DENSE_MEMORY_MAX_N` (a dense
  f32 J in a sixteenth of device memory); past it "auto" packs an integral
  J;
* ``bitplane`` against ``bitplane_hbm`` wherever "auto" can pick a plane
  tier (every edge list; a dense J past 32,768): both hold the same planes
  and tie within the readings' noise (``bitplane_hbm``'s kernel is 0.03–9.5 %
  slower at every N; its solves' medians run from 4.4 % faster to 18 %
  slower, and the builds differ by milliseconds). The first reading that
  went ``bitplane_hbm``'s way, RWA on the edge list at N = 8,192, puts
  :data:`BITPLANE_L2_MAX_N` at 6,144.

Every tier is also capped by the port's ceiling, N ≤ 154,965
(:data:`SWEEP_STATE_MAX_N`): the state that the earlier single-flip sweep
(``sweep.cu``) split over the at most 8 blocks of a thread-block cluster
(u, s and best_s, 12·N bytes, in 232,448 bytes a block). The sweeps that
run the solves now split N over up to 16 blocks
(``kernels/csrc/sweep_rsa.cu`` and ``sweep_rwa.cu``) and both take every N
up to the ceiling (the sweep wrapper checks the exact budget of each mode
and width, ``kernels.sweep.widths`` and ``max_n``).
Past it every tier raises.

``CouplingStore.build`` is the single host-side resolve → encode entry point;
an :class:`~repro_torch.core.ising.EdgeList` packs straight into planes in
O(nnz) and never resolves to dense.
"""
from __future__ import annotations

import dataclasses
import math
import time
import tracemalloc
from typing import Optional, Sequence

import numpy as np
import torch

from .bitplane import WORD_BITS, BitPlanes, encode_couplings, encode_edges
from .ising import EdgeList

#: Device memory of one H100 80GB, as its specification gives it.
DEVICE_MEMORY_BYTES = 80 * 10 ** 9

#: "auto" keeps a dense f32 J within a sixteenth of device memory (5 GB).
DENSE_MEMORY_BYTES = DEVICE_MEMORY_BYTES // 16

#: The largest N whose dense f32 J (4·N² bytes) fits that share: 35,355.
DENSE_MEMORY_MAX_N = math.isqrt(DENSE_MEMORY_BYTES // 4)

#: "auto" keeps an integral dense J dense up to here: the largest N read on
#: the card, where dense still won in both modes (``scripts/tier_crossover.py``).
DENSE_COUPLING_MAX_N = 32_768

#: "auto" serves planes on the ``bitplane`` tier up to here and on
#: ``bitplane_hbm`` past it: the readings' crossover (the tiers tie within
#: noise; see the module docstring).
BITPLANE_L2_MAX_N = 6_144

#: Dynamic shared memory one block may use on Hopper.
SHARED_MEMORY_BYTES = 232_448

#: Blocks of the thread-block cluster that held one replica of the earlier
#: sweep, ``kernels/csrc/sweep.cu`` (the portable cluster size), which runs
#: only when forced for timing. RSA runs on ``sweep_rsa.cu`` and RWA on
#: ``sweep_rwa.cu``, whose clusters take up to 16 blocks (the non-portable
#: size, ``kernels.sweep.RSA_CLUSTERS`` and ``RWA_CLUSTERS``).
SWEEP_MAX_BLOCKS = 8

#: The port's ceiling, on every tier: the earlier sweep split u, s and best_s
#: (3·N f32) of one replica over the shared memory of at most
#: :data:`SWEEP_MAX_BLOCKS` blocks. The port serves no N past it; the RSA
#: and RWA sweeps take every N up to it (alone they would take ~258k and
#: 262,144).
SWEEP_STATE_MAX_N = SWEEP_MAX_BLOCKS * SHARED_MEMORY_BYTES // 12

#: Word-axis alignment of the streamed tier's planes (the JAX package's 128-
#: word lane tile; zero bits, which decoders truncate).
STREAM_ALIGN_WORDS = 128

#: Bits per coupler of dense f32; a plane store costs 2·B.
DENSE_COUPLING_BITS = 32

_SHARED_MEMORY_CEILING = (
    "the single-flip sweeps hold one replica's state in the shared memory "
    "of one thread-block cluster, and the port keeps the ceiling of its "
    f"first split over {SWEEP_MAX_BLOCKS} blocks")


@dataclasses.dataclass(frozen=True)
class CouplingFormatSpec:
    """Registry row for one resolved coupling format."""

    name: str
    packed: bool        #: consumes a packed ``BitPlanes`` (vs a dense J)
    align_words: int    #: word-axis padding the encoder applies
    kernel_mode: bool   #: served by the single-device sweep kernel
    coalescable: bool   #: rows_fetched counts unique rows per replica group
    summary: str


#: The format registry, in the JAX package's order.
FORMATS: dict[str, CouplingFormatSpec] = {spec.name: spec for spec in (
    CouplingFormatSpec("dense", False, 1, True, False,
                       "(N, N) f32 J in device memory"),
    CouplingFormatSpec("bitplane", True, 1, True, False,
                       "packed signed bit-planes in device memory"),
    CouplingFormatSpec("bitplane_hbm", True, STREAM_ALIGN_WORDS, True, True,
                       "planes with 128-word rows, unique rows counted"),
    CouplingFormatSpec("bitplane_sharded", True, STREAM_ALIGN_WORDS, False,
                       True, "planes row-sharded across GPUs"),
    CouplingFormatSpec("bitplane_sharded_2d", True, STREAM_ALIGN_WORDS,
                       False, True,
                       "planes row-sharded within each replica group"),
)}

COUPLING_FORMATS = ("auto",) + tuple(FORMATS)
PLANE_FORMATS = tuple(s.name for s in FORMATS.values() if s.packed)
KERNEL_COUPLING_MODES = tuple(
    s.name for s in FORMATS.values() if s.kernel_mode)
KERNEL_PLANE_MODES = tuple(
    s.name for s in FORMATS.values() if s.packed and s.kernel_mode)
COALESCABLE_FORMATS = tuple(s.name for s in FORMATS.values() if s.coalescable)


SHARDED_FORMATS = tuple(s.name for s in FORMATS.values()
                        if not s.kernel_mode)


def _check_served(fmt: str, n: int) -> str:
    """``fmt`` if N fits it: the single-device tiers stop at the sweep's
    shared-memory ceiling; the sharded tiers keep their state in global
    memory and have none."""
    if fmt in SHARDED_FORMATS:
        return fmt
    if n > SWEEP_STATE_MAX_N:
        raise ValueError(
            f"N={n} is past the port's ceiling of {SWEEP_STATE_MAX_N} spins "
            f"on every tier: {_SHARED_MEMORY_CEILING}")
    return fmt


def _integral(J) -> bool:
    if isinstance(J, torch.Tensor):
        return bool(torch.equal(J, torch.round(J)))
    J = np.asarray(J)
    return bool(np.array_equal(J, np.rint(J)))


def _max_abs(J) -> int:
    if isinstance(J, torch.Tensor):
        return int(J.abs().max()) if J.numel() else 0
    return int(np.abs(np.asarray(J)).max(initial=0))


def resolve_format(fmt: Optional[str], couplings, n: int) -> str:
    """Resolve the ``coupling_format`` knob to a served format name.

    "auto" (or None) on a dense J picks a plane tier exactly when J is
    integral, N is past :data:`DENSE_COUPLING_MAX_N` and the planes are
    smaller (2·B < 32 bits), and streams past :data:`BITPLANE_L2_MAX_N`. An
    :class:`EdgeList` never resolves to dense: "auto" picks a plane tier and
    an explicit "dense" raises. "auto" never resolves to a sharded tier
    (they need a mesh: only their driver or an explicit knob picks them).
    A single-device tier raises for any N past the sweep's shared-memory
    ceiling.
    """
    if fmt not in (None, "auto") and fmt not in FORMATS:
        raise ValueError(
            f"coupling format must be one of {COUPLING_FORMATS}, got {fmt!r}")
    plane_tier = "bitplane" if n <= BITPLANE_L2_MAX_N else "bitplane_hbm"
    if isinstance(couplings, EdgeList):
        if fmt in (None, "auto"):
            return _check_served(plane_tier, n)
        if not FORMATS[fmt].packed:
            raise ValueError(
                "edge-list couplings are dense-J-free: coupling_format="
                f"{fmt!r} would materialize the (N, N) f32 matrix — use a "
                f"plane format ({PLANE_FORMATS}) or edges.to_dense() "
                "explicitly for small N")
        return _check_served(fmt, n)
    if fmt not in (None, "auto"):
        return _check_served(fmt, n)
    if n <= DENSE_COUPLING_MAX_N or not _integral(couplings):
        return _check_served("dense", n)
    num_planes = max(1, _max_abs(couplings).bit_length())
    if 2 * num_planes >= DENSE_COUPLING_BITS:
        return _check_served("dense", n)
    return _check_served(plane_tier, n)


def encode_planes(couplings, num_planes: Optional[int] = None,
                  fmt: str = "bitplane") -> BitPlanes:
    """Pack a concrete integral J (dense matrix or edge list) for a plane
    tier, on the host. ``num_planes`` defaults to the fewest planes that
    represent |J|max; W is padded to the tier's alignment."""
    if isinstance(couplings, EdgeList):
        return encode_edges(couplings, num_planes,
                            align_words=FORMATS[fmt].align_words)
    if isinstance(couplings, torch.Tensor):
        couplings = couplings.detach().cpu().numpy()
    J = np.asarray(couplings)
    if num_planes is None:
        amax = int(np.abs(np.rint(J)).max(initial=0))
        num_planes = max(1, amax.bit_length())
    return encode_couplings(J, num_planes,
                            align_words=FORMATS[fmt].align_words)


def validate_planes_cover(planes: BitPlanes, n: int) -> None:
    """Shape contract of every plane consumer."""
    if planes.num_spins != n:
        raise ValueError(f"BitPlanes N={planes.num_spins} != state N={n}")
    if planes.num_words * WORD_BITS < n:
        raise ValueError(f"BitPlanes W={planes.num_words} words cannot "
                         f"cover N={n} couplers")


def validate_kernel_operand(coupling: str, couplings, n: int,
                            gather: str = "dynamic") -> None:
    """What ``kernels.sweep.mcmc_sweep`` may be fed for each store mode."""
    if coupling not in KERNEL_COUPLING_MODES:
        raise ValueError(
            f"coupling must be one of {KERNEL_COUPLING_MODES}, got {coupling!r}")
    if coupling in KERNEL_PLANE_MODES:
        if not isinstance(couplings, BitPlanes):
            raise TypeError(f"coupling={coupling!r} needs a BitPlanes "
                            f"couplings argument, got {type(couplings).__name__}")
        validate_planes_cover(couplings, n)
        if gather == "onehot":
            raise ValueError("gather='onehot' requires a dense J (the one-hot "
                             "contraction cannot consume packed planes)")
    elif tuple(couplings.shape) != (n, n):
        raise ValueError(f"dense couplings have shape {tuple(couplings.shape)}"
                         f", expected {(n, n)}")


@dataclasses.dataclass(frozen=True)
class CouplingStore:
    """One J tier as a value: the resolved format and its payload."""

    fmt: str
    num_spins: int
    dense: Optional[torch.Tensor] = None
    planes: Optional[BitPlanes] = None

    @classmethod
    def build(cls, couplings, fmt: Optional[str] = "auto", *,
              num_planes: Optional[int] = None) -> "CouplingStore":
        """Resolve ``fmt`` for ``couplings`` (a dense J or an
        :class:`EdgeList`) and encode on the host. Planes are built on the
        CPU; :meth:`to` moves the store."""
        if isinstance(couplings, EdgeList):
            n = couplings.num_spins
        else:
            n = int(couplings.shape[-1])
        resolved = resolve_format(fmt, couplings, n)
        if FORMATS[resolved].packed:
            return cls(fmt=resolved, num_spins=n,
                       planes=encode_planes(couplings, num_planes, resolved))
        return cls(fmt=resolved, num_spins=n, dense=couplings)

    @classmethod
    def from_planes(cls, planes: BitPlanes,
                    fmt: str = "bitplane") -> "CouplingStore":
        """Wrap pre-packed planes (skips the re-encode)."""
        if not FORMATS[fmt].packed:
            raise ValueError(f"from_planes needs a plane format, got {fmt!r}")
        return cls(fmt=fmt, num_spins=planes.num_spins, planes=planes)

    @property
    def spec(self) -> CouplingFormatSpec:
        return FORMATS[self.fmt]

    @property
    def kernel_operand(self):
        """What the sweep consumes: the packed planes or the dense J."""
        return self.planes if self.spec.packed else self.dense

    @property
    def nbytes(self) -> int:
        if self.spec.packed:
            return self.planes.nbytes
        return int(self.dense.numel()) * int(self.dense.element_size())

    def plane_bytes_per_shard(self, num_shards: int) -> int:
        """Plane bytes of one rank when the rows are sharded over
        ``num_shards`` ranks (the sharded tier's memory accounting)."""
        if not self.spec.packed:
            raise ValueError(f"{self.fmt!r} store has no planes to shard")
        if self.num_spins % num_shards:
            raise ValueError(f"N={self.num_spins} rows cannot shard evenly "
                             f"over {num_shards} devices")
        return self.planes.nbytes // num_shards

    def plane_bytes_per_device(self, mesh_shape: Sequence[int]) -> int:
        """Plane bytes of one rank of a ``(groups..., rows)`` mesh shape:
        the rows shard over the last dim only and the planes are
        replicated across the replica groups."""
        return self.plane_bytes_per_shard(int(tuple(mesh_shape)[-1]))

    def to(self, device) -> "CouplingStore":
        if self.spec.packed:
            return dataclasses.replace(self, planes=self.planes.to(device))
        return dataclasses.replace(self, dense=self.dense.to(device))

    def require_num_spins(self, n: int, driver: str) -> "CouplingStore":
        """A prebuilt store must match the problem it is reused against."""
        if self.num_spins != n:
            raise ValueError(f"prebuilt CouplingStore is for N="
                             f"{self.num_spins} but {driver} got a problem "
                             f"with N={n}")
        return self

    def require(self, supported: Sequence[str], driver: str) -> "CouplingStore":
        """Raise if this store's tier is served by another path."""
        if self.fmt not in tuple(supported):
            hint = (" — the row-sharded store is served by the spin-parallel "
                    "driver repro_torch.distributed.solver_sharded."
                    "solve_sharded" if self.fmt in SHARDED_FORMATS else "")
            raise ValueError(
                f"coupling_format={self.fmt!r} is not supported by {driver} "
                f"(supported: {tuple(supported)}){hint}")
        return self


def measure_host_build(thunk):
    """Run a host-side build step under wall-clock and tracemalloc peak
    accounting. Returns ``(result, {"seconds", "peak_bytes"})``;
    ``peak_bytes`` is the peak additional traced host allocation (Python and
    numpy; tensors made from numpy without a copy are counted there)."""
    was_tracing = tracemalloc.is_tracing()
    if not was_tracing:
        tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        t0 = time.perf_counter()
        result = thunk()
        seconds = time.perf_counter() - t0
        _, peak = tracemalloc.get_traced_memory()
    finally:
        if not was_tracing:
            tracemalloc.stop()
    return result, {"seconds": seconds, "peak_bytes": int(max(peak - base, 0))}


def timed_build(couplings, fmt: Optional[str] = "auto", *,
                num_planes: Optional[int] = None):
    """:meth:`CouplingStore.build` under :func:`measure_host_build`."""
    return measure_host_build(
        lambda: CouplingStore.build(couplings, fmt, num_planes=num_planes))
