"""The execution-path registry: every solve driver behind one interface.
Port of ``repro.core.backend``.

* :class:`Backend`: ``prepare`` resolves the coupling tier and builds (or
  passes through) the stored operands, ``run`` is the monolithic solve,
  ``runner`` the chunk-granular driver the resilient supervisor
  (:mod:`repro_torch.core.resilience`) consumes.
* :class:`Capabilities`: what each path can serve.
* :data:`BACKENDS` and :func:`register`: the registry. ``solve``, the
  supervisor and the registry tests enumerate it.

The port registers the JAX package's seven paths: "reference" (the plain
PyTorch engine of ``core.mcmc``), "fused" (the sweep kernel over the
dense, ``bitplane`` and ``bitplane_hbm`` tiers), "colored" (the colored
sweep kernel), "tempering" (parallel tempering on the sweep kernel, a
``TemperingConfig``), and on a ``DeviceMesh`` (``needs_mesh``; SPMD, every
rank calls alike): "sharded" and "sharded_2d" (the row-sharded plane tiers
of ``distributed.solver_sharded``) and "distributed" (replica-parallel
``distributed.solver_dist``, a ``DistSolverConfig``).

Chunk-runner protocol (what ``runner()`` returns): ``init() -> state``,
``run_chunk(state, k) -> state``, ``unit_len(k)``, ``best_energy(state)
-> float``, ``trace_row(state)``, ``finalize(state, rows) -> result``, and
the attributes ``total_units``, ``collect_trace``, ``num_replicas``,
``backend``, ``fmt``. The state is a tuple of tensors on the runner's
device that round-trips through a snapshot losslessly, and every chunk's
random numbers are a pure function of (seed, chunk index), with no carried
RNG state: a fresh runner continues a restored state bitwise. The runners
are the monolithic solves' own loops (``ops.FusedRunner``,
``ops.ColoredRunner``, ``solver.ReferenceRunner``,
``tempering.TemperingRunner``; ``runner.drive()`` is the monolithic solve),
so a run chunk by chunk equals it bitwise.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Optional

from . import ising
from .coupling import (KERNEL_COUPLING_MODES, SHARDED_FORMATS, CouplingStore,
                       resolve_format)
from .solver import (ReferenceRunner, SolverConfig, _run,  # noqa: F401
                     require_dense)
from .tempering import TemperingConfig, TemperingRunner, solve_tempering
from ..kernels import ops
from ..kernels.ops import ColoredRunner, FusedRunner  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What an execution path can serve.

    ``edge_list``       dense-J-free (``EdgeList``) problems.
    ``needs_mesh``      runs on a ``DeviceMesh`` (sharded, distributed).
    ``supports_store``  accepts a prebuilt ``CouplingStore``.
    ``supports_resume`` drivable chunk by chunk with bitwise resume.
    ``tier_fallback``   rides the coupling-tier ladder (``coupling_format=
                        "auto"`` only).
    ``fixed_fmt``       the one tier the path serves, or None when the tier
                        follows ``config.coupling_format``.
    ``auto``            eligible for ``backend="auto"`` (the reference
                        engine is explicit-only).
    """
    edge_list: bool
    needs_mesh: bool
    supports_store: bool
    supports_resume: bool
    tier_fallback: bool
    fixed_fmt: Optional[str] = None
    auto: bool = True
    summary: str = ""


class Backend(abc.ABC):
    """One registered execution path. Stateless: every method takes the
    problem and config, so one instance serves every request."""

    name: str
    capabilities: Capabilities

    def config_cls(self) -> type:
        return SolverConfig

    def check_config(self, config) -> None:
        cls = self.config_cls()
        if not isinstance(config, cls):
            raise TypeError(
                f"backend {self.name!r} consumes {cls.__name__}, got "
                f"{type(config).__name__}")

    def matches_config(self, config) -> bool:
        """Whether ``backend="auto"`` may resolve to this path for
        ``config`` (``flip_mode`` splits ``SolverConfig`` between the
        single-flip and colored paths)."""
        return isinstance(config, self.config_cls())

    def prepare(self, problem: ising.IsingProblem, config, *, mesh=None,
                fmt: Optional[str] = None, store=None):
        """Resolve the tier and build the stored operands (``fmt`` is the
        tier ladder's override). None for a path with no separable store."""
        return None

    @abc.abstractmethod
    def run(self, problem: ising.IsingProblem, seed, config, *, mesh=None,
            store=None, device=None):
        """The monolithic solve."""

    @abc.abstractmethod
    def runner(self, problem: ising.IsingProblem, seed, config, *,
               mesh=None, chunk_steps: int = 256, fmt: Optional[str] = None,
               store=None, device=None):
        """The chunk-granular driver, bitwise equal to ``run`` under any
        chunk boundary (the plan of ``chunk_steps``)."""


BACKENDS: dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    """Add an execution path (the latest registration of a name wins, so a
    test can shadow one)."""
    BACKENDS[backend.name] = backend
    return backend


def backend_names() -> tuple:
    return tuple(sorted(BACKENDS))


def get_backend(name: str) -> Backend:
    if name in BACKENDS:
        return BACKENDS[name]
    raise ValueError(
        f"unknown backend {name!r}: registered backends are "
        f"{backend_names()}; 'auto' resolves one from the config type")


def resolve_backend(config, backend: str = "auto", mesh=None) -> str:
    """``backend="auto"``: the registered path whose config class and mode
    match ``config``, the one that runs on a mesh when ``mesh`` is given
    ("fused", or "sharded" with a mesh, for single-flip; "colored" for
    colored configs; "tempering" for a ``TemperingConfig``;
    "distributed" for a ``DistSolverConfig``). An explicit name is checked
    against the registry."""
    if backend != "auto":
        get_backend(backend)
        return backend
    cands = [b for _, b in sorted(BACKENDS.items())
             if b.capabilities.auto and b.matches_config(config)]
    if not cands:
        raise TypeError(f"unrecognized config type {type(config).__name__}")
    return min(cands, key=lambda b: b.capabilities.needs_mesh
               != (mesh is not None)).name


def current_fmt(problem: ising.IsingProblem, config, backend: str,
                fmt: Optional[str]) -> str:
    """The tier a run attempt uses: the ladder's override if one is active,
    the backend's fixed tier if it has one, else the resolved
    ``config.coupling_format``."""
    if fmt is not None:
        return fmt
    fixed = get_backend(backend).capabilities.fixed_fmt
    if fixed is not None:
        return fixed
    return resolve_format(getattr(config, "coupling_format", "auto"),
                          problem.coupling_source, problem.num_spins)


def fallback_enabled(config, backend: str) -> bool:
    """Whether the tier ladder applies: the backend opts in and the config
    left the tier on "auto"."""
    return (get_backend(backend).capabilities.tier_fallback
            and getattr(config, "coupling_format", None) == "auto")


def capability_rows() -> list:
    """(name, Capabilities) rows in name order."""
    return [(name, BACKENDS[name].capabilities) for name in backend_names()]


# --------------------------------------------------------------------------
# The registered execution paths. Their chunk runners are the loops of the
# monolithic solves themselves (``ops.FusedRunner``, ``ops.ColoredRunner``,
# ``solver.ReferenceRunner``): ``run`` drives one to the end, the
# supervisor chunk by chunk.

def _require_single_flip(config, name: str) -> None:
    """A colored config reaching a single-flip path directly (not through
    ``backend="auto"``) fails loudly, never runs single-flip sweeps."""
    if getattr(config, "flip_mode", "single") != "single":
        raise ValueError(
            f"backend {name!r} runs single-flip updates (flip_mode="
            f"{config.flip_mode!r}); colored block updates are served by "
            "backend='colored'")


def _resolve_store(problem, config, *, fmt=None, store=None, caller: str):
    """A prebuilt store passes through untouched unless the tier ladder's
    ``fmt`` forces a rebuild (the ladder must not bring back the tier that
    just failed to allocate); otherwise ``config.coupling_format`` is
    resolved and encoded once."""
    if store is None or fmt is not None:
        store = CouplingStore.build(problem.coupling_source,
                                    fmt or config.coupling_format)
    store.require(KERNEL_COUPLING_MODES, caller)
    return store


class ReferenceBackend(Backend):
    name = "reference"
    capabilities = Capabilities(
        edge_list=False, needs_mesh=False, supports_store=False,
        supports_resume=True, tier_fallback=False, fixed_fmt="dense",
        auto=False,
        summary="plain PyTorch one-flip-per-step oracle (core.mcmc), no "
                "kernel")

    def _check(self, problem, config, store) -> None:
        self.check_config(config)
        _require_single_flip(config, self.name)
        if store is not None:
            raise ValueError(
                "a prebuilt CouplingStore serves the fused backend only; "
                "backend='reference' always reads the dense J")
        require_dense(problem)

    def run(self, problem, seed, config, *, mesh=None, store=None,
            device=None):
        self._check(problem, config, store)
        return _run(problem, seed, config, device)

    def runner(self, problem, seed, config, *, mesh=None, chunk_steps=256,
               fmt=None, store=None, device=None):
        self._check(problem, config, store)
        return ReferenceRunner(problem, seed, config, chunk_steps, device)


class FusedBackend(Backend):
    name = "fused"
    capabilities = Capabilities(
        edge_list=True, needs_mesh=False, supports_store=True,
        supports_resume=True, tier_fallback=True, fixed_fmt=None,
        summary="the sweep kernel (csrc/sweep.cu) over the dense, bitplane "
                "and bitplane_hbm tiers")

    def matches_config(self, config) -> bool:
        return (isinstance(config, SolverConfig)
                and config.flip_mode == "single")

    def prepare(self, problem, config, *, mesh=None, fmt=None, store=None):
        return _resolve_store(problem, config, fmt=fmt, store=store,
                              caller=f"backend {self.name!r}")

    def run(self, problem, seed, config, *, mesh=None, store=None,
            device=None):
        self.check_config(config)
        return ops.fused_anneal(problem, seed, config, store=store,
                                device=device)

    def runner(self, problem, seed, config, *, mesh=None, chunk_steps=256,
               fmt=None, store=None, device=None):
        self.check_config(config)
        _require_single_flip(config, self.name)
        if fmt in SHARDED_FORMATS:
            # The ladder's last rung moves a fused solve onto the sharded
            # driver: the same trajectory, by contract.
            if mesh is None:
                raise ValueError(f"the {fmt} tier needs a mesh")
            target = ("sharded_2d" if fmt == "bitplane_sharded_2d"
                      else "sharded")
            return get_backend(target).runner(
                problem, seed, config, mesh=mesh, chunk_steps=chunk_steps,
                device=device)
        store = self.prepare(problem, config, fmt=fmt, store=store)
        return FusedRunner(problem, seed, config, chunk_steps=chunk_steps,
                           store=store, device=device)


class ColoredBackend(Backend):
    name = "colored"
    capabilities = Capabilities(
        edge_list=True, needs_mesh=False, supports_store=False,
        supports_resume=True, tier_fallback=True, fixed_fmt=None,
        summary="graph-colored block updates (csrc/colored_sweep.cu): one "
                "color class per step, O(N/χ) flips on sparse instances")

    def matches_config(self, config) -> bool:
        return (isinstance(config, SolverConfig)
                and config.flip_mode == "colored")

    def _check(self, config, store) -> None:
        if getattr(config, "flip_mode", None) != "colored":
            raise ValueError(
                f"backend 'colored' serves flip_mode='colored' configs, got "
                f"{getattr(config, 'flip_mode', None)!r}")
        if store is not None:
            # A prebuilt store is in the original spin order; the colored
            # path runs in color-sorted order.
            raise ValueError(
                "backend='colored' rebuilds its store in color-sorted spin "
                "order; a prebuilt CouplingStore (original order) cannot be "
                "reused — memoize the ops.colored_plan instead")

    def prepare(self, problem, config, *, mesh=None, fmt=None, store=None):
        self._check(config, store)
        return ops.colored_plan(problem, fmt if fmt is not None
                                else config.coupling_format)

    def run(self, problem, seed, config, *, mesh=None, store=None,
            device=None):
        self.check_config(config)
        self._check(config, store)
        return ops.colored_anneal(problem, seed, config, device=device)

    def runner(self, problem, seed, config, *, mesh=None, chunk_steps=256,
               fmt=None, store=None, device=None):
        self.check_config(config)
        if fmt in SHARDED_FORMATS:
            raise ValueError(
                "the colored path has no spin-sharded tier — the tier "
                "ladder ends at bitplane_hbm for backend='colored'")
        plan = self.prepare(problem, config, fmt=fmt, store=store)
        return ColoredRunner(problem, seed, config, chunk_steps=chunk_steps,
                             plan=plan, device=device)


class TemperingBackend(Backend):
    name = "tempering"
    capabilities = Capabilities(
        edge_list=True, needs_mesh=False, supports_store=True,
        supports_resume=True, tier_fallback=True, fixed_fmt=None,
        summary="fused parallel tempering (swap rounds over a temperature "
                "ladder) on the sweep kernel")

    def config_cls(self):
        return TemperingConfig

    def prepare(self, problem, config, *, mesh=None, fmt=None, store=None):
        return _resolve_store(problem, config, fmt=fmt, store=store,
                              caller=f"backend {self.name!r}")

    def run(self, problem, seed, config, *, mesh=None, store=None,
            device=None):
        self.check_config(config)
        return solve_tempering(problem, seed, config, store=store,
                               device=device)

    def runner(self, problem, seed, config, *, mesh=None, chunk_steps=256,
               fmt=None, store=None, device=None):
        self.check_config(config)
        store = self.prepare(problem, config, fmt=fmt, store=store)
        return TemperingRunner(problem, seed, config, store=store,
                               device=device)


def _require_mesh(mesh, what: str) -> None:
    if mesh is None:
        raise ValueError(f"{what} needs a mesh (a DeviceMesh; SPMD: every "
                         "rank calls alike)")


class ShardedBackend(Backend):
    name = "sharded"
    capabilities = Capabilities(
        edge_list=True, needs_mesh=True, supports_store=False,
        supports_resume=True, tier_fallback=False,
        fixed_fmt="bitplane_sharded",
        summary="spin-row-sharded planes over the mesh's ranks (capacity "
                "scales with their memory together); plain PyTorch step, "
                "inits on csrc/bitplane_field.cu")

    def matches_config(self, config) -> bool:
        return (isinstance(config, SolverConfig)
                and config.flip_mode == "single")

    def _check_mesh(self, mesh) -> None:
        _require_mesh(mesh, f"backend={self.name!r}")

    def prepare(self, problem, config, *, mesh=None, fmt=None, store=None):
        from ..distributed import solver_sharded as _ss
        self._check_mesh(mesh)
        return _ss.resolve_sharded_planes(problem, config, mesh)

    def run(self, problem, seed, config, *, mesh=None, store=None,
            device=None):
        from ..distributed import solver_sharded as _ss
        self.check_config(config)
        _require_single_flip(config, self.name)
        self._check_mesh(mesh)
        if store is not None:
            raise ValueError(
                f"backend={self.name!r} builds per-rank plane slabs from the "
                "problem; a prebuilt CouplingStore serves the fused backend "
                "only")
        return _ss.solve_sharded(problem, seed, config, mesh, device=device)

    def runner(self, problem, seed, config, *, mesh=None, chunk_steps=256,
               fmt=None, store=None, device=None):
        from ..distributed import solver_sharded as _ss
        self.check_config(config)
        _require_single_flip(config, self.name)
        self._check_mesh(mesh)
        return _ss.ShardedRunner(problem, seed, config, mesh,
                                 chunk_steps=chunk_steps, device=device,
                                 backend=self.name)


class Sharded2DBackend(ShardedBackend):
    """The (replica groups × spin rows) form of the sharded path: the same
    driver on a mesh of at least two dims. Not picked by "auto" (a
    ``SolverConfig`` with a mesh resolves to "sharded", whose driver takes
    such meshes too); name it, or let the tier ladder reach it."""

    name = "sharded_2d"
    capabilities = Capabilities(
        edge_list=True, needs_mesh=True, supports_store=False,
        supports_resume=True, tier_fallback=False,
        fixed_fmt="bitplane_sharded_2d", auto=False,
        summary="(groups, rows) mesh: planes row-sharded within each "
                "replica group, replicated across groups")

    def _check_mesh(self, mesh) -> None:
        _require_mesh(mesh, "backend='sharded_2d' (a (groups, rows) mesh)")
        if mesh.ndim < 2:
            raise ValueError(
                f"backend='sharded_2d' needs a mesh with >= 2 axes (leading "
                f"= replica groups, last = spin rows); got the 1-axis mesh "
                f"{tuple(mesh.mesh_dim_names)} — use backend='sharded' for "
                f"1-D row sharding")


class DistributedBackend(Backend):
    name = "distributed"
    capabilities = Capabilities(
        edge_list=True, needs_mesh=True, supports_store=False,
        supports_resume=True, tier_fallback=False, fixed_fmt=None,
        summary="replica-parallel solve with elitist exchange on the "
                "mesh's ranks (J whole on every rank; kernel A with a "
                "device fold per rank)")

    def config_cls(self):
        from ..distributed.solver_dist import DistSolverConfig
        return DistSolverConfig

    def run(self, problem, seed, config, *, mesh=None, store=None,
            device=None):
        from ..distributed.solver_dist import solve_distributed
        self.check_config(config)
        _require_mesh(mesh, "backend='distributed'")
        if store is not None:
            raise ValueError(
                "backend='distributed' builds its store on every rank; a "
                "prebuilt CouplingStore serves the fused backend only")
        return solve_distributed(problem, seed, config, mesh, device=device)

    def runner(self, problem, seed, config, *, mesh=None, chunk_steps=256,
               fmt=None, store=None, device=None):
        from ..distributed.solver_dist import DistRunner
        self.check_config(config)
        _require_mesh(mesh, "backend='distributed'")
        return DistRunner(problem, seed, config, mesh, device=device)


register(ReferenceBackend())
register(FusedBackend())
register(ColoredBackend())
register(TemperingBackend())
register(ShardedBackend())
register(Sharded2DBackend())
register(DistributedBackend())
