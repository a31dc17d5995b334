"""Spin-parallel Snowball: the ``bitplane_sharded`` and
``bitplane_sharded_2d`` coupling tiers. Port of
``repro.distributed.solver_sharded``.

Where ``solver_dist`` shards replicas, this driver shards the problem: the
rank at index d of the rows dim holds plane rows [d·N/D, (d+1)·N/D) and
the same slice of every replica's u and s, so the store's capacity is the
ranks' memory together while every replica still runs one global chain.
Every rank calls the same entry point with the same arguments (SPMD) and
gets the whole ``SolveResult``, put together on every rank.

One step for R replicas (``ref.mcmc_sweep`` statement for statement, each
global read replaced by its collective):

* **selection**: RSA reads u and s at the drawn site from their owner, one
  zero-padded sum of both (:func:`_psum_gather`). RWA sums each rank's
  roulette blocks (N/D/lane per replica), puts the (R, N/lane) block sums
  together with one zero-padded sum, runs ``common.roulette_block_pick``
  on every rank, and takes the winning block's lanes from its owner with
  a second (:func:`_sharded_roulette`); one more reads dE, s (and the
  fallback's p) at the chosen sites. The picks are ``kernels.common``'s,
  on the values the single-device tiers give them, so the trajectory is
  theirs bit for bit.
* **flip update**: the owner of each selected row broadcasts its packed
  (2B, W) pos∥neg words, one broadcast per unique row of the step
  (``common.coalesce_rows``; ``coalesce=False`` broadcasts one row per
  replica), and every rank decodes the words of its own columns and
  updates its slice of u. ``rows_fetched`` counts the broadcasts per
  replica as the JAX package does. The step's unique sites are read to
  the host to issue the broadcasts.

The solve never forms a dense J or the full planes on one rank: each rank
encodes its own (B, N/D, W) slab (from the edge list in O(nnz), or from
the rows of a dense J), its replicas' u₀ come from **kernel C** on that
slab, and e₀ from ``ising.energy_from_fields`` on the u^(J) put together
over the rows. The sweep itself is plain PyTorch on the card (the JAX
package's is jnp inside ``shard_map``, not Pallas).

**2-D meshes**: the last dim row-shards the planes as above and the
leading dims are replica groups. Each group runs the contiguous block of
R/G replicas at their global indices (their keys, their columns of the
full (T, R, 4) uniforms), and every collective of a step is on the rows
dim's group: no traffic between groups until the result is put together.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import coupling as coupling_store
from ..core import ising, rng
from ..core.bitplane import (WORD_BITS, BitPlanes, edge_plane_words,
                             encode_couplings)
from ..core.solver import ChunkRunner, SolverConfig, SolveResult
from ..device import resolve_device
from ..kernels import common, ops, sweep
from . import mesh as M


def nearest_row_shard_counts(n: int, near: int, limit: int = 3):
    """The row-shard counts d closest to ``near`` that split N evenly into
    lane-aligned shards (``N % d == 0 and (N // d) % default_lane(N) ==
    0``)."""
    lane = common.default_lane(n)
    valid = [d for d in range(1, max(n // lane, 1) + 1)
             if n % d == 0 and (n // d) % lane == 0]
    return tuple(sorted(valid, key=lambda d: (abs(d - near), d))[:limit])


def _check_row_shardable(n: int, mesh) -> int:
    """N rows must split evenly and lane-aligned over the row dim; returns
    the row-shard count. The error names N, the mesh and the nearest valid
    row-shard counts."""
    grp_dims, row_dims = M.mesh_axes_split(mesh)
    num_rows = M.mesh_size(mesh, row_dims)
    lane = common.default_lane(n)
    where = (f"row axis {row_dims[0]!r}" if grp_dims else "mesh")
    desc = M.mesh_desc(mesh)
    if n % num_rows:
        raise ValueError(
            f"N={n} spin rows cannot shard evenly over the {num_rows} "
            f"shard(s) of the {where} of mesh {desc} "
            f"(N % {num_rows} == {n % num_rows}); nearest valid row-shard "
            f"counts for N={n}: {nearest_row_shard_counts(n, num_rows)}")
    if (n // num_rows) % lane:
        raise ValueError(
            f"per-shard spin count {n // num_rows} is not a multiple of the "
            f"roulette lane {lane} (N={n} over the {num_rows} shard(s) of "
            f"the {where} of mesh {desc}): shard boundaries "
            f"must align with selection blocks; nearest valid row-shard "
            f"counts for N={n}: {nearest_row_shard_counts(n, num_rows)}")
    return num_rows


def _check_group_replicas(config: SolverConfig, mesh) -> int:
    """The replica count must split evenly over the replica groups; returns
    the group count (1 on a 1-D mesh)."""
    grp_dims, _ = M.mesh_axes_split(mesh)
    num_groups = M.mesh_size(mesh, grp_dims)
    r = config.num_replicas
    if r % num_groups:
        valid = tuple(g for g in range(1, r + 1) if r % g == 0)
        raise ValueError(
            f"num_replicas={r} cannot split evenly over the {num_groups} "
            f"replica group(s) of mesh {M.mesh_desc(mesh)} (group axes "
            f"{grp_dims}); use a replica count divisible by {num_groups} "
            f"or a group count in {valid}")
    return num_groups


class Layout:
    """The (groups × rows) decomposition one (config, mesh, N) fixes, seen
    from this rank: ``r_loc`` replicas from global index ``r0``, spins
    [lo, lo + n_loc), roulette blocks from ``g0``."""

    def __init__(self, config: SolverConfig, mesh, n: int):
        self.mesh = mesh
        self.grp_dims, row_dims = M.mesh_axes_split(mesh)
        self.row_dim = row_dims[0]
        self.n = n
        self.r = config.num_replicas
        self.r_loc = self.r // M.mesh_size(mesh, self.grp_dims)
        self.n_loc = n // M.dim_size(mesh, self.row_dim)
        self.lane = common.default_lane(n)
        self.row_idx = mesh.get_local_rank(self.row_dim)
        self.r0 = M.flat_shard_index(mesh, self.grp_dims) * self.r_loc
        self.lo = self.row_idx * self.n_loc
        self.g0 = self.lo // self.lane

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.lo + self.n_loc)

    @property
    def replicas(self) -> slice:
        return slice(self.r0, self.r0 + self.r_loc)

    def row_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks of this rank's rows group."""
        return M.all_reduce(x, self.mesh, (self.row_dim,))

    def over_rows(self, block: torch.Tensor) -> torch.Tensor:
        """(R_loc, N) from this rank's (R_loc, N/D) columns."""
        return M.assemble(block, (block.shape[0], self.n),
                          (slice(None), self.rows), self.mesh,
                          (self.row_dim,))

    def replica_vector(self, x: torch.Tensor) -> torch.Tensor:
        """(R,) from this group's (R_loc,) block."""
        return M.assemble(x, (self.r,), (self.replicas,), self.mesh,
                          self.grp_dims)

    def replica_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(R, N) from this rank's (R_loc, N/D) block."""
        return M.assemble(x, (self.r, self.n), (self.replicas, self.rows),
                          self.mesh, self.grp_dims + (self.row_dim,))


def _psum_gather(xs, js, layout: Layout) -> torch.Tensor:
    """(K, R): ``xs[k][r, js[k][r]]`` with each (R, N/D) ``xs[k]`` sharded
    over the spins, in one zero-padded sum: the owner gives the value,
    every other rank zeros."""
    lo, n_loc = layout.lo, layout.n_loc
    vals = []
    for x, j in zip(xs, js):
        jl = torch.clamp(j - lo, 0, n_loc - 1)
        v = x.gather(1, jl[:, None])[:, 0]
        own = (j >= lo) & (j < lo + n_loc)
        vals.append(torch.where(own, v, torch.zeros_like(v)))
    out = torch.stack(vals)
    layout.row_sum(out.view(torch.int32))
    return out


def _sharded_roulette(p_loc: torch.Tensor, u_roulette: torch.Tensor,
                      layout: Layout):
    """``common.roulette_pick`` with the (R, N) wheel sharded over the
    spins: the local (R, N/D/lane) block sums put together into (R,
    N/lane), ``common.roulette_block_pick`` on every rank, then the chosen
    block's lanes from its owner into ``common.roulette_lane_pick``."""
    lane, g0 = layout.lane, layout.g0
    r_, n_loc = p_loc.shape
    g_loc = n_loc // lane
    pb = p_loc.reshape(r_, g_loc, lane)
    blk = M.assemble(pb.sum(dim=2), (r_, layout.n // lane),
                     (slice(None), slice(g0, g0 + g_loc)), layout.mesh,
                     (layout.row_dim,))
    g, residual, total, degenerate = common.roulette_block_pick(
        blk, u_roulette)
    gl = torch.clamp(g - g0, 0, g_loc - 1)
    own = (g >= g0) & (g < g0 + g_loc)
    sel = pb[torch.arange(r_, device=p_loc.device), gl]
    sel = torch.where(own[:, None], sel, torch.zeros_like(sel))
    layout.row_sum(sel.view(torch.int32))
    lp = common.roulette_lane_pick(sel, residual, lane)
    return g * lane + lp, total, degenerate


def _fetch_rows(planes_loc: BitPlanes, sites: list,
                layout: Layout) -> torch.Tensor:
    """(M, N/D): the decoded columns of this rank of plane rows ``sites``
    (host ints), each broadcast as its (2B, W) pos∥neg words from its
    owner."""
    pos, neg = planes_loc.pos, planes_loc.neg
    num_planes, _, num_words = pos.shape
    n_loc, lo = layout.n_loc, layout.lo
    tiles = []
    for site in sites:
        owner = site // n_loc
        if owner == layout.row_idx:
            t = torch.cat([pos[:, site - lo], neg[:, site - lo]])
        else:
            t = pos.new_empty((2 * num_planes, num_words))
        tiles.append(M.broadcast(t, layout.mesh, layout.row_dim, owner))
    tiles = torch.stack(tiles).transpose(0, 1)       # (2B, M, W)
    pr, nr = tiles[:num_planes], tiles[num_planes:]
    if n_loc % WORD_BITS == 0:
        # Bits expand word by word: slicing the words first decodes only
        # this rank's columns, with the same values.
        w = slice(lo // WORD_BITS, (lo + n_loc) // WORD_BITS)
        return common.decode_bitplane_rows(pr[..., w], nr[..., w], n_loc)
    return common.decode_bitplane_rows(pr, nr, layout.n)[:, layout.rows]


def sharded_sweep(planes_loc: BitPlanes, fields0: torch.Tensor,
                  spins0: torch.Tensor, energy0: torch.Tensor,
                  uniforms: torch.Tensor, temps: torch.Tensor,
                  pwl_table: Optional[torch.Tensor], layout: Layout, *,
                  mode: str, uniformized: bool, coalesce: bool = True):
    """T spin-sharded steps for this rank's R_loc replicas: fields0 and
    spins0 are the (R_loc, N/D) slices, energy0 (R_loc,), uniforms (T,
    R_loc, 4) and temps (T, R_loc) the group's block of the full tensors.
    Returns the local analogue of the sweep's 7-tuple, its last element the
    (R_loc,) row broadcasts charged to each replica."""
    n, n_loc, lo = layout.n, layout.n_loc, layout.lo
    r = fields0.shape[0]
    dev = fields0.device
    u = fields0.to(torch.float32)
    s = spins0.clone()
    e = energy0.to(torch.float32)
    be, bs = e.clone(), spins0.clone()
    nf = torch.zeros(r, dtype=torch.int32, device=dev)
    rf = torch.zeros(r, dtype=torch.int32, device=dev)
    for t in range(uniforms.shape[0]):
        u01, temp = uniforms[t], temps[t]
        sf = s.to(torch.float32)
        if mode == "rsa":
            j = common.site_from_uniform(u01[:, 0], n)
            u_j, s_old = _psum_gather((u, sf), (j, j), layout)
            de = 2.0 * s_old * u_j
            accept = u01[:, 1] < common.flip_probability(de, temp, pwl_table)
        else:
            de_all = 2.0 * sf * u
            p_all = common.flip_probability(de_all, temp[:, None], pwl_table)
            j_rw, total, degenerate = _sharded_roulette(p_all, u01[:, 2],
                                                        layout)
            if uniformized:
                accept = ~degenerate & (u01[:, 3] * float(n) < total)
                j = j_rw
                de, s_old = _psum_gather((de_all, sf), (j, j), layout)
            else:
                j_fb = common.site_from_uniform(u01[:, 0], n)
                j = torch.where(degenerate, j_fb, j_rw)
                p_fb, de, s_old = _psum_gather((p_all, de_all, sf),
                                               (j_fb, j, j), layout)
                accept = torch.where(degenerate, u01[:, 1] < p_fb,
                                     torch.ones_like(degenerate))
        acc_f = accept.to(torch.float32)
        if coalesce:
            nu, usite, uo, fetched = common.coalesce_rows(j)
            host = torch.cat([nu[None], usite]).tolist()
            rows = _fetch_rows(planes_loc, host[1:1 + host[0]],
                               layout)[uo.to(torch.int64)]
        else:
            rows = _fetch_rows(planes_loc, j.tolist(), layout)
            fetched = torch.ones(r, dtype=torch.int32, device=dev)
        u = u - (2.0 * acc_f * s_old)[:, None] * rows
        rf = rf + fetched
        jl = torch.clamp(j - lo, 0, n_loc - 1)[:, None]
        flip = (accept & (j >= lo) & (j < lo + n_loc))[:, None]
        cur = s.gather(1, jl)
        s = s.scatter(1, jl, torch.where(flip, -cur, cur))
        e = e + acc_f * de
        nf = nf + accept.to(torch.int32)
        better = e < be
        be = torch.where(better, e, be)
        bs = torch.where(better[:, None], s, bs)
    return u, s, e, be, bs, nf, rf


def sharded_init(planes_loc: BitPlanes, fields: torch.Tensor,
                 base: torch.Tensor, layout: Layout):
    """The replica init of ``ops.fused_init_state`` without the full
    planes: the R_loc replicas' keys (``Salt.REPLICA`` at their global
    indices, then ``Salt.INIT``) and spins on every rank, u^(J) from
    **kernel C** on this rank's (B, N/D, W) slab, e₀ from
    ``ising.energy_from_fields`` on the u^(J) put together over the rows.
    Returns ``(u0, s0, e0)``: (R_loc, N/D), (R_loc, N/D), (R_loc,)."""
    idx = torch.arange(layout.r0, layout.r0 + layout.r_loc)
    keys = rng.stream(rng.stream(base.cpu(), rng.Salt.REPLICA, idx),
                      rng.Salt.INIT)
    spins0 = ising.random_spins(keys.to(fields.device),
                                (layout.n,)).to(torch.float32)
    u_j_loc = ops.plane_local_fields(planes_loc, spins0)
    u0 = u_j_loc + fields[layout.rows][None, :]
    e0 = ising.energy_from_fields(layout.over_rows(u_j_loc), spins0, fields)
    return u0, spins0[:, layout.rows].contiguous(), e0


def shard_planes_from_edges(edges: ising.EdgeList, mesh,
                            num_planes: Optional[int] = None,
                            device=None) -> BitPlanes:
    """This rank's (B, N/D, W) plane slab, encoded straight from the O(nnz)
    edge arrays (``bitplane.edge_plane_words`` with its row range): no rank
    forms the full planes or a dense J. On a 2-D mesh the slab is the row
    range of this rank's index along the rows dim (the groups each hold the
    same slabs)."""
    n = edges.num_spins
    num_rows = _check_row_shardable(n, mesh)
    _, row_dims = M.mesh_axes_split(mesh)
    if num_planes is None:
        num_planes = max(1, edges.max_abs_weight.bit_length())
    n_loc = n // num_rows
    lo = mesh.get_local_rank(row_dims[0]) * n_loc
    align = coupling_store.FORMATS["bitplane_sharded"].align_words
    pos, neg = edge_plane_words(edges, num_planes, align_words=align,
                                row_range=(lo, lo + n_loc))
    return BitPlanes.from_numpy(pos, neg, n, device=device)


def resolve_sharded_planes(problem: ising.IsingProblem, config: SolverConfig,
                           mesh, *, coupling: Optional[BitPlanes] = None,
                           num_planes: Optional[int] = None,
                           device=None) -> BitPlanes:
    """Check a (problem, config, mesh) for the sharded tier and return this
    rank's plane slab on ``device``: the rows of pre-packed ``coupling``
    planes, a slab encoded from an edge list, or one encoded from the rows
    of a dense integer J. Raises the driver's routing and alignment
    errors."""
    n = problem.num_spins
    grp_dims, _ = M.mesh_axes_split(mesh)
    fmt = "bitplane_sharded_2d" if grp_dims else "bitplane_sharded"
    if config.coupling_format not in ("auto", "bitplane_sharded",
                                      "bitplane_sharded_2d"):
        raise ValueError(
            f"solve_sharded serves coupling_format='bitplane_sharded' / "
            f"'bitplane_sharded_2d' (or 'auto'), got "
            f"{config.coupling_format!r} — use solve(backend='fused') for "
            f"the single-device tiers")
    if config.coupling_format == "bitplane_sharded_2d" and not grp_dims:
        raise ValueError(
            f"coupling_format='bitplane_sharded_2d' needs a (groups..., "
            f"rows) mesh with at least 2 axes; mesh {M.mesh_desc(mesh)} has "
            f"one — use 'bitplane_sharded' (or 'auto') for 1-D meshes")
    num_rows = _check_row_shardable(n, mesh)
    _check_group_replicas(config, mesh)
    n_loc = n // num_rows
    lo = mesh.get_local_rank(M.mesh_axes_split(mesh)[1][0]) * n_loc
    if coupling is not None:
        coupling_store.CouplingStore.from_planes(coupling, fmt)
        coupling_store.validate_planes_cover(coupling, n)
        return BitPlanes(coupling.pos[:, lo:lo + n_loc].contiguous(),
                         coupling.neg[:, lo:lo + n_loc].contiguous(),
                         n).to(device)
    if problem.couplings is None:
        return shard_planes_from_edges(problem.edges, mesh, num_planes,
                                       device=device)
    J = problem.couplings
    if num_planes is None:
        num_planes = max(1, coupling_store._max_abs(J).bit_length())
    return encode_couplings(
        J, num_planes, align_words=coupling_store.FORMATS[fmt].align_words,
        row_range=(lo, lo + n_loc)).to(device)


class ShardedRunner(M.MeshRunner, ChunkRunner):
    """``solve_sharded`` as a chunk plan (the chunks of ``ops.FusedRunner``
    and its best-so-far merge). The state is this rank's part: ``(u, s,
    e, best_e, best_s, num_flips, rows_fetched)``, the (R_loc, N/D)
    slices and the group's (R_loc,) vectors; ``trace_row``,
    ``best_energy`` and ``finalize`` put the replicas together on every
    rank (collectives), as do ``snapshot_state`` and the supervisor's stop
    decisions."""

    def __init__(self, problem: ising.IsingProblem, seed,
                 config: SolverConfig, mesh, *, chunk_steps: int = 256,
                 coupling: Optional[BitPlanes] = None,
                 num_planes: Optional[int] = None, coalesce: bool = True,
                 device=None, backend: str = "sharded"):
        if config.flip_mode != "single":
            raise ValueError(
                f"solve_sharded runs single-flip sweeps (flip_mode="
                f"{config.flip_mode!r}); the colored path has no sharded "
                "tier")
        self.device = resolve_device(device)
        M.check_mesh_device(mesh, self.device)
        self.mesh = mesh
        self.backend = backend
        self.planes = resolve_sharded_planes(
            problem, config, mesh, coupling=coupling, num_planes=num_planes,
            device=self.device)
        self.layout = Layout(config, mesh, problem.num_spins)
        self.fmt = ("bitplane_sharded_2d" if self.layout.grp_dims
                    else "bitplane_sharded")
        self.problem = problem
        self.offset = float(problem.offset)
        self.fields = problem.fields.to(self.device, torch.float32)
        self.coalesce = coalesce
        self._plan(config, chunk_steps)
        self.base = rng.fold_in(rng.key(0), int(seed))  # on the CPU
        self.words = rng.words(self.base)
        self.pwl = ops.solver_pwl_table(config, device=self.device)
        self.temps = ops.anneal_temps(
            config, self.chunk_len, self.chunks,
            self.device)[:, self.layout.replicas].contiguous()

    def init(self):
        u0, s0, e0 = sharded_init(self.planes, self.fields, self.base,
                                  self.layout)
        zeros = torch.zeros(self.layout.r_loc, dtype=torch.int32,
                            device=self.device)
        return (u0, s0, e0, e0.clone(), s0.clone(), zeros, zeros.clone())

    def chunk_uniforms(self, k: int) -> torch.Tensor:
        """The group's (T, R_loc, 4) block of chunk k's uniforms: the card
        draws the full (T, R, 4) with kernel A's own draw."""
        clen = self.unit_len(k)
        r = self.num_replicas
        if self.device.type == "cuda":
            full = sweep.sweep_uniforms(self.words, k, clen, r, self.device)
        else:
            full = rng.uniform01(rng.stream(self.base, rng.Salt.SWEEP, k),
                                 (clen, r, 4))
        return full[:, self.layout.replicas]

    def run_chunk(self, state, k: int):
        u, s, e, be, bs, nf, rf = state
        u, s, e, ce, cs, cf, crf = sharded_sweep(
            self.planes, u, s, e, self.chunk_uniforms(k),
            self.temps[self._rows(k)], self.pwl, self.layout,
            mode=self.config.mode, uniformized=self.config.uniformized,
            coalesce=self.coalesce)
        better = ce < be
        return (u, s, e, torch.where(better, ce, be),
                torch.where(better[:, None], cs, bs), nf + cf, rf + crf)

    def best_energy(self, state) -> float:
        return float(self.trace_row(state).min()) + self.offset

    def trace_row(self, state):
        return self.layout.replica_vector(state[3])

    def snapshot_state(self, state) -> tuple:
        """The whole state, (R, N) and (R,), on every rank."""
        lay = self.layout
        return tuple(lay.replica_rows(x) if x.dim() == 2
                     else lay.replica_vector(x) for x in state)

    def local_state(self, state) -> tuple:
        """This rank's part of a whole state."""
        lay = self.layout
        return tuple(x[lay.replicas, lay.rows].contiguous() if x.dim() == 2
                     else x[lay.replicas].contiguous() for x in state)

    def finalize(self, state, rows) -> SolveResult:
        u, s, e, be, bs, nf, rf = self.snapshot_state(state)
        return ops._result((u, s, e, be, bs, nf), rf, self._trace(rows),
                           self.offset, self.config)


def solve_sharded(problem: ising.IsingProblem, seed, config: SolverConfig,
                  mesh, *, chunk_steps: int = 256,
                  coupling: Optional[BitPlanes] = None,
                  num_planes: Optional[int] = None, coalesce: bool = True,
                  device=None) -> SolveResult:
    """Anneal with the coupling planes row-sharded over ``mesh`` (a
    ``DeviceMesh``; SPMD: every rank calls it alike and gets the whole
    result).

    The trajectory of ``solve(..., backend="fused")`` on the same seed and
    config, on any single-device tier: the same replica init, chunk
    streams, selection and update arithmetic; only where the planes live
    changes. Each rank holds ``store.nbytes / D`` plane bytes (D the rows
    dim), encoded from an edge list per rank in O(nnz). On a 2-D mesh the
    leading dims are replica groups (the ``bitplane_sharded_2d`` tier).

    Needs an integer J, N divisible by the row-shard count in whole
    roulette lanes, and ``config.num_replicas`` divisible by the group
    count; ``config.coupling_format`` is "auto", "bitplane_sharded" or (2-D
    meshes) "bitplane_sharded_2d". ``coupling`` takes pre-packed planes
    (each rank keeps its rows), ``num_planes`` forces B, ``coalesce``
    broadcasts each step's unique rows once (the trajectory does not
    depend on it; ``rows_fetched`` records the broadcasts). ``device`` as
    in :func:`repro_torch.device.resolve_device`; it must match the mesh's
    device type.
    """
    return ShardedRunner(problem, seed, config, mesh,
                         chunk_steps=chunk_steps, coupling=coupling,
                         num_planes=num_planes, coalesce=coalesce,
                         device=device).drive()
