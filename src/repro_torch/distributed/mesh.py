"""Meshes and collectives of the multi-GPU solver, on ``torch.distributed``.

The JAX package runs one controller over a ``jax.sharding.Mesh`` and moves
data with ``shard_map`` collectives. The port is SPMD: one process per rank,
every rank calls the same entry point with the same arguments, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dims stands
for the JAX mesh. Meshes are 1-D with the dim ``"spins"``, or ``(groups...,
rows)``: :func:`mesh_dim_names` gives the names :func:`build_mesh` uses.

Every collective of the solvers goes through :func:`all_reduce` or
:func:`broadcast` here, on the process groups of the mesh's dims only, and
is counted in :data:`COLLECTIVES` by (op, dim). Gathers are written as
zero-padded sums (a block plus exact zeros from every other rank is the
block, bit for bit), since gloo on CUDA tensors has ``all_reduce`` and
``broadcast`` but no ``all_gather``; with CUDA tensors on gloo, gloo itself
copies each operand through pinned host memory.
"""
from __future__ import annotations

import collections
import math
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class CollectiveLog:
    """Counts of the collectives issued, and the bytes of their operands,
    by ``(op, dim)``. Each of ``listeners`` (the roofline's cost counter)
    is called with ``(op, bytes, group size)`` at every collective."""

    def __init__(self):
        self.counts = collections.Counter()
        self.bytes = collections.Counter()
        self.listeners: list = []

    def reset(self) -> None:
        self.counts.clear()
        self.bytes.clear()

    def add(self, key: tuple, x: torch.Tensor, group: int = 1) -> None:
        n = x.numel() * x.element_size()
        self.counts[key] += 1
        self.bytes[key] += n
        for listener in self.listeners:
            listener(key[0], n, group)

    @property
    def total(self) -> int:
        return sum(self.counts.values())


COLLECTIVES = CollectiveLog()


def mesh_dim_names(shape: Sequence[int]) -> tuple:
    """``("spins",)`` for a 1-D shape; ``("groups", "rows")`` for 2-D;
    ``("groups0", ..., "rows")`` past that."""
    shape = tuple(shape)
    if len(shape) == 1:
        return ("spins",)
    if len(shape) == 2:
        return ("groups", "rows")
    return tuple(f"groups{i}" for i in range(len(shape) - 1)) + ("rows",)


def parse_mesh_shape(spec: Optional[str], world_size: int) -> tuple:
    """``"4"`` → (4,), ``"2x2"`` → (2, 2); None → (world_size,)."""
    if spec is None:
        return (world_size,)
    try:
        shape = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh shape {spec!r}: expected e.g. '4' or "
                         "'2x2'") from None
    if not shape or min(shape) < 1:
        raise ValueError(f"mesh shape {spec!r}: every dim must be >= 1")
    return shape


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(backend: Optional[str] = None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """Initialise the default process group. Under ``torch.distributed.run``
    (``RANK`` in the environment) it reads the environment; otherwise, with
    no ``rank`` given, it starts a world of 1 on a free localhost port.
    ``backend`` defaults to NCCL for CUDA meshes and gloo for CPU ones.
    A CUDA rank takes the card ``LOCAL_RANK`` (or its rank) modulo the
    cards it sees. A failed initialisation raises."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if rank is None and "RANK" in os.environ:
        init_method = init_method or "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif rank is None:
        rank, world_size = 0, 1
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def build_mesh(spec: Optional[str] = None,
               device_type: str = "cuda") -> DeviceMesh:
    """The mesh of ``spec`` (``"4"``: 1-D row sharding; ``"2x2"``: the
    2-D (groups, rows) layout; None: every rank on one 1-D dim) over the
    ranks of the initialised default process group, whose size must be
    the mesh's."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised process group "
                           "(init_world, or torch.distributed.run)")
    world = dist.get_world_size()
    shape = parse_mesh_shape(spec, world)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=mesh_dim_names(shape))


def dim_size(mesh: DeviceMesh, dim: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(dim)])


def mesh_size(mesh: DeviceMesh, dims) -> int:
    """The number of ranks the dims ``dims`` span."""
    size = 1
    for d in dims:
        size *= dim_size(mesh, d)
    return size


def flat_shard_index(mesh: DeviceMesh, dims) -> int:
    """This rank's linear index over ``dims``, row-major in dim order (the
    flattening the JAX package's ``PartitionSpec((axes...))`` uses)."""
    idx = 0
    for d in dims:
        idx = idx * dim_size(mesh, d) + mesh.get_local_rank(d)
    return idx


def mesh_axes_split(mesh: DeviceMesh):
    """``(group_dims, row_dims)``: the last dim row-shards the planes, the
    leading ones are replica groups (none on a 1-D mesh)."""
    dims = tuple(mesh.mesh_dim_names)
    return dims[:-1], dims[-1:]


def mesh_desc(mesh: DeviceMesh) -> str:
    return "(" + ", ".join(f"{d}={dim_size(mesh, d)}"
                           for d in mesh.mesh_dim_names) + ")"


def check_mesh_device(mesh: DeviceMesh, device: torch.device) -> None:
    """A mesh's device type must be the solve's: a CUDA mesh never runs a
    CPU solve, nor a CPU mesh a CUDA one."""
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh's device type is {mesh.device_type!r} but the solve "
            f"runs on {device}; build the mesh and the solve on one device "
            "type (no fallback)")


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, dims,
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place over the ranks of ``dims``, one collective
    per dim on that dim's process group (a reduction over several dims is
    their reductions in turn, as the JAX package's per-axis ``psum``)."""
    for d in dims:
        dist.all_reduce(x, op=_OPS[op], group=mesh.get_group(d))
        COLLECTIVES.add((f"all_reduce_{op}", d), x, dim_size(mesh, d))
    return x


def broadcast(x: torch.Tensor, mesh: DeviceMesh, dim: str,
              src: int) -> torch.Tensor:
    """``x`` broadcast in place from the rank at index ``src`` along
    ``dim`` to the others of its group."""
    group = mesh.get_group(dim)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    COLLECTIVES.add(("broadcast", dim), x, dim_size(mesh, dim))
    return x


def assemble(block: torch.Tensor, shape, at, mesh: DeviceMesh,
             dims) -> torch.Tensor:
    """The tensor of ``shape`` whose part ``at`` (a tuple of slices) this
    rank holds, put together over the ranks of ``dims``: each rank places
    its block in zeros and the ranks' tensors are summed as integers (a
    float32 as its int32 bits), so every element is its owner's value bit
    for bit, -0.0 included. The blocks of the ranks must not overlap."""
    out = block.new_zeros(shape)
    out[at] = block
    if dims:
        all_reduce(out.view(torch.int32) if out.dtype == torch.float32
                   else out, mesh, dims)
    return out


def agree(value: int, mesh: DeviceMesh, device) -> int:
    """The largest ``value`` over every rank of the mesh: a decision all
    ranks take together (and a barrier)."""
    t = torch.tensor([int(value)], dtype=torch.int32, device=device)
    return int(all_reduce(t, mesh, mesh.mesh_dim_names, "max")[0])


class MeshRunner:
    """What a chunk runner on a mesh adds for the resilient supervisor: the
    mesh's rank 0 writes the snapshots (``writes_snapshots``) of the state
    put together on every rank (``snapshot_state``), every rank resumes
    its part of it (``local_state``), and stop decisions are taken together
    (``agree``)."""

    mesh: DeviceMesh
    device: torch.device

    @property
    def writes_snapshots(self) -> bool:
        return flat_shard_index(self.mesh, self.mesh.mesh_dim_names) == 0

    def agree(self, value: int) -> int:
        return agree(value, self.mesh, self.device)
