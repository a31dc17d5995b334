"""LM meshes over the ranks of a ``torch.distributed`` world (port of
``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group. A single pod is ``("data", "model")``; several pods add a leading
``"pod"`` dim. The meshes are ``DeviceMesh``es of the initialised world
(``repro_torch.distributed.init_world``, or ``torch.distributed.run``), on
which ``models.use_sharding`` and ``distributed.mesh``'s collectives run.

:func:`nccl_performance_env` is the counterpart of the JAX module's
``xla_performance_flags``: the settings a multi-GPU launch would make for
collective/compute overlap, recorded and inert (nothing applies them).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(distributed.init_world, or torch.distributed.run)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) = ("data", "model"), or (2, 16, 16) = ("pod", "data",
    "model") with ``multi_pod``: the world must have exactly that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, need = _world(), math.prod(shape)
    if n != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, "
                         f"the world has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, pods: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the world: (data, model) or (pod, data,
    model), data = ranks / (model_parallel · pods)."""
    n = _world()
    if n % (model_parallel * pods):
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}"
                         f"×pods={pods}")
    data = n // (model_parallel * pods)
    if pods > 1:
        return init_device_mesh(device_type, (pods, data, model_parallel),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model_parallel),
                            mesh_dim_names=("data", "model"))


def nccl_performance_env() -> list:
    """``[(variable, value, reason)]``: the environment a multi-GPU launch
    of the port would set for collective/compute overlap on H100s joined
    by NVLink. Recorded here so launch scripts stay the deployable
    artifact; nothing in the package applies them."""
    return [
        ("CUDA_DEVICE_MAX_CONNECTIONS", "1",
         "one hardware queue: kernels start in issue order, so a "
         "collective issued before a GEMM overlaps it as scheduled"),
        ("TORCH_NCCL_HIGH_PRIORITY", "1",
         "NCCL's streams at high priority: collectives are not starved by "
         "the compute kernels they overlap"),
        ("TORCH_NCCL_AVOID_RECORD_STREAMS", "1",
         "async collectives keep their tensors alive by reference, not by "
         "recordStream, so the caching allocator reuses them on time"),
        ("NCCL_NVLS_ENABLE", "1",
         "NVLink SHARP on the NVSwitch: all-reduces and reduce-scatters "
         "reduced in the switch, fewer SMs taken from compute"),
        ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1",
         "a hung collective aborts the process group instead of stalling "
         "every rank"),
    ]
