"""The multi-GPU solver on ``torch.distributed`` (port of
``repro.distributed``'s solver part): the mesh helpers and collectives
(:mod:`.mesh`), local SPMD worlds (:mod:`.world`), the replica-parallel
``solve_distributed`` (:mod:`.solver_dist`) and the row-sharded
``solve_sharded`` (:mod:`.solver_sharded`)."""
from .mesh import build_mesh, init_world  # noqa: F401
from .solver_dist import DistSolverConfig, solve_distributed  # noqa: F401
from .solver_sharded import solve_sharded  # noqa: F401
