"""Solver-as-a-service front end (port of ``repro.serve``), built only on
the ``core.backend`` registry: shape-bucketed request batching,
content-hash-keyed store and warm-start caches, and budgeted admission
control behind a synchronous :class:`SolverService` API on one device."""
from .cache import (LRUStoreCache, WarmStartCache, coupling_digest,
                    problem_digest)                              # noqa: F401
from .batching import (bucket_replicas, bucket_spins, pad_problem,
                       plan_batches, BatchPlan)                  # noqa: F401
from .service import (AdmissionError, ServeConfig, ServeResult,
                      SolveRequest, SolverService)               # noqa: F401
