"""AdamW with optional 8-bit moments and the learning-rate schedules
(port of ``repro.optim``)."""
from .adamw import (AdamWConfig, AdamWState, QTensor, adamw_init,  # noqa: F401
                    adamw_update, global_norm, state_bytes)
from .schedule import cosine_lr, linear_warmup_cosine  # noqa: F401
