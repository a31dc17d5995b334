"""The LM substrate's serving path (port of ``repro.models``): configs,
parameter specs, layers and the dense ``attn:mlp`` model."""
from .config import ModelConfig  # noqa: F401
from .model import (LM, ForwardOut, decode_step, forward,  # noqa: F401
                    init_decode_cache, model_specs)
from .params import (ParamSpec, init_params, param_bytes,  # noqa: F401
                     param_count)
