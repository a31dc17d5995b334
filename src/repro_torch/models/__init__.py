"""The LM substrate's forward and decode (port of ``repro.models``):
configs, parameter specs, layers, the dense, MoE, Mamba-hybrid and RWKV
models, and their logical-axis sharding over a ``DeviceMesh``."""
from .config import ModelConfig  # noqa: F401
from .model import (LM, ForwardOut, decode_step, forward,  # noqa: F401
                    init_decode_cache, model_specs)
from .params import (ParamSpec, abstract_params, gather_params,  # noqa: F401
                     init_params, param_bytes, param_count, param_shardings,
                     shard_params)
from .sharding import (MeshShape, NamedSharding,  # noqa: F401
                       PartitionSpec, ShardingRules, logical_constraint,
                       make_sharding, use_sharding)
