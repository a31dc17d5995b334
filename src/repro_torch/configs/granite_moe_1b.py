"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    block_pattern=("attn:moe",),
    num_experts=32, experts_per_token=8, moe_d_ff=512,
    norm="rmsnorm", activation="silu", gated_mlp=True,
    remat="dots",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512,
    block_pattern=("attn:moe",),
    num_experts=8, experts_per_token=4, moe_d_ff=64, capacity_factor=8.0,
    norm="rmsnorm", activation="silu", gated_mlp=True,
    seq_chunk_q=16, seq_chunk_kv=16,
)
