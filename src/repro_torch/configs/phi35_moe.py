"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) expert d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    block_pattern=("attn:moe",),
    num_experts=16, experts_per_token=2, moe_d_ff=6400,
    norm="layernorm", activation="silu", gated_mlp=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=512,
    block_pattern=("attn:moe",),
    num_experts=4, experts_per_token=2, moe_d_ff=96, capacity_factor=4.0,
    norm="layernorm", activation="silu", gated_mlp=True,
    seq_chunk_q=16, seq_chunk_kv=16,
)
