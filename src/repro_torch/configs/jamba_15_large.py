"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2. Mamba:attention 7:1 interleave (one attn
per 8-layer period), MoE every other layer [arXiv:2403.19887].
Hybrid ⇒ long_500k runs: Mamba state is O(1) and only 9/72 layers hold KV."""
from ..models.config import ModelConfig

_PATTERN = tuple(
    f"{'attn' if i == 3 else 'mamba'}:{'moe' if i % 2 == 1 else 'mlp'}"
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    block_pattern=_PATTERN,
    num_experts=16, experts_per_token=2, moe_d_ff=24576,
    norm="rmsnorm", activation="silu", gated_mlp=True,
    ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    remat="full",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    block_pattern=_PATTERN,
    num_experts=4, experts_per_token=2, moe_d_ff=128, capacity_factor=4.0,
    norm="rmsnorm", activation="silu", gated_mlp=True,
    ssm_state_dim=4, ssm_conv_width=4, ssm_expand=2, ssm_chunk=8,
    seq_chunk_q=16, seq_chunk_kv=16,
)
