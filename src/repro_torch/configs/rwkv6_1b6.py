"""rwkv6-1.6b "Finch" [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — data-dependent decay time-mix + channel-mix [arXiv:2404.05892].
Sub-quadratic: O(1)-state decode makes long_500k runnable."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    block_pattern=("rwkv:cmix",),
    norm="layernorm", rwkv_head_dim=64,
    remat="dots",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=128, vocab_size=512,
    block_pattern=("rwkv:cmix",),
    norm="layernorm", rwkv_head_dim=16,
)
