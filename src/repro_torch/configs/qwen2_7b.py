"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
GQA, QKV bias, SwiGLU, RMSNorm, RoPE theta=1e6 [arXiv:2407.10671; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    norm="rmsnorm", activation="silu", gated_mlp=True, qkv_bias=True,
    rope_theta=1_000_000.0, remat="full",
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512,
    norm="rmsnorm", activation="silu", gated_mlp=True, qkv_bias=True,
    rope_theta=1_000_000.0, seq_chunk_q=16, seq_chunk_kv=16,
)
