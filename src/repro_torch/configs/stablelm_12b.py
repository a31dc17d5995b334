"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
SwiGLU, LayerNorm, RoPE, QKV bias (StableLM-2 family) [hf:stabilityai/stablelm-2-1_6b]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    norm="layernorm", activation="silu", gated_mlp=True, qkv_bias=True,
    remat="full",
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=512,
    norm="layernorm", activation="silu", gated_mlp=True, qkv_bias=True,
    seq_chunk_q=16, seq_chunk_kv=16,
)
