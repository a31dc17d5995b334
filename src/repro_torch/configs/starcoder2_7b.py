"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
GQA + RoPE; non-gated GELU MLP; LayerNorm [arXiv:2402.19173; hf].
Note: the released model uses a 4k sliding window; full causal attention is
used here (the assigned shapes stop at 32k prefill; long_500k is skipped)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    norm="layernorm", activation="gelu", gated_mlp=False,
    remat="full",
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    norm="layernorm", activation="gelu", gated_mlp=False,
    seq_chunk_q=16, seq_chunk_kv=16,
)
