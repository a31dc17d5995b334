"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
GQA, squared-ReLU (non-gated), LayerNorm, RoPE [arXiv:2402.16819]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    norm="layernorm", activation="relu2", gated_mlp=False,
    remat="full",
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=384, vocab_size=512,
    norm="layernorm", activation="relu2", gated_mlp=False,
    seq_chunk_q=16, seq_chunk_kv=16,
)
