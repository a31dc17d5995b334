"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
LM backbone only; the anyres vision tower is a STUB — input_specs() supplies
precomputed patch embeddings of backbone width [hf:llava-hf/llava-v1.6]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    norm="rmsnorm", activation="silu", gated_mlp=True,
    frontend="vision_patches", remat="full",
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=512,
    norm="rmsnorm", activation="silu", gated_mlp=True,
    frontend="vision_patches", seq_chunk_q=16, seq_chunk_kv=16,
)
