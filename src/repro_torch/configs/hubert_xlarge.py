"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA, kv=16) d_ff=5120 vocab=504.
Encoder-only (bidirectional); the wav2vec2-style conv frontend is a STUB —
input_specs() supplies precomputed frame embeddings. Train = masked-frame
prediction over the 504-unit codebook [arXiv:2106.07447]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False, norm="layernorm", activation="gelu", gated_mlp=False,
    frontend="audio_frames", remat="dots",
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=64,
    causal=False, norm="layernorm", activation="gelu", gated_mlp=False,
    frontend="audio_frames", seq_chunk_q=16, seq_chunk_kv=16,
)
