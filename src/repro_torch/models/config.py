"""Model configuration for the 10 assigned architectures (+ reduced smoke configs).

A copy of ``repro.models.config`` (the port keeps its own, importing nothing
of the JAX package); the fields, properties and parameter counts are the same.

One frozen dataclass covers dense GQA transformers, MoE, SSM (Mamba), RWKV6,
hybrid interleaves, and encoder-only backbones. ``block_pattern`` is a cycle of
``"<mixer>:<ffn>"`` entries (mixer ∈ attn|mamba|rwkv, ffn ∈ mlp|moe|cmix);
layers are stacked in groups of ``len(block_pattern)``; the port's model loops
over the groups where the JAX package scans them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free architectures
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 ⇒ d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn:mlp",)

    # Attention / embedding features
    causal: bool = True              # False ⇒ encoder-only (bidirectional)
    qkv_bias: bool = False           # qwen2
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    activation: str = "silu"         # silu | gelu | relu2 (squared ReLU)
    gated_mlp: bool = True           # SwiGLU-style gate; False ⇒ plain 2-matmul MLP

    # Mixture-of-Experts
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden width (0 ⇒ d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Mamba (SSM) blocks
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 ⇒ ceil(d_model / 16)

    # RWKV6 blocks
    rwkv_head_dim: int = 64

    # Modality frontend stub: None | "vision_patches" | "audio_frames"
    frontend: Optional[str] = None

    # Numerics / training behaviour
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"              # none | full | dots
    attn_impl: str = "chunked"       # chunked (plain torch) | flash (the CUDA kernel)
    seq_chunk_q: int = 512           # flash-attention query block
    seq_chunk_kv: int = 1024         # flash-attention kv block
    ssm_chunk: int = 256             # selective-scan chunk length

    def __post_init__(self):
        if self.num_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} must be a multiple of "
                f"the block pattern length {len(self.block_pattern)}")
        for entry in self.block_pattern:
            mixer, _, ffn = entry.partition(":")
            if mixer not in ("attn", "mamba", "rwkv") or ffn not in ("mlp", "moe", "cmix"):
                raise ValueError(f"bad block pattern entry {entry!r}")
            if ffn == "moe" and (self.num_experts <= 0 or self.experts_per_token <= 0):
                raise ValueError(f"{self.name}: moe blocks need num_experts/experts_per_token")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return any(e.startswith("attn") for e in self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True when decode state is O(1) in context (SSM/linear-recurrent mixers
        only, or hybrid where attention KV is a bounded fraction)."""
        return any(e.startswith(("mamba", "rwkv")) for e in self.block_pattern)

    @property
    def uses_token_embedding(self) -> bool:
        return self.frontend is None

    def param_count(self) -> int:
        """Exact parameter count (used for MODEL_FLOPS = 6·N·D in §Roofline)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        for entry in self.block_pattern:
            mixer, _, ffn = entry.partition(":")
            if mixer == "attn":
                qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                if self.qkv_bias:
                    qkv += self.num_heads * hd + 2 * self.num_kv_heads * hd
                total_block = qkv + (self.num_heads * hd) * d
            elif mixer == "mamba":
                di, n, r = self.d_inner, self.ssm_state_dim, self.resolved_dt_rank
                total_block = (d * 2 * di + di * self.ssm_conv_width
                               + di * (r + 2 * n) + r * di + di + di * n + di + di * d)
            else:  # rwkv time-mix
                total_block = 4 * d * d + d * d  # r,k,v,g proj + output
                total_block += 2 * (d * 32 + 32 * d)  # decay/mix LoRA (rank 32)
            total_block += d  # pre-norm
            if ffn == "mlp":
                mult = 3 if self.gated_mlp else 2
                total_block += mult * d * self.d_ff
            elif ffn == "cmix":
                total_block += 2 * d * self.d_ff
            else:
                e, eff = self.num_experts, self.resolved_moe_d_ff
                mult = 3 if self.gated_mlp else 2
                total_block += d * e + e * mult * d * eff
            total_block += d  # post-norm
            total += total_block * self.num_groups
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        e, k, eff, d = self.num_experts, self.experts_per_token, self.resolved_moe_d_ff, self.d_model
        mult = 3 if self.gated_mlp else 2
        num_moe_blocks = sum(1 for x in self.block_pattern if x.endswith(":moe")) * self.num_groups
        inactive = num_moe_blocks * (e - k) * mult * d * eff
        return full - inactive
