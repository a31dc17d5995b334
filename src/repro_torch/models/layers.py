"""Shared layers: norms, activations, rotary embeddings, chunked attention,
decode attention and the dense/gated MLP (port of ``repro.models.layers``).

Plain functions on tensors; parameters come as dicts of tensors (spec trees
in ``model.py``). Each rounds where the JAX function rounds: norms and rope
compute in f32 and cast back to the input's dtype; a contraction that JAX
asks for with ``preferred_element_type=f32`` is taken on f32 copies of its
operands (a product of two bf16 values is exact in f32), and every weight is
cast to the activation's dtype first. ``logical_constraint`` has no part on
one device and is left out.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def norm(cfg: ModelConfig, scale: torch.Tensor, x: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * (1.0 + scale.float())
    else:  # layernorm
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + 1e-6) * (1.0 + scale.float())
        if bias is not None:
            out = out + bias.float()
    return out.to(x.dtype)


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """A Python constant as JAX applies it to x: rounded to x's dtype."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op: XLA expands the logistic as
    1 / (1 + exp(-x)), each result rounded to x's dtype."""
    one = _const(x, 1.0)
    return x * (one / (one + torch.exp(-x)))


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Op by op as ``jax.nn``'s, each result rounded to x's dtype (in bf16
    the rounding after every op is part of the function)."""
    c = functools.partial(_const, x)
    if cfg.activation == "silu":
        return silu(x)
    if cfg.activation == "gelu":
        # jax.nn.gelu's default: the tanh approximation.
        inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
        return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))
    if cfg.activation == "relu2":  # squared ReLU (nemotron / Primer)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {cfg.activation!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     exponent)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked attention — plain torch, O(S·blk) live memory
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, mask):
    """GQA-grouped block attention. q (B,K,R,Tq,D); k/v (B,K,Tk,D);
    mask (Tq,Tk) or None -> (scores_max, exp_sum, acc). KV is never
    repeated to Hq = K·R heads: the group dim R rides along."""
    s = torch.einsum("bkrqd,bkld->bkrql", q.float(), k.float())
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:  # fully-masked rows must contribute zero, not exp(0)
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrql,bkld->bkrqd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int, kv_chunk: int,
                      scale: float) -> torch.Tensor:
    """Flash-style attention in plain torch: a loop over KV blocks with a
    running (m, l, acc), as ``repro.models.layers.chunked_attention``.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq a multiple of Hkv.
    Returns (B, Hq, Sq, D) in k's dtype. q is scaled in its own dtype (the
    scale rounded to it), and p is cast to v's dtype before P·V, where JAX
    does both.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    q = (q * _const(q, scale)).reshape(b, hkv, rep, sq, d)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq, nk = sq // q_chunk, skv // kv_chunk
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"seq ({sq},{skv}) not divisible by chunks ({q_chunk},{kv_chunk})")

    out = torch.empty((b, hkv, rep, sq, d), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        q_blk = q[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]
        m = torch.full((b, hkv, rep, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, rep, q_chunk), device=q.device)
        acc = torch.zeros((b, hkv, rep, q_chunk, d), device=q.device)
        for kj in range(nk):
            k_blk = k[:, :, kj * kv_chunk:(kj + 1) * kv_chunk]
            v_blk = v[:, :, kj * kv_chunk:(kj + 1) * kv_chunk]
            mask = None
            if causal:
                rows = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                cols = kj * kv_chunk + torch.arange(kv_chunk, device=q.device)
                mask = rows[:, None] >= cols[None, :]
            m2, l2, acc2 = _attend_block(q_blk, k_blk, v_blk, mask)
            m_new = torch.maximum(m, m2)
            c1 = torch.exp(m - m_new)
            c2 = torch.exp(m2 - m_new)
            l = l * c1 + l2 * c2
            acc = acc * c1[..., None] + acc2 * c2[..., None]
            m = m_new
        out[:, :, :, qi * q_chunk:(qi + 1) * q_chunk] = \
            acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(k.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     scale: float) -> torch.Tensor:
    """Attention of S new tokens over a KV cache, GQA-native.

    q: (B, Hq, S, D); caches: (B, Hkv, L, D) with Hq a multiple of Hkv.
    Positions ≥ cache_len are masked, and nothing else: S > 1 tokens see
    each other both ways, as in the reference (ROADMAP reference caveats).
    """
    b, hq, s, d = q.shape
    hkv = k_cache.shape[1]
    rep = hq // hkv
    qg = (q * _const(q, scale)).reshape(b, hkv, rep, s, d)
    sc = torch.einsum("bkrqd,bkld->bkrql", qg.float(), k_cache.float())
    mask = torch.arange(k_cache.shape[2], device=q.device) < cache_len
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkrql,bkld->bkrqd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, hq, s, d).to(k_cache.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (gated / plain)
# ---------------------------------------------------------------------------

def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    h = activation(cfg, h)
    if cfg.gated_mlp:
        h = h * (x @ p["wg"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
