"""RWKV-6 "Finch" blocks (arXiv:2404.05892): data-dependent-decay time-mix
and token-shift channel-mix. Port of ``repro.models.rwkv``.

Time-mix recurrence per head (head dim D):
    wkv_t = diag(w_t) · wkv_{t-1} + k_tᵀ v_t           (D×D state)
    o_t   = r_t · (diag(u) · k_tᵀ v_t + wkv_{t-1})
with w_t = exp(−exp(decay_t)), decay_t data-dependent through a LoRA on the
shifted input; the token-shift lerps are LoRA-modulated too. Channel-mix
is the shifted two-layer FFN with a receptance gate.

A prefill whose length is a multiple of 16 runs :func:`_wkv_chunked` (16
steps a chunk, matmul-shaped); decode and other lengths run
:func:`_wkv_scan`. Both are Python loops where the JAX package has
``lax.scan``. The decode state is ``(wkv (B, H, D, D), shift (B, d),
cmix_shift (B, d))``; the port's model writes it into its decode cache in
place (``models.model.decode_step``), while :func:`time_mix` and
:func:`channel_mix` return the new state, as the JAX functions do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import silu
from .params import torch_dtype

N_MIX = 5  # r, k, v, g, w token-shift lerps

#: Steps of one chunk of the chunked wkv (the JAX package's).
WKV_CHUNK = 16


class RwkvCache(NamedTuple):
    wkv: torch.Tensor         # (B, H, D, D) float32
    shift: torch.Tensor       # (B, d) last token (time-mix shift)
    cmix_shift: torch.Tensor  # (B, d) last token (channel-mix shift)


def init_cache(cfg: ModelConfig, batch: int,
               device: DeviceLike = None) -> RwkvCache:
    """A zero decode state for ``batch`` sequences on ``device`` (None:
    the card, raising when there is none)."""
    device = resolve_device(device)
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dtype = torch_dtype(cfg.compute_dtype)
    return RwkvCache(
        wkv=torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                        device=device),
        shift=torch.zeros((batch, d), dtype=dtype, device=device),
        cmix_shift=torch.zeros((batch, d), dtype=dtype, device=device))


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} with x_{-1} = prev (zeros at the sequence start)."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None]
    shifted = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted = shifted.clone()
        shifted[:, 0] = prev
    return shifted


def _wkv_scan(r, k, v, w, u, state):
    """The sequential wkv recurrence. r, k, v: (B, S, H, D); w: (B, S, H, D)
    decay in (0, 1); u: (H, D) bonus; state: (B, H, D, D). Returns out
    (B, S, H, D) and the final state."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    wkv = state
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]   # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                                 u[None, :, :, None] * kv + wkv))
        wkv = w[:, t, :, :, None] * wkv + kv
    return torch.stack(outs, dim=1), wkv


def _wkv_chunked(r, k, v, w, u, state, chunk: int = WKV_CHUNK):
    """Chunked-parallel wkv, mathematically :func:`_wkv_scan`.

    Within a chunk of C steps (per head and batch), with P_t = Π_{s≤t} w_s:
        out_t = Σ_{τ<t} (r_t·(P_{t-1}/P_τ)·k_τ) v_τ + (r_t·u·k_t) v_t
                + (r_t ⊙ P_{t-1}) · S_in
        S_out = P_C ⊙ S_in + Σ_τ (P_C/P_τ) ⊙ k_τ v_τ
    through a_t = r_t ⊙ P_{t-1} and b_τ = k_τ / P_τ, f32-safe while
    C·|log w|max stays under ~80: ``time_mix`` clips the decay exponent at
    +1 (w >= exp(−e)), so C = 16 gives at most 43.5. Every term but those
    of S_in is made for all chunks at once; the loop over chunks (the JAX
    package's ``lax.scan``) carries S_in alone. Falls back to the scan
    unless S is a multiple of ``chunk``."""
    b, s, h, d = r.shape
    if s % chunk:
        return _wkv_scan(r, k, v, w, u, state)
    nc = s // chunk
    rr, kk, vv, ww = (t.float().reshape(b, nc, chunk, h, d)
                      for t in (r, k, v, w))
    logw = torch.log(torch.clamp(ww, min=1e-38))
    logp = torch.cumsum(logw, dim=2)
    p_last = torch.exp(logp[:, :, -1])                     # (B, nc, H, D)
    a = rr * torch.exp(logp - logw)                        # r_t ⊙ P_{t-1}
    bmat = kk * torch.exp(-logp)                           # k_τ / P_τ
    tri = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
    scores = torch.einsum("bcthd,bcshd->bchts", a, bmat) * tri
    diag = torch.einsum("bcthd,hd,bcthd->bcth", rr, u, kk)
    scores = scores + torch.einsum(
        "bcth,ts->bchts", diag, torch.eye(chunk, device=r.device))
    intra = torch.einsum("bchts,bcshe->bcthe", scores, vv)
    carry_k = kk * torch.exp(logp[:, :, -1:] - logp)       # (P_C/P_τ)·k_τ
    kv = torch.einsum("bcshd,bcshe->bchde", carry_k, vv)
    s_in = state.float()
    cross = []
    for c in range(nc):
        cross.append(torch.einsum("bthd,bhde->bthe", a[:, c], s_in))
        s_in = p_last[:, c, ..., None] * s_in + kv[:, c]
    out = intra + torch.stack(cross, dim=1)
    return out.reshape(b, s, h, d), s_in


def time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
             cache: Optional[RwkvCache] = None):
    """x: (B, S, d) -> (out (B, S, d), the new cache when ``cache`` is
    given, else None)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = x.dtype
    prev = cache.shift if cache is not None else None
    xs = _token_shift(x, prev)
    delta = xs - x

    # Data-dependent token-shift lerp: mu + LoRA(x) per r/k/v/g/w stream.
    base = p["mix_base"].to(dt)                            # (N_MIX, d)
    lora = torch.tanh((x + 0.5 * delta) @ p["mix_lora_a"].to(dt))
    lora = torch.einsum("bsr,rmd->bsmd", lora, p["mix_lora_b"].to(dt))
    mixed = x[:, :, None, :] + (base[None, None] + lora) * delta[:, :, None, :]
    xr, xk, xv, xg, xw = mixed.unbind(dim=2)

    r = (xr @ p["wr"].to(dt)).reshape(b, s, h, hd)
    k = (xk @ p["wk"].to(dt)).reshape(b, s, h, hd)
    v = (xv @ p["wv"].to(dt)).reshape(b, s, h, hd)
    g = silu(xg @ p["wg"].to(dt))

    # Data-dependent decay: w_t = exp(-exp(decay_base + LoRA(xw))), the
    # exponent clipped at +1 so the chunked form stays f32-safe.
    dec = torch.tanh(xw @ p["decay_lora_a"].to(dt))
    dec = dec @ p["decay_lora_b"].to(dt)
    log_w = -torch.exp(torch.clamp(p["decay_base"].float() + dec.float(),
                                   -8.0, 1.0))
    w = torch.exp(log_w).reshape(b, s, h, hd)

    u = p["bonus"].float()                                 # (H, D)
    state = (cache.wkv if cache is not None else
             torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device))
    if s > 1 and s % WKV_CHUNK == 0:
        out, new_state = _wkv_chunked(r, k, v, w, u, state)
    else:
        out, new_state = _wkv_scan(r, k, v, w, u, state)

    # Per-head group norm, then the gated output projection.
    mean = out.mean(-1, keepdim=True)
    var = (out - mean).square().mean(-1, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    out = out * (1.0 + p["ln_x"].float().reshape(1, 1, h, hd))
    out = out.reshape(b, s, d).to(dt) * g
    out = out @ p["wo"].to(dt)
    new_cache = None
    if cache is not None:
        new_cache = RwkvCache(wkv=new_state, shift=x[:, -1],
                              cmix_shift=cache.cmix_shift)
    return out, new_cache


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                cache: Optional[RwkvCache] = None):
    """x: (B, S, d) -> (out (B, S, d), the cache with the new channel-mix
    shift when ``cache`` is given, else None)."""
    dt = x.dtype
    prev = cache.cmix_shift if cache is not None else None
    xs = _token_shift(x, prev)
    delta = xs - x
    xk = x + p["mu_k"].to(dt) * delta
    xr = x + p["mu_r"].to(dt) * delta
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    kv = k @ p["wv"].to(dt)
    one = torch.tensor(1.0, dtype=dt, device=x.device)
    # jax.nn.sigmoid, op by op in x's dtype as XLA expands it.
    r = one / (one + torch.exp(-(xr @ p["wr"].to(dt))))
    new_cache = None
    if cache is not None:
        new_cache = cache._replace(cmix_shift=x[:, -1])
    return r * kv, new_cache
