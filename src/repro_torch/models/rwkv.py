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

Under a sharding context (``models.sharding``) the time mix runs on the
rank's ``rwkv_heads``: ``wr``, ``wk``, ``wv`` and ``wg`` column-parallel,
the decay (made whole from its LoRA), ``ln_x`` and ``bonus`` taken at the
rank's heads, the wkv state and the group norm per head, ``wo``
row-parallel and its partial sum reduced. The channel mix runs ``wk``
column- and ``wv`` row-parallel on the ``ffn`` dims; its receptance,
column-parallel on the heads, is gathered whole to gate the whole-d sum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..roofline.op_cost import named_scope
from . import sharding
from .config import ModelConfig
from .layers import silu
from .params import torch_dtype
from .sharding import logical_constraint

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


@named_scope("_wkv_scan")
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


@named_scope("_wkv_chunked")
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
    given, else None). Under a sharding context on the rank's heads (the
    cache's wkv state holds them too); ``out`` is then reduced and laid
    out as the residual stream."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    dt = x.dtype
    use = sharding.use
    prev = cache.shift if cache is not None else None
    xs = _token_shift(x, prev)
    delta = xs - x

    # Data-dependent token-shift lerp: mu + LoRA(x) per r/k/v/g/w stream.
    base = use(p["mix_base"], None, "embed_w")[0].to(dt)     # (N_MIX, d)
    lora = torch.tanh((x + 0.5 * delta)
                      @ use(p["mix_lora_a"], "embed_w", "lora")[0].to(dt))
    lora = torch.einsum("bsr,rmd->bsmd", lora, use(
        p["mix_lora_b"], "lora", None, "embed_w")[0].to(dt))
    mixed = x[:, :, None, :] + (base[None, None] + lora) * delta[:, :, None, :]
    xr, xk, xv, xg, xw = mixed.unbind(dim=2)

    wr, (_, hax) = use(p["wr"], "embed_w", "rwkv_heads")
    wk, (_, kax) = use(p["wk"], "embed_w", "rwkv_heads")
    wv, (_, vax) = use(p["wv"], "embed_w", "rwkv_heads")
    wg, (_, gax) = use(p["wg"], "embed_w", "rwkv_heads")
    wo, (oax, _) = use(p["wo"], "rwkv_heads", "embed_w")
    width = wr.shape[1]                     # the rank's heads · hd
    if len({hax, kax, vax, gax, oax}) != 1 or width % hd:
        raise NotImplementedError(
            f"an RWKV time mix with wr/wk/wv/wg/wo split over "
            f"{(hax, kax, vax, gax, oax)} into {width} columns: the port "
            f"splits them over one set of mesh dims on whole heads of {hd}")
    h = width // hd
    lo = sharding.block_offset(d, hax)
    r = (sharding.enter(xr, hax) @ wr.to(dt)).reshape(b, s, h, hd)
    k = (sharding.enter(xk, hax) @ wk.to(dt)).reshape(b, s, h, hd)
    v = (sharding.enter(xv, hax) @ wv.to(dt)).reshape(b, s, h, hd)
    g = silu(sharding.enter(xg, hax) @ wg.to(dt))

    # Data-dependent decay: w_t = exp(-exp(decay_base + LoRA(xw))), the
    # exponent clipped at +1 so the chunked form stays f32-safe; made whole
    # and taken at the rank's heads.
    dec = torch.tanh(xw @ use(p["decay_lora_a"], "embed_w", "lora")[0].to(dt))
    dec = dec @ use(p["decay_lora_b"], "lora", "embed_w")[0].to(dt)
    pre = use(p["decay_base"], "embed_w")[0].float() + dec.float()
    pre = sharding.narrow(pre, -1, lo, width, hax)
    log_w = -torch.exp(torch.clamp(pre, -8.0, 1.0))
    w = torch.exp(log_w).reshape(b, s, h, hd)

    u = use(p["bonus"], "rwkv_heads", None)[0].float()     # (H, D)
    state = (cache.wkv if cache is not None else
             torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device))
    if s > 1 and s % WKV_CHUNK == 0:
        out, new_state = _wkv_chunked(r, k, v, w, u, state)
    else:
        out, new_state = _wkv_scan(r, k, v, w, u, state)

    # Per-head group norm, then the gated output projection.
    ln_x = sharding.narrow(use(p["ln_x"], "embed_w")[0], 0, lo, width, hax)
    mean = out.mean(-1, keepdim=True)
    var = (out - mean).square().mean(-1, keepdim=True)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    out = out * (1.0 + ln_x.float().reshape(1, 1, h, hd))
    out = out.reshape(b, s, width).to(dt) * g
    out = logical_constraint(sharding.row_parallel(out, wo, hax), "batch",
                             "res_seq", "embed_act", partial=hax).to(dt)
    new_cache = None
    if cache is not None:
        new_cache = RwkvCache(wkv=new_state, shift=x[:, -1],
                              cmix_shift=cache.cmix_shift)
    return out, new_cache


def channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                cache: Optional[RwkvCache] = None):
    """x: (B, S, d) -> (out (B, S, d), the cache with the new channel-mix
    shift when ``cache`` is given, else None). Under a sharding context
    ``wk`` is column- and ``wv`` row-parallel on the ``ffn`` dims, the sum
    reduced before the receptance gate (``wr`` column-parallel, ``r``
    gathered), and ``out`` laid out as the residual stream."""
    dt = x.dtype
    use = sharding.use
    prev = cache.cmix_shift if cache is not None else None
    xs = _token_shift(x, prev)
    delta = xs - x
    xk = x + use(p["mu_k"], "embed_w")[0].to(dt) * delta
    xr = x + use(p["mu_r"], "embed_w")[0].to(dt) * delta
    wk, (_, fax) = use(p["wk"], "embed_w", "ffn")
    wv, _ = use(p["wv"], "ffn", "embed_w")
    k = torch.square(torch.relu(sharding.enter(xk, fax) @ wk.to(dt)))
    kv = sharding.reduce(sharding.row_parallel(k, wv, fax), fax).to(dt)
    one = torch.tensor(1.0, dtype=dt, device=x.device)
    # jax.nn.sigmoid, op by op in x's dtype as XLA expands it; on the
    # rank's heads, then gathered whole to gate the whole-d sum.
    wr, (_, rax) = use(p["wr"], "embed_w", "rwkv_heads")
    r = one / (one + torch.exp(-(sharding.enter(xr, rax) @ wr.to(dt))))
    r = sharding.gather(r, -1, rax)
    new_cache = None
    if cache is not None:
        new_cache = cache._replace(cmix_shift=x[:, -1])
    out = logical_constraint(r * kv, "batch", "res_seq", "embed_act")
    return out, new_cache
