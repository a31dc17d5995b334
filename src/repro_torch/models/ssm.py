"""Mamba selective-SSM block (for the Jamba hybrid; Gu & Dao 2023). Port of
``repro.models.ssm``.

Recurrence: h_t = Ā_t h_{t-1} + B̄_t x_t, y_t = C_t h_t + D x_t with
Ā_t = exp(Δ_t A), B̄_t = Δ_t B_t and input-dependent Δ, B, C. The prefill
is a chunked scan: within a chunk the (B, T, d_inner, N) tensors are made
at once from cumulative products, across chunks a (B, d_inner, N) state is
carried by a Python loop (the JAX package's ``lax.scan``).

Decode carries ``(conv (B, d_inner, W−1), ssm (B, d_inner, N))``, O(1) a
token. The port's model writes these states into its decode cache in place
(``models.model.decode_step``); :func:`mamba_block` itself returns the new
state, as the JAX function does.

Under a sharding context (``models.sharding``) the block runs on the
rank's ``ssm_inner`` channels: ``in_proj`` column-parallel on its block of
each half (x and z), the conv, the scan and the skip per channel,
``x_proj``'s partial sum reduced before the split into Δ, B and C,
``dt_proj`` column- and ``out_proj`` row-parallel; the decode state holds
the rank's channels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..roofline.op_cost import named_scope
from . import sharding
from .config import ModelConfig
from .layers import silu
from .params import torch_dtype
from .sharding import logical_constraint

#: Largest |Σ log a| a chunk's cumulative product may span. The scan
#: writes h_t = p_t·(h_0 + Σ_τ u_τ / p_τ) with p_t = exp(Σ_{s≤t} log a_s),
#: and 1/p_τ overflows f32 past exp(88.7): the JAX function then returns
#: NaN (0·inf), which jamba's own initialisation reaches at its 256-step
#: chunk (Δ·|A| up to ~1.6 a step). The port then scans the whole call in
#: shorter pieces (the chunk halved while it is even, else single steps),
#: the longest that keep every piece within this span, chosen by one host
#: read a call; where no chunk passes it, the arithmetic is the JAX
#: function's.
SCAN_LOG_SPAN = 80.0


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_inner, W-1), compute dtype
    ssm: torch.Tensor   # (B, d_inner, N) float32


def init_cache(cfg: ModelConfig, batch: int,
               device: DeviceLike = None) -> MambaCache:
    """A zero decode state for ``batch`` sequences on ``device`` (None:
    the card, raising when there is none)."""
    device = resolve_device(device)
    di, n, w = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    dtype = torch_dtype(cfg.compute_dtype)
    return MambaCache(
        conv=torch.zeros((batch, di, w - 1), dtype=dtype, device=device),
        ssm=torch.zeros((batch, di, n), dtype=torch.float32, device=device))


def _scan_chunk(log_a: torch.Tensor, u: torch.Tensor, h_in: torch.Tensor):
    """One piece, log a and u (B, T, d, N) f32: the JAX ``per_chunk``.
    Returns (h (B, T, d, N), h_last)."""
    cum = torch.cumsum(log_a, dim=1)
    p = torch.exp(cum)
    acc = torch.cumsum(u * torch.exp(-cum), dim=1)
    h = p * (h_in[:, None] + acc)
    return h, h[:, -1]


def _piece_len(log_a: torch.Tensor, chunk: int, axes=()) -> int:
    """The longest of chunk, chunk/2, … (while even), then 1, over which
    no piece's Σ log a passes −:data:`SCAN_LOG_SPAN` (one host read). On
    channels split over ``axes`` the spans are the minimum over the ranks,
    so that every rank scans in the whole block's pieces. A meta tensor has
    no value to read: it takes ``chunk``."""
    b, s, d, n = log_a.shape
    if chunk == 1 or log_a.is_meta:
        return chunk
    lengths = [chunk]
    while lengths[-1] % 2 == 0:
        lengths.append(lengths[-1] // 2)
    if lengths[-1] > 1:
        lengths.append(1)
    spans = torch.stack([log_a.reshape(b, s // k, k, d, n).sum(2).amin()
                         for k in lengths[:-1]])
    spans = -sharding.all_max(-spans, axes)
    fits = (spans >= -SCAN_LOG_SPAN).tolist()
    return next((k for k, ok in zip(lengths, fits) if ok), 1)


def _ssm_scan_chunked(a_disc: torch.Tensor, bx: torch.Tensor, chunk: int,
                      h0: Optional[torch.Tensor] = None, axes=()):
    """h_t = a_t · h_{t−1} + bx_t over the sequence axis 1.

    a_disc, bx: (B, S, d, N), the channels d split over ``axes``. Returns h
    (B, S, d, N) float32 and h_last. Raises unless S is a multiple of
    ``min(chunk, S)``."""
    b, s, d, n = a_disc.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssm_chunk {chunk}")
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=a_disc.device)
         if h0 is None else h0.float())
    log_a = torch.log(torch.clamp(a_disc.float(), min=1e-37))
    piece = _piece_len(log_a, chunk, axes)
    outs = []
    for c0 in range(0, s, piece):
        hs, h = _scan_chunk(log_a[:, c0:c0 + piece],
                            bx[:, c0:c0 + piece].float(), h)
        outs.append(hs)
    return torch.cat(outs, dim=1), h


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv along the sequence. x: (B, S, d); w: (d, W).
    Returns y (B, S, d) and the trailing (B, d, W−1) window for decode."""
    b, s, d = x.shape
    width = w.shape[-1]
    xt = x.transpose(1, 2)  # (B, d, S)
    if prev is None:
        prev = torch.zeros((b, d, width - 1), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), xt], dim=-1)  # (B, d, S+W-1)
    windows = xp.unfold(-1, width, 1)               # (B, d, S, W)
    y = torch.einsum("bdsw,dw->bds", windows, w.to(x.dtype))
    new_state = xp[:, :, xp.shape[-1] - (width - 1):]
    return y.transpose(1, 2), new_state


def _in_proj(w: torch.Tensor, di: int, axes) -> torch.Tensor:
    """``in_proj`` (d, 2·di) in its compute layout: whole without a split,
    else this rank's block of each half, [x block, z block]. Its storage
    block is a slice of the concatenated [x; z], so it is gathered first."""
    w, _ = sharding.use(w, "embed_w", None)
    if not axes:
        return w
    n = di // sharding.axes_size(sharding.current()[0], axes)
    halves = sharding.narrow(w.unflatten(1, (2, di)), 2,
                             sharding.block_offset(di, axes), n, axes)
    return halves.flatten(1)


@named_scope("mamba_block")
def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                cache: Optional[MambaCache] = None):
    """x: (B, S, d_model) -> (out (B, S, d_model), the new cache when
    ``cache`` is given (decode), else None). Under a sharding context on
    the rank's ``ssm_inner`` channels (the cache holds them too); ``out``
    is then reduced and laid out as the residual stream."""
    s = x.shape[1]
    n = cfg.ssm_state_dim
    r = cfg.resolved_dt_rank
    decode = cache is not None
    dt_ = x.dtype

    conv_w, (iax, _) = sharding.use(p["conv_w"], "ssm_inner", "conv")
    xz = sharding.enter(x, iax) @ _in_proj(p["in_proj"], cfg.d_inner,
                                            iax).to(dt_)
    xin, z = xz.chunk(2, dim=-1)
    y_conv, conv_state = _causal_conv(xin, conv_w,
                                      prev=cache.conv if decode else None)
    xin = silu(y_conv + sharding.use(p["conv_b"], "ssm_inner")[0].to(dt_))

    # x_proj contracts over the channels: its partial sum is reduced, and
    # Δ, B and C enter the channel-parallel region whole.
    x_proj, _ = sharding.use(p["x_proj"], "ssm_inner", None)
    dbc = sharding.reduce(sharding.row_parallel(xin, x_proj, iax), iax)
    dbc = sharding.enter(dbc.to(dt_), iax)
    dt, bmat, cmat = torch.split(dbc, [r, n, n], dim=-1)
    dt = dt @ sharding.use(p["dt_proj"], "dt_rank", "ssm_inner")[0].to(dt_)
    dt = F.softplus(dt.float()
                    + sharding.use(p["dt_bias"], "ssm_inner")[0].float())
    a = -torch.exp(sharding.use(p["a_log"], "ssm_inner",
                                "ssm_state")[0].float())   # (di, N)
    a_disc = torch.exp(dt[..., None] * a)              # (B, S, di, N)
    bx = (dt[..., None] * bmat.float()[:, :, None, :]
          * xin.float()[..., None])

    if decode and s == 1:
        h = cache.ssm * a_disc[:, 0] + bx[:, 0]       # (B, di, N)
        y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].float())[:, None]
        new_ssm = h
    else:
        hs, h_last = _ssm_scan_chunked(a_disc, bx, cfg.ssm_chunk,
                                       h0=cache.ssm if decode else None,
                                       axes=iax)
        y = torch.einsum("bsdn,bsn->bsd", hs, cmat.float())
        new_ssm = h_last

    y = y + xin.float() * sharding.use(p["d_skip"], "ssm_inner")[0].float()
    y = y.to(dt_) * silu(z)
    out_proj, _ = sharding.use(p["out_proj"], "ssm_inner", "embed_w")
    out = sharding.row_parallel(y, out_proj, iax)
    out = logical_constraint(out, "batch", "res_seq", "embed_act",
                             partial=iax).to(dt_)
    if decode:
        return out, MambaCache(conv=conv_state, ssm=new_ssm)
    return out, None
