"""LM assembly for the dense ``attn:mlp`` architectures: the serving path
(port of ``repro.models.model``).

Layers are grouped by ``cfg.block_pattern`` (one group = one pass over the
pattern) and stacked, the group dim first; where the JAX package scans the
groups, the port loops over them. Every block = pre-norm mixer + pre-norm
FFN with residuals. Parameters are a dict of tensors with the JAX tree's
keys and layouts (``wq`` (d, h, k), ``wo`` (h, k, d), ...), so a JAX tree
carries across as it is (``interop.lm_params_from_numpy``); :class:`LM`
holds such a dict for callers that want a module. There is no backward in
the port yet, so ``cfg.remat`` has nothing to do here.

Public API:
    model_specs(cfg)                  -> ParamSpec tree
    forward(cfg, params, tokens=...)  -> ForwardOut(logits, aux)
    init_decode_cache(cfg, batch, L)  -> cache dict
    decode_step(cfg, params, cache, pos, tokens=...) -> (logits, cache)

MoE, Mamba, RWKV and channel-mix blocks are not ported yet: their specs and
blocks raise ``NotImplementedError`` naming ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device
from . import layers
from .config import ModelConfig
from .params import ParamSpec, stack_specs, torch_dtype, tree_paths

UNPORTED = ("{} blocks are not ported yet (ROADMAP queue 1 item 14: the "
            "port serves the dense attn:mlp family)")


class ForwardOut(NamedTuple):
    logits: torch.Tensor          # (B, S, V)
    aux_loss: torch.Tensor        # scalar: 0 (no MoE blocks in the port yet)
    expert_load: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pd = cfg.param_dtype
    o_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    s = {
        "norm": ParamSpec((d,), (None,), "zeros", pd),
        "wq": ParamSpec((d, hq, hd), ("embed_w", "heads", "head_dim"), "normal", pd),
        "wk": ParamSpec((d, hkv, hd), ("embed_w", "kv_heads", "head_dim"), "normal", pd),
        "wv": ParamSpec((d, hkv, hd), ("embed_w", "kv_heads", "head_dim"), "normal", pd),
        "wo": ParamSpec((hq, hd, d), ("heads", "head_dim", "embed_w"), f"scaled:{o_scale}", pd),
    }
    if cfg.norm == "layernorm":
        s["norm_b"] = ParamSpec((d,), (None,), "zeros", pd)
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((hq, hd), ("heads", "head_dim"), "zeros", pd)
        s["bk"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), "zeros", pd)
        s["bv"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), "zeros", pd)
    return s


def _mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    o_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    s = {
        "norm": ParamSpec((d,), (None,), "zeros", pd),
        "wi": ParamSpec((d, f), ("embed_w", "ffn"), "normal", pd),
        "wo": ParamSpec((f, d), ("ffn", "embed_w"), f"scaled:{o_scale}", pd),
    }
    if cfg.norm == "layernorm":
        s["norm_b"] = ParamSpec((d,), (None,), "zeros", pd)
    if cfg.gated_mlp:
        s["wg"] = ParamSpec((d, f), ("embed_w", "ffn"), "normal", pd)
    return s


_MIXER_SPECS = {"attn": _attn_specs}
_FFN_SPECS = {"mlp": _mlp_specs}


def _split(entry: str) -> tuple[str, str]:
    mixer, _, ffn = entry.partition(":")
    for part, ported in ((mixer, _MIXER_SPECS), (ffn, _FFN_SPECS)):
        if part not in ported:
            raise NotImplementedError(UNPORTED.format(part))
    return mixer, ffn


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    pd = cfg.param_dtype
    tree: dict = {}
    if cfg.uses_token_embedding:
        tree["embed"] = ParamSpec((v, d), ("vocab", "embed_w"), "normal", pd)
    else:
        tree["frontend_in"] = ParamSpec((d, d), ("embed_w", None), "normal", pd)
    groups: dict = {}
    for i, entry in enumerate(cfg.block_pattern):
        mixer, ffn = _split(entry)
        block = {"mixer": _MIXER_SPECS[mixer](cfg), "ffn": _FFN_SPECS[ffn](cfg)}
        groups[f"b{i}"] = stack_specs(block, cfg.num_groups)
    tree["groups"] = groups
    tree["final_norm"] = ParamSpec((d,), (None,), "zeros", pd)
    if cfg.norm == "layernorm":
        tree["final_norm_b"] = ParamSpec((d,), (None,), "zeros", pd)
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((d, v), ("embed_w", "vocab"), "normal", pd)
    return tree


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _pre_norm(cfg, p, x):
    return layers.norm(cfg, p["norm"], x, p.get("norm_b"))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") with the weight cast to x's dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict],
                pos: Optional[int]):
    """Self-attention of one layer. With a cache (one group's
    ``{"k", "v"}`` slices, (B, Hkv, L, D)), this step's k and v are written
    into it in place at ``pos`` and attention runs over ``pos + S`` entries."""
    s = x.shape[1]
    hd = cfg.resolved_head_dim
    xn = _pre_norm(cfg, p, x)
    q = _proj(xn, p["wq"])
    k = _proj(xn, p["wk"])
    v = _proj(xn, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    qh = q.transpose(1, 2).contiguous()  # (B,Hq,S,D)
    if cache is None:
        kh = k.transpose(1, 2).contiguous()  # (B,Hkv,S,D)
        vh = v.transpose(1, 2).contiguous()
        if cfg.attn_impl == "flash":
            from ..kernels.flash_attention import flash_attention
            out = flash_attention(qh, kh, vh, cfg.causal, scale,
                                  cfg.seq_chunk_q, cfg.seq_chunk_kv)
        else:
            out = layers.chunked_attention(qh, kh, vh, causal=cfg.causal,
                                           q_chunk=cfg.seq_chunk_q,
                                           kv_chunk=cfg.seq_chunk_kv, scale=scale)
    else:
        kc, vc = cache["k"], cache["v"]
        kc[:, :, pos:pos + s] = k.transpose(1, 2).to(kc.dtype)
        vc[:, :, pos:pos + s] = v.transpose(1, 2).to(vc.dtype)
        # Entries past pos + S are masked in the reference; leaving them out
        # gives the same softmax (their weights are exactly 0).
        out = layers.decode_attention(qh, kc[:, :, :pos + s], vc[:, :, :pos + s],
                                      pos + s, scale=scale)
    out = out.transpose(1, 2)  # (B,S,H,D)
    wo = p["wo"].to(x.dtype)
    return out.flatten(2) @ wo.reshape(-1, wo.shape[-1])


def _apply_block(cfg: ModelConfig, entry: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[dict], pos):
    """One pattern entry: mixer + ffn, residual around each."""
    _split(entry)
    x = x + _attn_apply(cfg, p["mixer"], x, positions,
                        cache["attn"] if cache else None, pos)
    fp = p["ffn"]
    return x + layers.mlp(cfg, fp, _pre_norm(cfg, fp, x))


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------

def _embed_input(cfg: ModelConfig, params: dict, tokens, embeddings):
    dtype = torch_dtype(cfg.compute_dtype)
    if cfg.uses_token_embedding:
        return params["embed"][tokens].to(dtype)
    return embeddings.to(dtype) @ params["frontend_in"].to(dtype)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    xn = layers.norm(cfg, params["final_norm"], x, params.get("final_norm_b"))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return xn @ head.to(x.dtype)


def _index(tree, g: int):
    return {k: _index(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _run_groups(cfg: ModelConfig, params: dict, x: torch.Tensor, positions,
                cache: Optional[dict], pos):
    """A loop over the layer groups (the JAX package's ``lax.scan``); a
    cache, if any, is indexed alongside and written in place."""
    for g in range(cfg.num_groups):
        gp = _index(params["groups"], g)
        gc = _index(cache, g) if cache is not None else None
        for i, entry in enumerate(cfg.block_pattern):
            bc = gc[f"b{i}"] if gc is not None else None
            x = _apply_block(cfg, entry, gp[f"b{i}"], x, positions, bc, pos)
    return x


def _ref_shape(tokens, embeddings):
    ref = tokens if tokens is not None else embeddings
    return ref.shape[0], ref.shape[1], ref.device


@torch.no_grad()
def forward(cfg: ModelConfig, params: dict, tokens=None, embeddings=None,
            positions=None) -> ForwardOut:
    """Full-sequence forward (prefill / scoring). No cache. ``tokens``
    (B, S) int or ``embeddings`` (B, S, d_model) on the parameters' device."""
    b, s, dev = _ref_shape(tokens, embeddings)
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    x = _embed_input(cfg, params, tokens, embeddings)
    x = _run_groups(cfg, params, x, positions, None, None)
    return ForwardOut(logits=_logits(cfg, params, x),
                      aux_loss=torch.zeros((), device=dev))


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> dict:
    """KV cache stacked over groups, zeros in the compute dtype, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    dtype = torch_dtype(cfg.compute_dtype)
    cache: dict = {}
    for i, entry in enumerate(cfg.block_pattern):
        _split(entry)
        shape = (cfg.num_groups, batch, cfg.num_kv_heads, max_len, hd)
        cache[f"b{i}"] = {"attn": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}}
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict, pos: int,
                tokens=None, embeddings=None) -> tuple[torch.Tensor, dict]:
    """Decode S tokens at cache offset ``pos`` (an int, the same across the
    batch); one token per step is the serving use. With S > 1 the new tokens
    attend to each other both ways, as in the reference (a caveat there, not
    causal chunked prefill).

    Writes this step's keys and values into ``cache`` in place (the JAX
    function returns a new cache) and returns ``(logits (B, S, V), cache)``.
    """
    b, s, dev = _ref_shape(tokens, embeddings)
    pos = int(pos)
    positions = pos + torch.arange(s, device=dev)[None].expand(b, s)
    x = _embed_input(cfg, params, tokens, embeddings)
    x = _run_groups(cfg, params, x, positions, cache, pos)
    return _logits(cfg, params, x), cache


class LM(torch.nn.Module):
    """A thin module around the parameter dict: each leaf is a buffer named
    by its path ("groups.b0.mixer.wq" with dots as "__"), ``params`` gives
    the dict back, and the methods call the functions above."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for path, t in tree_paths(params):
            name = "__".join(path)
            self.register_buffer(name, t)
            self._paths.append((path, name))

    @property
    def params(self) -> dict:
        out: dict = {}
        for path, name in self._paths:
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = getattr(self, name)
        return out

    def forward(self, tokens=None, embeddings=None, positions=None) -> ForwardOut:
        return forward(self.cfg, self.params, tokens=tokens,
                       embeddings=embeddings, positions=positions)

    def init_decode_cache(self, batch: int, max_len: int) -> dict:
        dev = next(iter(self.buffers())).device
        return init_decode_cache(self.cfg, batch, max_len, device=dev)

    def decode_step(self, cache: dict, pos: int, tokens=None, embeddings=None):
        return decode_step(self.cfg, self.params, cache, pos, tokens=tokens,
                           embeddings=embeddings)
