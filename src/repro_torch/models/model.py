"""LM assembly for every architecture of the repo, forward and decode (port
of ``repro.models.model``): dense ``attn:mlp``, MoE, the Mamba hybrid and
RWKV.

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
    forward(cfg, params, tokens=...)  -> ForwardOut(logits, aux_loss, load)
    init_decode_cache(cfg, batch, L)  -> cache dict
    decode_step(cfg, params, cache, pos, tokens=...) -> (logits, cache)

The decode cache is written in place: the attention blocks' keys and
values at ``pos``, the Mamba blocks' conv window and SSM state, the RWKV
blocks' wkv state and token shifts (the JAX function returns a new cache).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, resolve_device
from . import layers, moe, rwkv, ssm
from .config import ModelConfig
from .params import ParamSpec, stack_specs, torch_dtype, tree_paths


class ForwardOut(NamedTuple):
    logits: torch.Tensor          # (B, S, V)
    aux_loss: torch.Tensor        # scalar: MoE load-balance + z losses (0 if dense)
    expert_load: Optional[torch.Tensor] = None  # (MoE blocks in the pattern, E)


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


def _moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
    pd = cfg.param_dtype
    o_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    s = {
        "norm": ParamSpec((d,), (None,), "zeros", pd),
        "router": ParamSpec((d, e), ("embed_w", "experts"), "normal", pd),
        "wi": ParamSpec((e, d, f), ("experts", "embed_w", None), "normal", pd),
        "wo": ParamSpec((e, f, d), ("experts", None, "embed_w"), f"scaled:{o_scale}", pd),
    }
    if cfg.norm == "layernorm":
        s["norm_b"] = ParamSpec((d,), (None,), "zeros", pd)
    if cfg.gated_mlp:
        s["wg"] = ParamSpec((e, d, f), ("experts", "embed_w", None), "normal", pd)
    return s


def _mamba_specs(cfg: ModelConfig) -> dict:
    d, di, n, w = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    r = cfg.resolved_dt_rank
    pd = cfg.param_dtype
    return {
        "norm": ParamSpec((d,), (None,), "zeros", pd),
        "in_proj": ParamSpec((d, 2 * di), ("embed_w", "ssm_inner"), "normal", pd),
        "conv_w": ParamSpec((di, w), ("ssm_inner", "conv"), "uniform_fan", pd),
        "conv_b": ParamSpec((di,), ("ssm_inner",), "zeros", pd),
        "x_proj": ParamSpec((di, r + 2 * n), ("ssm_inner", None), "normal", pd),
        "dt_proj": ParamSpec((r, di), ("dt_rank", "ssm_inner"), "uniform_fan", pd),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), "mamba_dt_bias", pd),
        "a_log": ParamSpec((di, n), ("ssm_inner", "ssm_state"), "mamba_a_log", pd),
        "d_skip": ParamSpec((di,), ("ssm_inner",), "ones", pd),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed_w"),
                              f"scaled:{0.02 / math.sqrt(2 * cfg.num_layers)}", pd),
    }


def _rwkv_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    pd = cfg.param_dtype
    rank = 32
    return {
        "norm": ParamSpec((d,), (None,), "zeros", pd),
        "mix_base": ParamSpec((rwkv.N_MIX, d), (None, "embed_w"), "const:0.5", pd),
        "mix_lora_a": ParamSpec((d, rank), ("embed_w", "lora"), "normal", pd),
        "mix_lora_b": ParamSpec((rank, rwkv.N_MIX, d), ("lora", None, "embed_w"), "zeros", pd),
        "wr": ParamSpec((d, d), ("embed_w", "rwkv_heads"), "normal", pd),
        "wk": ParamSpec((d, d), ("embed_w", "rwkv_heads"), "normal", pd),
        "wv": ParamSpec((d, d), ("embed_w", "rwkv_heads"), "normal", pd),
        "wg": ParamSpec((d, d), ("embed_w", "rwkv_heads"), "normal", pd),
        "decay_base": ParamSpec((d,), ("embed_w",), "const:-4.0", pd),
        "decay_lora_a": ParamSpec((d, 2 * rank), ("embed_w", "lora"), "normal", pd),
        "decay_lora_b": ParamSpec((2 * rank, d), ("lora", "embed_w"), "zeros", pd),
        "bonus": ParamSpec((h, hd), ("rwkv_heads", None), "normal", pd),
        "ln_x": ParamSpec((d,), ("embed_w",), "zeros", pd),
        "wo": ParamSpec((d, d), ("rwkv_heads", "embed_w"),
                        f"scaled:{0.02 / math.sqrt(2 * cfg.num_layers)}", pd),
    }


def _cmix_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    return {
        "norm": ParamSpec((d,), (None,), "zeros", pd),
        "mu_k": ParamSpec((d,), ("embed_w",), "const:0.5", pd),
        "mu_r": ParamSpec((d,), ("embed_w",), "const:0.5", pd),
        "wk": ParamSpec((d, f), ("embed_w", "ffn"), "normal", pd),
        "wv": ParamSpec((f, d), ("ffn", "embed_w"),
                        f"scaled:{0.02 / math.sqrt(2 * cfg.num_layers)}", pd),
        "wr": ParamSpec((d, d), ("embed_w", "rwkv_heads"), "normal", pd),
    }


_MIXER_SPECS = {"attn": _attn_specs, "mamba": _mamba_specs, "rwkv": _rwkv_specs}
_FFN_SPECS = {"mlp": _mlp_specs, "moe": _moe_specs, "cmix": _cmix_specs}


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
        mixer, _, ffn = entry.partition(":")
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


def _write(cache: dict, new) -> None:
    """Copy a block's new decode state (a NamedTuple) into its cache
    slices, field by field, in place."""
    for name, value in new._asdict().items():
        cache[name].copy_(value)


def _apply_block(cfg: ModelConfig, entry: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[dict], pos):
    """One pattern entry: mixer + ffn, residual around each. Returns ``(x,
    aux, load)``: the block's weighted MoE losses (0 for other FFNs) and
    its expert load (None for other FFNs). A decode cache (this group's
    slices of the block's entries) is written in place."""
    mixer, _, ffn = entry.partition(":")
    if mixer == "attn":
        h = _attn_apply(cfg, p["mixer"], x, positions,
                        cache["attn"] if cache else None, pos)
    elif mixer == "mamba":
        mc = ssm.MambaCache(**cache["mamba"]) if cache else None
        h, new = ssm.mamba_block(cfg, p["mixer"], _pre_norm(cfg, p["mixer"], x),
                                 cache=mc)
        if new is not None:
            _write(cache["mamba"], new)
    else:  # rwkv time-mix
        rc = rwkv.RwkvCache(**cache["rwkv"]) if cache else None
        h, new = rwkv.time_mix(cfg, p["mixer"], _pre_norm(cfg, p["mixer"], x),
                               cache=rc)
        if new is not None:
            _write(cache["rwkv"], new)   # channel-mix reads the new state
    x = x + h

    fp = p["ffn"]
    xn = _pre_norm(cfg, fp, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    load = None
    if ffn == "mlp":
        h = layers.mlp(cfg, fp, xn)
    elif ffn == "moe":
        h, moe_aux = moe.moe_ffn(cfg, fp, xn)
        aux = (moe_aux.load_balance_loss * cfg.router_aux_weight
               + moe_aux.router_z_loss * 1e-3)
        load = moe_aux.expert_load
    else:  # rwkv channel mix
        rc = rwkv.RwkvCache(**cache["rwkv"]) if cache else None
        h, new = rwkv.channel_mix(cfg, fp, xn, cache=rc)
        if new is not None:
            _write(cache["rwkv"], new)
    return x + h, aux, load


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
    cache, if any, is indexed alongside and written in place. Returns ``(x,
    aux, load)``: the MoE losses summed over every block, and the expert
    load of each MoE block of the pattern averaged over the groups (None
    without MoE blocks)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loads = []
    for g in range(cfg.num_groups):
        gp = _index(params["groups"], g)
        gc = _index(cache, g) if cache is not None else None
        group_loads = []
        for i, entry in enumerate(cfg.block_pattern):
            bc = gc[f"b{i}"] if gc is not None else None
            x, a, load = _apply_block(cfg, entry, gp[f"b{i}"], x, positions,
                                      bc, pos)
            aux = aux + a
            if load is not None:
                group_loads.append(load)
        if group_loads:
            loads.append(torch.stack(group_loads))
    load = torch.stack(loads).mean(dim=0) if loads else None
    return x, aux, load


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
    x, aux, load = _run_groups(cfg, params, x, positions, None, None)
    return ForwardOut(logits=_logits(cfg, params, x), aux_loss=aux,
                      expert_load=load)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> dict:
    """Decode cache stacked over groups, on ``device`` (default: the card):
    per attention block the keys and values (B, Hkv, max_len, D) in the
    compute dtype, per Mamba block its conv window and f32 SSM state, per
    RWKV block its f32 wkv state and token shifts; zeros."""
    dev = resolve_device(device)
    g = cfg.num_groups
    hd = cfg.resolved_head_dim
    dtype = torch_dtype(cfg.compute_dtype)

    def stack(state) -> dict:
        return {k: v.expand((g,) + v.shape).contiguous()
                for k, v in state._asdict().items()}

    cache: dict = {}
    for i, entry in enumerate(cfg.block_pattern):
        mixer, _, ffn = entry.partition(":")
        blk: dict = {}
        if mixer == "attn":
            shape = (g, batch, cfg.num_kv_heads, max_len, hd)
            blk["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)}
        elif mixer == "mamba":
            blk["mamba"] = stack(ssm.init_cache(cfg, batch, dev))
        if mixer == "rwkv" or ffn == "cmix":
            blk["rwkv"] = stack(rwkv.init_cache(cfg, batch, dev))
        cache[f"b{i}"] = blk
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict, pos: int,
                tokens=None, embeddings=None) -> tuple[torch.Tensor, dict]:
    """Decode S tokens at cache offset ``pos`` (an int, the same across the
    batch); one token per step is the serving use. With S > 1 the new tokens
    attend to each other both ways, as in the reference (a caveat there, not
    causal chunked prefill).

    Writes this step's keys and values, and the Mamba and RWKV blocks' new
    states, into ``cache`` in place (the JAX function returns a new cache)
    and returns ``(logits (B, S, V), cache)``.
    """
    b, s, dev = _ref_shape(tokens, embeddings)
    pos = int(pos)
    positions = pos + torch.arange(s, device=dev)[None].expand(b, s)
    x = _embed_input(cfg, params, tokens, embeddings)
    x = _run_groups(cfg, params, x, positions, cache, pos)[0]
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
