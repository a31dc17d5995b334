"""LM assembly for every architecture of the repo, forward and decode (port
of ``repro.models.model``): dense ``attn:mlp``, MoE, the Mamba hybrid and
RWKV.

Layers are grouped by ``cfg.block_pattern`` (one group = one pass over the
pattern) and stacked, the group dim first; where the JAX package scans the
groups, the port loops over them. Every block = pre-norm mixer + pre-norm
FFN with residuals. Parameters are a dict of tensors with the JAX tree's
keys and layouts (``wq`` (d, h, k), ``wo`` (h, k, d), ...), so a JAX tree
carries across as it is (``interop.lm_params_from_numpy``); :class:`LM`
holds such a dict for callers that want a module.

:func:`forward` is differentiable in the parameters (the train step takes
its gradients); parameters that do not require grad build no graph, so
serving keeps its memory. With a graph, each layer group is checkpointed
as ``cfg.remat`` says, as the JAX package wraps its scanned group:
``"full"`` recomputes the whole group in the backward, ``"dots"`` saves
the outputs of the dots without batch dims (``aten.mm``/``addmm``: the
projections and the router) and recomputes the rest, kernel E's forward
included (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).
The recompute runs the same ops on the same inputs, so the gradients are
bitwise those without remat.

Public API:
    model_specs(cfg)                  -> ParamSpec tree
    forward(cfg, params, tokens=...)  -> ForwardOut(logits, aux_loss, load)
    init_decode_cache(cfg, batch, L)  -> cache dict
    decode_step(cfg, params, cache, pos, tokens=...) -> (logits, cache)

The decode cache is written in place: the attention blocks' keys and
values at ``pos``, the Mamba blocks' conv window and SSM state, the RWKV
blocks' wkv state and token shifts (the JAX function returns a new cache).

Under ``sharding.use_sharding(mesh, rules)`` every rank runs the same call
on its blocks of the parameters (``params.shard_params``) and takes its
rows of the global batch; the JAX package's ``logical_constraint`` sites
are where the port's collectives go (``models.sharding``). Attention is
head-parallel (each rank runs kernel E on its query heads and the key and
value heads of their groups), the MLP column- then row-parallel, the MoE
expert-parallel, the embedding and the logits vocab-parallel, and a
decode cache may be split on its length (``cache_seq``): the attention
then combines the ranks' partial softmaxes, as flash-decoding does. The
Mamba block runs on the rank's ``ssm_inner`` channels and the RWKV time
and channel mixes on its ``rwkv_heads`` and ``ffn`` dims, their decode
states split alike. The residual stream may be split on its sequence
(``res_seq``, Megatron-style sequence parallelism) or its ``d``
(``embed_act``): each block's output is reduced and cut to the rank's
block, the residual adds run on the blocks, and each sublayer's entry
gathers the stream whole before its norm, so the arithmetic is the same
mesh's without the rule, bit for bit. The small weight dims (``layers``,
``head_dim``, ``ssm_state``, ...) are storage layouts, gathered whole for
compute. The forward returns the rank's block of the logits under
``("batch", "seq", "vocab")`` (its batch rows and its vocab block or, with
``seq`` split, its sequence block), marked with its sharding.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, meta_allowed, resolve_device
from ..roofline.op_cost import named_scope
from . import layers, moe, rwkv, sharding, ssm
from .config import ModelConfig
from .params import (ParamSpec, build_tree, stack_specs, torch_dtype,
                     tree_paths)
from .sharding import logical_constraint


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


def _group_kv(t: torch.Tensor, dim: int, q_lo: int, hq: int, rep: int,
              axes) -> torch.Tensor:
    """The key or value heads (dim ``dim`` of ``t``, every kv head) of the
    query heads [q_lo, q_lo + hq): the covering kv heads, one per query
    head where the local groups are uneven."""
    lo, hi = q_lo // rep, (q_lo + hq - 1) // rep + 1
    t = sharding.narrow(t, dim, lo, hi - lo, axes)
    want = [(q_lo + j) // rep - lo for j in range(hq)]
    if hq % (hi - lo) == 0 and want == [j // (hq // (hi - lo))
                                        for j in range(hq)]:
        return t
    return t.index_select(dim, torch.tensor(want, device=t.device))


def _seq_sharded_attention(q, k, v, kc, vc, pos: int, scale: float, cax):
    """Decode attention over a cache split on its length over ``cax``:
    every query head against this rank's positions, the ranks' softmaxes
    combined by an all-reduce of the max and then of the exp-sums and
    weighted values (flash-decoding). q: (B, Hq, S, D); k/v: this step's
    (B, S, Hkv, D); kc/vc: (B, Hkv, Lc, D) written in place at the global
    positions [pos, pos + S) they hold."""
    mesh = sharding.current()[0]
    b, hq, s, d = q.shape
    hkv, lc = kc.shape[1], kc.shape[2]
    c_lo = sharding.block_offset(lc * sharding.axes_size(mesh, cax), cax)
    a, e = max(pos, c_lo), min(pos + s, c_lo + lc)
    if a < e:
        kc[:, :, a - c_lo:e - c_lo] = k[:, a - pos:e - pos].transpose(1, 2).to(kc.dtype)
        vc[:, :, a - c_lo:e - c_lo] = v[:, a - pos:e - pos].transpose(1, 2).to(vc.dtype)
    qg = (q * layers._const(q, scale)).reshape(b, hkv, hq // hkv, s, d)
    sc = torch.einsum("bkrqd,bkld->bkrql", qg.float(), kc.float())
    mask = c_lo + torch.arange(lc, device=q.device) < pos + s
    sc = torch.where(mask, sc, layers.NEG_INF)
    m = sharding.all_max(sc.amax(dim=-1), cax)
    p = torch.exp(sc - m[..., None])
    l = sharding.reduce(p.sum(dim=-1), cax)
    acc = sharding.reduce(torch.einsum("bkrql,bkld->bkrqd",
                                       p.to(vc.dtype).float(), vc.float()),
                          cax)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, s, d).to(kc.dtype)


def _attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict],
                pos: Optional[int]):
    """Self-attention of one layer. With a cache (one group's
    ``{"k", "v"}`` slices, (B, Hkv, L, D)), this step's k and v are written
    into it in place at ``pos`` and attention runs over ``pos + S`` entries.
    Under a sharding context on this rank's blocks: query heads split over
    the ``heads`` dims, each rank's q heads with the kv heads of their
    groups (split alike where ``kv_heads`` divides, else taken from every
    kv head), ``wo`` row-parallel and its partial sum reduced."""
    s = x.shape[1]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = hq // hkv
    xn = _pre_norm(cfg, p, x)
    wq, (_, hax, _) = sharding.use(p["wq"], "embed_w", "heads", "head_dim")
    wk, (_, kax, _) = sharding.use(p["wk"], "embed_w", "kv_heads", "head_dim")
    wv, _ = sharding.use(p["wv"], "embed_w", "kv_heads", "head_dim")
    wo, (oax, _, _) = sharding.use(p["wo"], "heads", "head_dim", "embed_w")
    if oax != hax or (kax and kax != hax):
        raise NotImplementedError(
            f"attention with q heads on {hax}, kv heads on {kax} and wo on "
            f"{oax}: the port splits them over one set of mesh dims")
    xq = sharding.enter(xn, hax)
    xk = xq if kax else xn
    q, k, v = _proj(xq, wq), _proj(xk, wk), _proj(xk, wv)
    if cfg.qkv_bias:
        q = q + sharding.use(p["bq"], "heads", "head_dim")[0].to(x.dtype)
        k = k + sharding.use(p["bk"], "kv_heads", "head_dim")[0].to(x.dtype)
        v = v + sharding.use(p["bv"], "kv_heads", "head_dim")[0].to(x.dtype)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    q = logical_constraint(q, "batch", "seq", "heads", None,
                           layout=((), (), hax, ()))
    k = logical_constraint(k, "batch", "seq", "kv_heads", None,
                           layout=((), (), kax, ()))
    scale = 1.0 / math.sqrt(hd)
    hq_l = q.shape[2]
    q_lo = sharding.block_offset(hq, hax)
    grouped = bool(hax) and not kax     # every kv head here, q heads split
    if cache is None:
        if grouped:
            k = _group_kv(k, 2, q_lo, hq_l, rep, hax)
            v = _group_kv(v, 2, q_lo, hq_l, rep, hax)
        qh = q.transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).contiguous()
        vh = v.transpose(1, 2).contiguous()
        if cfg.attn_impl == "flash":
            from ..kernels.flash_attention import flash_attention
            out = flash_attention(qh, kh, vh, cfg.causal, scale,
                                  cfg.seq_chunk_q, cfg.seq_chunk_kv)
        else:
            out = layers.chunked_attention(qh, kh, vh, causal=cfg.causal,
                                           q_chunk=cfg.seq_chunk_q,
                                           kv_chunk=cfg.seq_chunk_kv,
                                           scale=scale)
    else:
        kc, vc = cache["k"], cache["v"]
        cl = sharding.layout(kc)
        for c in (kc, vc):   # written in place: its layout must be the rules'
            if logical_constraint(c, "batch", "kv_heads", "cache_seq", None,
                                  layout=cl) is not c:
                raise ValueError(
                    f"a decode cache split over {cl} under rules that split "
                    "it otherwise; make it with init_decode_cache under the "
                    "same use_sharding")
        if cl[2]:
            if cl[1]:
                raise NotImplementedError(
                    "a decode cache split on both its kv heads and its "
                    "length (set kv_heads=None with cache_seq)")
            qa = sharding.gather(q, 2, hax).transpose(1, 2)
            out = _seq_sharded_attention(
                qa, sharding.gather(k, 2, kax), sharding.gather(v, 2, kax),
                kc, vc, pos, scale, cl[2])
            out = out.narrow(1, q_lo, hq_l)
        else:
            if cl[1] != kax:
                raise ValueError(f"the cache's kv heads are split over "
                                 f"{cl[1]}, the keys over {kax}")
            kc[:, :, pos:pos + s] = k.transpose(1, 2).to(kc.dtype)
            vc[:, :, pos:pos + s] = v.transpose(1, 2).to(vc.dtype)
            # Entries past pos + S are masked in the reference; leaving them
            # out gives the same softmax (their weights are exactly 0).
            kc, vc = kc[:, :, :pos + s], vc[:, :, :pos + s]
            if grouped:
                kc = _group_kv(kc, 1, q_lo, hq_l, rep, ())
                vc = _group_kv(vc, 1, q_lo, hq_l, rep, ())
            out = layers.decode_attention(q.transpose(1, 2).contiguous(), kc,
                                          vc, pos + s, scale=scale)
    out = out.transpose(1, 2)  # (B,S,H,D)
    proj = sharding.row_parallel(out.flatten(2), wo.reshape(-1, wo.shape[-1]),
                                 hax)
    return logical_constraint(proj, "batch", "res_seq", "embed_act",
                              partial=hax).to(x.dtype)


def _write(cache: dict, new) -> None:
    """Copy a block's new decode state (a NamedTuple) into its cache
    slices, field by field, in place."""
    for name, value in new._asdict().items():
        cache[name].copy_(value)


def _apply_block(cfg: ModelConfig, entry: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: Optional[dict], pos,
                 res: tuple = ((), (), ())):
    """One pattern entry: mixer + ffn, residual around each. ``x`` is the
    residual stream laid out as ``res`` (:func:`sharding.residual_layout`),
    gathered whole at each sublayer's entry. Returns ``(x, aux, load)``:
    the block's weighted MoE losses (0 for other FFNs) and its expert load
    (None for other FFNs). A decode cache (this group's slices of the
    block's entries) is written in place."""
    mixer, _, ffn = entry.partition(":")
    xw = sharding.whole(x, res)
    if mixer == "attn":
        h = _attn_apply(cfg, p["mixer"], xw, positions,
                        cache["attn"] if cache else None, pos)
    elif mixer == "mamba":
        mc = ssm.MambaCache(**cache["mamba"]) if cache else None
        h, new = ssm.mamba_block(cfg, p["mixer"],
                                 _pre_norm(cfg, p["mixer"], xw), cache=mc)
        if new is not None:
            _write(cache["mamba"], new)
    else:  # rwkv time-mix
        rc = rwkv.RwkvCache(**cache["rwkv"]) if cache else None
        h, new = rwkv.time_mix(cfg, p["mixer"], _pre_norm(cfg, p["mixer"], xw),
                               cache=rc)
        if new is not None:
            _write(cache["rwkv"], new)   # channel-mix reads the new state
    x = x + h

    fp = p["ffn"]
    xn = _pre_norm(cfg, fp, sharding.whole(x, res))
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
    """The embedding of this rank's rows. Under a sharding context with
    the table split on its vocab: a masked lookup of the rank's rows and a
    sum over the vocab dims (every token found once; the sum exact)."""
    dtype = torch_dtype(cfg.compute_dtype)
    if not cfg.uses_token_embedding:
        w, _ = sharding.use(params["frontend_in"], "embed_w", None)
        x = embeddings.to(dtype) @ w.to(dtype)
        return logical_constraint(x, "batch", "res_seq", "embed_act")
    table, (vax, _) = sharding.use(params["embed"], "vocab", "embed_w")
    if not vax:
        rows = table[tokens]
    else:
        n = table.shape[0]
        local = tokens - sharding.block_offset(cfg.vocab_size, vax)
        inside = (local >= 0) & (local < n)
        rows = table[torch.where(inside, local, 0)]
        rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    x = logical_constraint(rows, "batch", "res_seq", "embed_act",
                           partial=vax)
    return x.to(dtype)


@named_scope("_logits")
def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The logits of the whole residual stream ``x``. Under a sharding
    context vocab-parallel, then laid out as ``("batch", "seq", "vocab")``
    says: each rank's block of its rows, marked with that sharding (a dim
    the rules' dims do not divide whole)."""
    xn = layers.norm(cfg, params["final_norm"], x, params.get("final_norm_b"))
    if cfg.tie_embeddings:
        table, (vax, _) = sharding.use(params["embed"], "vocab", "embed_w")
        head = table.T
    else:
        head, (_, vax) = sharding.use(params["lm_head"], "embed_w", "vocab")
    logits = sharding.enter(xn, vax) @ head.to(xn.dtype)
    names = ("batch", "seq", "vocab")
    logits = logical_constraint(logits, *names, layout=((), (), vax),
                                output=True)
    if sharding.current() is None:
        return logits
    mesh, rules = sharding.current()
    spec = sharding.make_sharding(
        names, shape=(1, xn.shape[1], cfg.vocab_size)).spec
    return sharding.with_sharding(logits, sharding.NamedSharding(
        mesh, sharding.PartitionSpec(
            sharding.batch_axes(mesh, rules) or None,
            *(sharding.live(mesh, sharding.entry_axes(e)) or None
              for e in spec[1:]))))


def _part(t: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """``part`` (one layer group of the stacked ``t``) with t's sharding
    less its group dim, if t has one."""
    s = sharding.sharding_of(t)
    return part if s is None else sharding.with_sharding(part,
                                                         s.drop_leading())


def _index(tree, g: int):
    return {k: _index(v, g) if isinstance(v, dict) else _part(v, v[g])
            for k, v in tree.items()}


def _split_groups(tree: dict, n: int) -> list:
    """The per-group dicts of a stacked tree: one ``torch.unbind`` per
    leaf, whose backward stacks the groups' gradients once (a ``select``
    per group would write a zero tensor of the whole leaf per group). A
    leaf stored split on its group dim (``layers``) is gathered whole
    first."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        if isinstance(v, dict):
            parts = _split_groups(v, n)
        else:
            s = sharding.sharding_of(v)
            if s is not None and sharding.live(s.mesh, s.axes(0)):
                v = sharding.with_sharding(
                    sharding.gather(v, 0, s.axes(0), s.mesh),
                    s.with_entry(0, None))
            parts = [_part(v, t) for t in torch.unbind(v, 0)]
        for g in range(n):
            out[g][k] = parts[g]
    return out


#: Ops whose outputs ``remat="dots"`` saves: dots without batch dims.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` checkpointed as ``cfg.remat`` says (non-reentrant). A
    sharded group's recompute runs under the sharding context of its
    forward: on the card the backward runs on autograd's device thread,
    where the caller's context variable is not set."""
    if cfg.remat != "none" and sharding.current() is not None:
        fn = _in_context(fn, sharding.current())
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_context)
    if cfg.remat != "none":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


def _in_context(fn, ctx):
    def run(*args):
        with sharding.use_sharding(*ctx):
            return fn(*args)
    return run


def _requires_grad(tree: dict) -> bool:
    return any(v.requires_grad for _, v in tree_paths(tree))


def _run_groups(cfg: ModelConfig, params: dict, x: torch.Tensor, positions,
                cache: Optional[dict], pos, res: tuple = ((), (), ())):
    """A loop over the layer groups (the JAX package's ``lax.scan``); a
    cache, if any, is indexed alongside and written in place. ``x`` is the
    residual stream laid out as ``res``. Returns ``(x, aux, load)``: the
    MoE losses summed over every block, and the expert load of each MoE
    block of the pattern averaged over the groups (None without MoE
    blocks). Under autograd each group is checkpointed as ``cfg.remat``
    says."""

    def group_fn(x, aux, gp, gc):
        group_loads = []
        for i, entry in enumerate(cfg.block_pattern):
            bc = gc[f"b{i}"] if gc is not None else None
            x, a, load = _apply_block(cfg, entry, gp[f"b{i}"], x, positions,
                                      bc, pos, res)
            aux = aux + a
            if load is not None:
                group_loads.append(load)
        return x, aux, torch.stack(group_loads) if group_loads else None

    grad = (cache is None and torch.is_grad_enabled()
            and _requires_grad(params["groups"]))
    run = _remat_wrap(cfg, group_fn) if grad else group_fn
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loads = []
    work, stored = cache, []
    if cache is not None and sharding.current() is not None:
        work, stored = _compute_cache(cache)
    for g, gp in enumerate(_split_groups(params["groups"], cfg.num_groups)):
        gc = _index(work, g) if work is not None else None
        x, aux, load = run(x, aux, gp, gc)
        if load is not None:
            loads.append(load)
    for dst, src in stored:       # the storage blocks of the cache, in place
        dst.copy_(sharding.reshard(src, sharding.sharding_of(dst)))
    load = torch.stack(loads).mean(dim=0) if loads else None
    return x, aux, load


def _local_rows(params: dict, *batch):
    """Under a sharding context, this rank's rows of each global batch
    tensor (None stays None), after checking the rules and that the mesh's
    device type is the parameters' (within ``device.meta_device``, the dry
    run's, meta parameters run on any mesh)."""
    ctx = sharding.current()
    if ctx is None:
        return batch
    mesh, rules = ctx
    sharding.check_rules(mesh, rules)
    leaf = next(t for _, t in tree_paths(params))
    if mesh.device_type != leaf.device.type and not (leaf.is_meta
                                                     and meta_allowed()):
        raise ValueError(
            f"the mesh's device type is {mesh.device_type!r} but the "
            f"parameters are on {leaf.device}; build the mesh and the "
            "model on one device type (no fallback)")
    return tuple(None if t is None else sharding.local_batch(t)
                 for t in batch)


def _ref_shape(tokens, embeddings):
    ref = tokens if tokens is not None else embeddings
    return ref.shape[0], ref.shape[1], ref.device


def forward(cfg: ModelConfig, params: dict, tokens=None, embeddings=None,
            positions=None) -> ForwardOut:
    """Full-sequence forward (train / prefill / scoring). No cache.
    ``tokens`` (B, S) int or ``embeddings`` (B, S, d_model) on the
    parameters' device. Differentiable in the parameters that require
    grad."""
    tokens, embeddings, positions = _local_rows(params, tokens, embeddings,
                                                positions)
    b, s, dev = _ref_shape(tokens, embeddings)
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    res = sharding.residual_layout(s, cfg.d_model)
    x = _embed_input(cfg, params, tokens, embeddings)
    x, aux, load = _run_groups(cfg, params, x, positions, None, None, res)
    return ForwardOut(logits=_logits(cfg, params, sharding.whole(x, res)),
                      aux_loss=aux, expert_load=load)


#: The logical axes of each decode-cache leaf (the JAX package's
#: ``launch.abstracts._CACHE_AXES``); any other leaf is ``("layers",
#: "batch", None, ...)``.
CACHE_AXES = {
    ("attn", "k"): ("layers", "batch", "kv_heads", "cache_seq", None),
    ("attn", "v"): ("layers", "batch", "kv_heads", "cache_seq", None),
    ("mamba", "conv"): ("layers", "batch", "ssm_inner", None),
    ("mamba", "ssm"): ("layers", "batch", "ssm_inner", "ssm_state"),
    ("rwkv", "wkv"): ("layers", "batch", "rwkv_heads", None, None),
    ("rwkv", "shift"): ("layers", "batch", None),
    ("rwkv", "cmix_shift"): ("layers", "batch", None),
}


def cache_axes(kind: str, field: str, ndim: int) -> tuple:
    return CACHE_AXES.get((kind, field),
                          ("layers", "batch") + (None,) * (ndim - 2))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache's leaves as :class:`ParamSpec` (global shape, logical
    axes, dtype), stacked over the groups: per attention block the keys and
    values (B, Hkv, max_len, D) in the compute dtype, per Mamba block its
    conv window and f32 SSM state, per RWKV block its f32 wkv state and
    token shifts."""
    g, hd = cfg.num_groups, cfg.resolved_head_dim
    cdt = cfg.compute_dtype
    di, n, w = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    d = cfg.d_model
    rh = cfg.rwkv_head_dim
    shapes = {
        "attn": {"k": ((batch, cfg.num_kv_heads, max_len, hd), cdt),
                 "v": ((batch, cfg.num_kv_heads, max_len, hd), cdt)},
        "mamba": {"conv": ((batch, di, w - 1), cdt),
                  "ssm": ((batch, di, n), "float32")},
        "rwkv": {"wkv": ((batch, d // rh if rh else 0, rh, rh), "float32"),
                 "shift": ((batch, d), cdt),
                 "cmix_shift": ((batch, d), cdt)},
    }
    tree: dict = {}
    for i, entry in enumerate(cfg.block_pattern):
        mixer, _, ffn = entry.partition(":")
        kinds = [mixer] if mixer in ("attn", "mamba") else []
        if mixer == "rwkv" or ffn == "cmix":
            kinds.append("rwkv")
        tree[f"b{i}"] = {
            kind: {f: ParamSpec((g,) + shape,
                                cache_axes(kind, f, len(shape) + 1), "zeros",
                                dt)
                   for f, (shape, dt) in shapes[kind].items()}
            for kind in kinds}
    return tree


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = None) -> dict:
    """Decode cache stacked over groups (:func:`cache_specs`), zeros on
    ``device`` (default: the card). Under a sharding context each leaf is
    this rank's block of it under its logical axes (a dim the rules' dims
    do not divide left whole)."""
    dev = resolve_device(device)
    ctx = sharding.current()

    def leaf(_, spec: ParamSpec) -> torch.Tensor:
        dtype = torch_dtype(spec.dtype)
        if ctx is None:
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        sh = sharding.make_sharding(spec.axes, shape=spec.shape)
        if sh.axes(1) != sharding.batch_axes(sh.mesh, ctx[1]):
            raise ValueError(f"a decode batch of {batch} does not split over "
                             "the batch dims")
        return sharding.with_sharding(
            torch.zeros(sh.shard_shape(spec.shape), dtype=dtype, device=dev),
            sh)

    return build_tree(cache_specs(cfg, batch, max_len), leaf)


def _compute_cache(cache: dict):
    """The cache's leaves in their compute layout: the storage dims
    (``layers``, ``ssm_state``, ...) whole. Returns ``(cache, stored)``,
    ``stored`` the (storage leaf, compute copy) pairs to write back."""
    stored = []

    def walk(node, kind=None):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k if k in ("attn", "mamba", "rwkv") else kind)
                continue
            s = sharding.sharding_of(v)
            if s is None:
                out[k] = v
                continue
            names = tuple(None if a in sharding.STORAGE_NAMES else a
                          for a in cache_axes(kind, k, v.dim()))
            want = sharding.make_sharding(
                names, s.mesh, sharding.current()[1],
                shape=s.global_shape(v.shape))
            if all(sharding.live(s.mesh, s.axes(d))
                   == sharding.live(s.mesh, want.axes(d))
                   for d in range(v.dim())):
                out[k] = v
                continue
            out[k] = sharding.reshard(v, want)
            stored.append((v, out[k]))
        return out

    return walk(cache), stored


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
    tokens, embeddings = _local_rows(params, tokens, embeddings)
    b, s, dev = _ref_shape(tokens, embeddings)
    pos = int(pos)
    positions = pos + torch.arange(s, device=dev)[None].expand(b, s)
    res = sharding.residual_layout(s, cfg.d_model)
    x = _embed_input(cfg, params, tokens, embeddings)
    x = _run_groups(cfg, params, x, positions, cache, pos, res)[0]
    return _logits(cfg, params, sharding.whole(x, res)), cache


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
