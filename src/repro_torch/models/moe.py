"""Mixture-of-Experts FFN: top-k routing with per-sequence capacity. Port of
``repro.models.moe``.

The router runs in f32: softmax, top-k, gates renormalised over the chosen
k. Each sequence is one group with capacity C = int(k·S·cf / E) (at least
1) per expert. The slot of a (token, expert) pair counts the earlier tokens
of its sequence that chose that expert (a token picks an expert at most
once, so the order within k does not matter); pairs at slot >= C are
dropped.

The JAX package builds one-hot dispatch and combine tensors of shape
(B, S, E, C) and contracts them; at granite-moe's width (E 32, k 8, S
4,096, C 1,280) they would take 2.7 GB of f32 a layer. The port dispatches
by index instead: the kept pairs' tokens are copied into an (B, E, C, d)
buffer (a one-hot contraction with one term is the token itself), the
experts run as batched matmuls over it, and each token gathers its kept
pairs' outputs back, weighted by its gates rounded to the activation dtype
first, as JAX's ``combine.astype(x.dtype)`` does, and summed in f32.

The Switch load-balance loss E·Σ_e f_e·P_e (f_e the share of tokens whose
top-1 is e, P_e the mean router probability) and the router z-loss
mean(logsumexp²) come back in :class:`MoEAux`.

Under a sharding context (``models.sharding``) the experts are split over
the ``experts`` dims: every rank routes alike (the router is
column-parallel and its logits gathered), fills and runs its own experts'
slots only, and the combine's f32 partial sums are reduced once; the
losses' means are taken over the global batch, so they are equal on
every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..roofline.op_cost import named_scope
from . import sharding
from .config import ModelConfig
from .layers import activation
from .sharding import logical_constraint


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor  # scalar
    router_z_loss: torch.Tensor      # scalar
    expert_load: torch.Tensor        # (E,) fraction of tokens routed (top-1)


class Route(NamedTuple):
    """The router's decisions for x (B, S, d)."""
    logits: torch.Tensor       # (B, S, E) f32
    probs: torch.Tensor        # (B, S, E) f32
    gates: torch.Tensor        # (B, S, k) f32, renormalised over k
    experts: torch.Tensor      # (B, S, k) int64, descending probability
    slot: torch.Tensor         # (B, S, k) int64, position in the expert
    keep: torch.Tensor         # (B, S, k) bool, slot < capacity


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(cfg.experts_per_token * tokens_per_group * cfg.capacity_factor
            / max(cfg.num_experts, 1))
    return max(c, 1)


def route(cfg: ModelConfig, p: dict, x: torch.Tensor) -> Route:
    """Top-k routing of x (B, S, d) with capacity slots."""
    return _route(cfg, x.float() @ p["router"].float(), x.shape[1])


def _route(cfg: ModelConfig, logits: torch.Tensor, seq: int) -> Route:
    """:func:`route` from the router logits (B, S, E) f32."""
    k = cfg.experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    chosen = torch.zeros(probs.shape, dtype=torch.int64, device=logits.device)
    chosen.scatter_(-1, experts, 1)
    earlier = torch.cumsum(chosen, dim=1) - chosen     # (B, S, E)
    slot = torch.gather(earlier, -1, experts)
    keep = slot < _capacity(cfg, seq)
    return Route(logits, probs, gates, experts, slot, keep)


@named_scope("moe_ffn")
def moe_ffn(cfg: ModelConfig, p: dict,
            x: torch.Tensor) -> tuple[torch.Tensor, MoEAux]:
    """x: (B, S, d) -> ((B, S, d), MoEAux); under a sharding context on
    the rank's experts and rows."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = _capacity(cfg, s)
    router, (_, rax) = sharding.use(p["router"], "embed_w", "experts")
    wi, (eax, _, _) = sharding.use(p["wi"], "experts", "embed_w", None)
    wo, _ = sharding.use(p["wo"], "experts", None, "embed_w")
    xe = sharding.enter(x, eax)
    logits = sharding.gather(sharding.enter(x, rax).float() @ router.float(),
                             -1, rax)
    r = _route(cfg, logits, s)

    # Flat (B·E·C) slot of every kept pair of the rank's experts; each slot
    # holds one token. The copies go through index_select / index_copy on
    # unique rows (a pair's token row from the (B·S·k, d) expansion, whose
    # backward sums the k rows of a token), so the backward needs no
    # accumulating scatter: it is deterministic and cheap on the card.
    e_l = wi.shape[0]
    e_lo = sharding.block_offset(e, eax)
    local = r.keep
    if eax:
        local = local & (r.experts >= e_lo) & (r.experts < e_lo + e_l)
    batch = torch.arange(b, device=x.device)[:, None, None]
    flat = (batch * e_l + r.experts - e_lo) * c + r.slot
    flat = torch.where(local, flat, 0).reshape(-1)
    kept = local.reshape(-1).nonzero().squeeze(1)
    xk = xe[:, :, None, :].expand(b, s, k, d).reshape(b * s * k, d)
    xin = torch.zeros((b * e_l * c, d), dtype=x.dtype, device=x.device)
    xin = xin.index_copy(0, flat[kept], xk.index_select(0, kept))
    xin = logical_constraint(xin.reshape(b, e_l, c, d), "batch", "experts",
                             None, None, layout=((), eax, (), ()))

    h = torch.einsum("becd,edf->becf", xin, wi.to(x.dtype))
    h = activation(cfg, h)
    if cfg.gated_mlp:
        wg, _ = sharding.use(p["wg"], "experts", "embed_w", None)
        h = h * torch.einsum("becd,edf->becf", xin, wg.to(x.dtype))
    out_e = torch.einsum("becf,efd->becd", h, wo.to(x.dtype))

    # A dropped pair reads slot 0 with gate 0: its gradient there is 0.
    gates = torch.where(local, sharding.enter(r.gates, eax), 0.0)
    gates = gates.to(x.dtype).float()
    picked = out_e.reshape(b * e_l * c, d).index_select(0, flat)
    picked = picked.reshape(b, s, k, d).float()
    out = logical_constraint((picked * gates[..., None]).sum(dim=2),
                             "batch", "res_seq", "embed_act", partial=eax)
    out = out.to(x.dtype)

    top1 = torch.nn.functional.one_hot(r.experts[..., 0], e).float()
    z = torch.logsumexp(r.logits, dim=-1)
    bax = sharding.live_batch_axes()
    if bax:   # means over the global batch
        n = b * s * sharding.axes_size(sharding.current()[0], bax)
        frac_tokens = sharding.reduce(top1.reshape(-1, e).sum(0).detach(),
                                      bax) / n
        frac_probs = sharding.reduce(r.probs.reshape(-1, e).sum(0), bax) / n
        z_loss = sharding.reduce((z * z).sum(), bax) / n
    else:
        frac_tokens = top1.reshape(-1, e).mean(0)
        frac_probs = r.probs.reshape(-1, e).mean(0)
        z_loss = torch.mean(z * z)
    lb_loss = e * torch.sum(frac_tokens * frac_probs)
    return out, MoEAux(load_balance_loss=lb_loss, router_z_loss=z_loss,
                       expert_load=frac_tokens)
