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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelConfig
from .layers import activation


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
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    chosen = torch.zeros(probs.shape, dtype=torch.int64, device=x.device)
    chosen.scatter_(-1, experts, 1)
    earlier = torch.cumsum(chosen, dim=1) - chosen     # (B, S, E)
    slot = torch.gather(earlier, -1, experts)
    keep = slot < _capacity(cfg, x.shape[1])
    return Route(logits, probs, gates, experts, slot, keep)


def moe_ffn(cfg: ModelConfig, p: dict,
            x: torch.Tensor) -> tuple[torch.Tensor, MoEAux]:
    """x: (B, S, d) -> ((B, S, d), MoEAux)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = _capacity(cfg, s)
    r = route(cfg, p, x)

    # Flat (B·E·C) slot of every kept pair; each slot holds one token.
    # The copies go through index_select / index_copy on unique rows (a
    # pair's token row from the (B·S·k, d) expansion, whose backward sums
    # the k rows of a token), so the backward needs no accumulating
    # scatter: it is deterministic and cheap on the card.
    batch = torch.arange(b, device=x.device)[:, None, None]
    flat = (batch * e + r.experts) * c + r.slot
    flat = torch.where(r.keep, flat, 0).reshape(-1)
    kept = r.keep.reshape(-1).nonzero().squeeze(1)
    xk = x[:, :, None, :].expand(b, s, k, d).reshape(b * s * k, d)
    xin = torch.zeros((b * e * c, d), dtype=x.dtype, device=x.device)
    xin = xin.index_copy(0, flat[kept], xk.index_select(0, kept))
    xin = xin.reshape(b, e, c, d)

    h = torch.einsum("becd,edf->becf", xin, p["wi"].to(x.dtype))
    h = activation(cfg, h)
    if cfg.gated_mlp:
        h = h * torch.einsum("becd,edf->becf", xin, p["wg"].to(x.dtype))
    out_e = torch.einsum("becf,efd->becd", h, p["wo"].to(x.dtype))

    # A dropped pair reads slot 0 with gate 0: its gradient there is 0.
    gates = torch.where(r.keep, r.gates, 0.0).to(x.dtype).float()
    picked = out_e.reshape(b * e * c, d).index_select(0, flat)
    picked = picked.reshape(b, s, k, d).float()
    out = (picked * gates[..., None]).sum(dim=2).to(x.dtype)

    top1 = torch.nn.functional.one_hot(r.experts[..., 0], e).float()
    frac_tokens = top1.reshape(-1, e).mean(0)
    frac_probs = r.probs.reshape(-1, e).mean(0)
    lb_loss = e * torch.sum(frac_tokens * frac_probs)
    z = torch.logsumexp(r.logits, dim=-1)
    z_loss = torch.mean(z * z)
    return out, MoEAux(load_balance_loss=lb_loss, router_z_loss=z_loss,
                       expert_load=frac_tokens)
