"""Train step: loss, gradient accumulation over microbatches, optimizer
update (port of ``repro.train.step``).

The loss is next-token (or masked-prediction) cross-entropy over the
logits in f32; labels < 0 are ignored (encoder masking and padding).
Microbatching runs the forward and backward one slice of the batch at a
time and sums the gradients in f32, so the peak activation footprint is
``1/num_microbatches`` of the whole batch's.

The step is functional over the parameter dict, as the JAX one is: it
takes the gradients of detached views of the parameters (no ``.grad`` is
touched) and returns a new :class:`TrainState`, whose parameters and
moments :func:`~repro_torch.optim.adamw_update` has written in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models import forward
from ..models.config import ModelConfig
from ..models.params import tree_paths
from ..optim import AdamWConfig, AdamWState, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: dict
    opt_state: AdamWState
    step: torch.Tensor  # int32, 0-d


def lm_loss(cfg: ModelConfig, params: dict,
            batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean CE over valid label positions + MoE aux. Returns (loss,
    metrics). The label's logit is taken with ``torch.gather``, the value
    of JAX's one-hot contraction (every other term is 0·finite) without a
    (B, S, V) one-hot tensor."""
    kwargs = {}
    if "tokens" in batch:
        kwargs["tokens"] = batch["tokens"]
    if "embeddings" in batch:
        kwargs["embeddings"] = batch["embeddings"]
    out = forward(cfg, params, **kwargs)
    logits = out.logits.float()
    labels = batch["labels"]
    if labels.shape[1] != logits.shape[1]:  # next-token on same-length stream
        logits = logits[:, :labels.shape[1]]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    token_ce = (lse - picked) * valid.float()
    denom = torch.clamp(valid.sum(), min=1)
    ce = token_ce.sum() / denom
    loss = ce + out.aux_loss
    return loss, {"ce": ce, "aux": out.aux_loss, "tokens": denom.float()}


def _with_grad(params: dict) -> dict:
    """Detached views of the parameters that require grad (no copy)."""
    return {k: _with_grad(v) if isinstance(v, dict)
            else v.detach().requires_grad_() for k, v in params.items()}


def _unflatten(like: dict, leaves) -> dict:
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return build(like)


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """``(loss, metrics, grads)``: :func:`lm_loss` and its f32 gradient
    with respect to every parameter (a dict of the params' keys)."""
    live = _with_grad(params)
    loss, metrics = lm_loss(cfg, live, batch)
    leaves = [t for _, t in tree_paths(live)]
    grads = torch.autograd.grad(loss, leaves)
    grads = [g.float() for g in grads]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    lr_fn: Optional[Callable] = None,
                    num_microbatches: int = 1,
                    param_shardings=None, gathered_shardings=None):
    """The train step ``(state, batch) -> (state, metrics)``. The batch's
    leading dim must divide into ``num_microbatches`` slices; their
    gradients are summed in f32 and scaled by 1/M, their losses averaged,
    and the last slice's ``ce``, ``aux`` and ``tokens`` reported, as the
    JAX step's scan does. The sharding arguments belong to the LM
    sharding work (ROADMAP queue 1 item 23) and raise."""
    if param_shardings is not None or gathered_shardings is not None:
        raise NotImplementedError(
            "param_shardings / gathered_shardings: sharded training is "
            "ROADMAP queue 1 item 23 (the LM sharding), not ported yet")
    m = num_microbatches

    def grads_and_metrics(params, batch):
        if m == 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch)
            return loss, grads, metrics
        b = next(iter(batch.values())).shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} "
                             "microbatches")
        per = b // m
        for i in range(m):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics, grads = value_and_grad(cfg, params, mb)
            flat = [g for _, g in tree_paths(grads)]
            if i == 0:   # the f32 sums start from the first slice's
                acc, loss_sum = flat, loss
                continue
            for a, g in zip(acc, flat):
                a.add_(g)
            del grads, flat
            loss_sum = loss_sum + loss
        inv = 1.0 / m
        for a in acc:
            a.mul_(inv)
        return loss_sum * inv, _unflatten(params, acc), metrics

    def train_step(state: TrainState, batch: dict):
        loss, grads, metrics = grads_and_metrics(state.params, batch)
        lr = lr_fn(state.step) if lr_fn is not None else None
        params, opt_state, opt_metrics = adamw_update(
            state.params, grads, state.opt_state, opt, lr=lr)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        if lr is not None:
            metrics["lr"] = lr
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step


def init_train_state(cfg: ModelConfig, params: dict,
                     opt: AdamWConfig) -> TrainState:
    leaves = [t for _, t in tree_paths(params)]
    return TrainState(params=params, opt_state=adamw_init(params, opt),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device))
