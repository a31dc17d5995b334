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

Sharded (``param_shardings``, under ``models.use_sharding``): every rank
calls the step with the same global batch and its blocks of the state
(``models.shard_params``); the forward takes the rank's rows, the loss
sums its token count and cross-entropy over the data dims and takes a
vocab-split logsumexp, and each gradient is summed over the data dims its
parameter is not split on and kept as the parameter's block (a
reduce-scatter, written as an all-reduce and a slice).
``gathered_shardings`` casts the parameters to the compute dtype and
gathers them to those shardings once a step, outside the microbatch loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models import forward, sharding
from ..models.config import ModelConfig
from ..models.params import torch_dtype, tree_paths
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
    (B, S, V) one-hot tensor. Under a sharding context the loss is the
    global batch's, equal on every rank."""
    kwargs = {}
    if "tokens" in batch:
        kwargs["tokens"] = batch["tokens"]
    if "embeddings" in batch:
        kwargs["embeddings"] = batch["embeddings"]
    out = forward(cfg, params, **kwargs)
    logits = out.logits.float()
    labels = sharding.local_batch(batch["labels"])
    _, sax, vax = sharding.layout(out.logits)
    if sax:   # logits split on the sequence: this rank's labels of it
        mesh = sharding.current()[0]
        n = logits.shape[1]
        labels = labels[:, :n * sharding.axes_size(mesh, sax)]
        labels = labels.narrow(1, sharding.block_offset(labels.shape[1], sax),
                               n)
    if labels.shape[1] != logits.shape[1]:  # next-token on same-length stream
        logits = logits[:, :labels.shape[1]]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    lse, picked = _vocab_terms(logits, safe, vax)
    token_ce = (lse - picked) * valid.float()
    bax = sharding.live_batch_axes() + sax
    denom = torch.clamp(sharding.reduce(valid.sum(), bax), min=1)
    ce = sharding.reduce(token_ce.sum() / denom, bax)
    loss = ce + out.aux_loss
    return loss, {"ce": ce, "aux": out.aux_loss, "tokens": denom.float()}


def _vocab_terms(logits: torch.Tensor, labels: torch.Tensor, vax):
    """``(logsumexp, the label's logit)``. Of logits split on the vocab
    over ``vax``: the max over every rank, the exp-sums and the picked
    logit (0 where another rank holds the label) summed."""
    if not vax:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    n = logits.shape[-1]
    m = sharding.all_max(logits.detach().amax(dim=-1), vax)
    lse = m + torch.log(sharding.reduce(
        torch.exp(logits - m[..., None]).sum(dim=-1), vax))
    local = labels - sharding.block_offset(
        n * sharding.axes_size(sharding.current()[0], vax), vax)
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    picked = torch.where(inside, picked[..., 0], 0.0)
    return lse, sharding.reduce(picked, vax)


def _with_grad(params: dict) -> dict:
    """Detached views of the parameters that require grad (no copy), with
    their shardings."""
    return {k: _with_grad(v) if isinstance(v, dict)
            else sharding.with_sharding(v.detach().requires_grad_(),
                                        sharding.sharding_of(v))
            for k, v in params.items()}


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
    grads = [sharding.with_sharding(g.float(), sharding.sharding_of(t))
             for g, t in zip(grads, leaves)]
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
    JAX step's scan does.

    ``param_shardings`` (the parameters' tree of ``NamedSharding``, from
    ``models.param_shardings``): the state holds each rank's blocks and the
    step runs under ``models.use_sharding``; each gradient comes back as
    its parameter's block, summed over the data dims. ``gathered_shardings``
    (the same without the FSDP dims): the parameters are cast to the
    compute dtype and gathered to them once a step."""
    m = num_microbatches
    sharded = param_shardings is not None or gathered_shardings is not None
    compute_dtype = torch_dtype(cfg.compute_dtype)

    def gather_once(params):
        if gathered_shardings is None:
            return params
        return _map(params, gathered_shardings, lambda p, s: sharding.reshard(
            sharding.with_sharding(
                p.to(compute_dtype) if p.dtype == torch.float32 else p,
                sharding.sharding_of(p)), s))

    def constrain_grads(grads, params):
        """Each gradient summed over the batch dims its block is not split
        on, as its parameter's block (``param_shardings``, else the
        parameter's own sharding)."""
        mesh, rules = sharding.current()
        bat = sharding.live(mesh, sharding.batch_axes(mesh, rules))
        targets = param_shardings if param_shardings is not None else \
            _map(params, params, lambda p, _: sharding.sharding_of(p))

        def one(g, s):
            have = {a for d in sharding.layout(g) for a in d}
            summed = sharding.reduce(g, tuple(a for a in bat if a not in have),
                                     mesh)
            return sharding.reshard(
                sharding.with_sharding(summed, sharding.sharding_of(g)), s)

        return _map(grads, targets, one)

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
        if sharded and sharding.current() is None:
            raise ValueError("a sharded train step runs under "
                             "models.use_sharding(mesh, rules)")
        loss, grads, metrics = grads_and_metrics(gather_once(state.params),
                                                 batch)
        if sharded:
            grads = constrain_grads(grads, state.params)
        lr = lr_fn(state.step) if lr_fn is not None else None
        params, opt_state, opt_metrics = adamw_update(
            state.params, grads, state.opt_state, opt, lr=lr)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        if lr is not None:
            metrics["lr"] = lr
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step


def _map(tree: dict, like: dict, fn) -> dict:
    """``fn(leaf, like's leaf)`` at every leaf of ``tree``."""
    return {k: _map(v, like[k], fn) if isinstance(v, dict) else fn(v, like[k])
            for k, v in tree.items()}


def init_train_state(cfg: ModelConfig, params: dict,
                     opt: AdamWConfig) -> TrainState:
    leaves = [t for _, t in tree_paths(params)]
    return TrainState(params=params, opt_state=adamw_init(params, opt),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device))
