"""Abstract inputs of the dry run (port of ``repro.launch.abstracts``):
meta tensors of the global shapes that carry their ``NamedSharding``, no
allocation. Every model input (tokens or frontend embeddings, labels, the
decode caches, the optimizer state) has one; :func:`local_blocks` turns
them into this rank's blocks, the tensors an SPMD rank of the port holds.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.shapes import InputShape
from ..device import meta_device, resolve_device
from ..models import abstract_params, model_specs
from ..models.config import ModelConfig
from ..models.model import cache_specs
from ..models.params import torch_dtype
from ..models.sharding import (ShardingRules, make_sharding, sharding_of,
                               with_sharding)
from ..optim import AdamWConfig
from ..optim.adamw import QBLOCK, AdamWState, QTensor
from ..train.step import TrainState


def rules_for(shape: InputShape, multi_pod: bool) -> ShardingRules:
    """Per-shape sharding rules (the JAX package's)."""
    if shape.kind == "decode":
        if shape.name == "long_500k":  # batch=1: all parallelism into the cache
            return ShardingRules(batch=None, kv_heads=None,
                                 cache_seq=("data", "model"))
        # decode: batch over pod×data; KV length over model (flash-decode style)
        return ShardingRules(kv_heads=None, cache_seq="model")
    return ShardingRules()  # prefill and train: the defaults


def _meta(shape, dtype, names, mesh, rules) -> torch.Tensor:
    with meta_device():
        t = torch.empty(tuple(shape), dtype=dtype,
                        device=resolve_device("meta"))
    return with_sharding(t, make_sharding(names, mesh, rules, shape=shape)
                         if mesh is not None else None)


def input_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                rules: Optional[ShardingRules] = None) -> dict:
    """Model inputs for one (arch × shape) cell, global shapes."""
    rules = rules or ShardingRules()
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    out: dict = {}
    if cfg.uses_token_embedding:
        out["tokens"] = _meta((b, s), torch.int32, ("batch", "seq"), mesh,
                              rules)
    else:
        out["embeddings"] = _meta((b, s, cfg.d_model), torch.bfloat16,
                                  ("batch", "seq", None), mesh, rules)
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32, ("batch", "seq"), mesh,
                              rules)
    return out


def abstract_cache(cfg: ModelConfig, shape: InputShape, mesh=None,
                   rules: Optional[ShardingRules] = None) -> dict:
    """The abstract decode cache (KV length = ``shape.seq_len``), each
    leaf under its logical axes (``models.model.CACHE_AXES``)."""
    rules = rules or ShardingRules()

    def build(tree):
        return {k: build(v) if isinstance(v, dict)
                else _meta(v.shape, torch_dtype(v.dtype), v.axes, mesh, rules)
                for k, v in tree.items()}

    return build(cache_specs(cfg, shape.global_batch, shape.seq_len))


def abstract_train_state(cfg: ModelConfig, opt: AdamWConfig, mesh=None,
                         rules: Optional[ShardingRules] = None) -> TrainState:
    """The abstract ``TrainState``: parameters from the specs, moments under
    their parameters' axes (an int8 ``QTensor``'s codes under them too, its
    scales without the last), as the JAX package assigns them."""
    rules = rules or ShardingRules()
    specs = model_specs(cfg)
    aparams = abstract_params(specs, mesh, rules)
    moment_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def moment(spec):
        shape = spec.shape or (1,)
        if opt.state_dtype != "int8":
            return _meta(shape, moment_dtype[opt.state_dtype], spec.axes,
                         mesh, rules)
        nb = -(-shape[-1] // QBLOCK)
        lead = tuple(shape[:-1])
        return QTensor(
            codes=_meta(lead + (nb * QBLOCK,), torch.int8, spec.axes, mesh,
                        rules),
            scales=_meta(lead + (nb,), torch.float32,
                         tuple(spec.axes[:-1]) + (None,), mesh, rules),
            orig_last=shape[-1])

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else moment(v)
                for k, v in tree.items()}

    step = _meta((), torch.int32, (), mesh, rules)
    return TrainState(params=aparams,
                      opt_state=AdamWState(step=step, m=build(specs),
                                           v=build(specs)),
                      step=step)


def local_blocks(tree):
    """Each abstract leaf of ``tree`` (a dict tree of meta tensors) as this
    rank's block: a meta tensor of its shard's shape carrying the same
    sharding (the whole tensor where it has none)."""
    if isinstance(tree, dict):
        return {k: local_blocks(v) for k, v in tree.items()}
    s = sharding_of(tree)
    if s is None:
        return tree
    return with_sharding(torch.empty(s.shard_shape(tree.shape),
                                     dtype=tree.dtype, device=tree.device), s)


def leaves(tree, prefix=()):
    """``(path, leaf)`` of a tree of tensors and ``QTensor``s."""
    if isinstance(tree, QTensor):
        yield prefix + ("codes",), tree.codes
        yield prefix + ("scales",), tree.scales
    elif isinstance(tree, (dict, TrainState, AdamWState)):
        items = (tree.items() if isinstance(tree, dict)
                 else tree._asdict().items())
        for k, v in sorted(items):
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree

