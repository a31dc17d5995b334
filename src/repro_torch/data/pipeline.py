"""Deterministic synthetic LM data with skip-ahead resume (port of
``repro.data.pipeline``).

Batches are pure functions of (seed, step): the threefry counters of
:mod:`repro_torch.core.rng`, bitwise ``jax.random``'s, so a batch's tokens
and labels equal the JAX package's for the same seed and step, on the CPU
and on the card, and a restart resumes by setting the step counter. The
token stream is a Zipf-ish categorical (Gumbel-max over the vocabulary,
drawn in row slices) plus a per-position drift, so the LM loss has
learnable structure.

For frontend-stub architectures (audio/vlm) the batch carries bf16
embeddings of backbone width and labels (masked-prediction labels, -1 at
unmasked positions, for encoders).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    mask_fraction: float = 0.3   # encoder masked-prediction
    zipf_alpha: float = 1.2


class SyntheticLMData:
    """``batch(step)`` -> dict of tensors on ``device`` (default: the
    card); deterministic in (seed, step)."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self._base = rng.key(data.seed)
        # Zipf-ish unigram over the vocab, in the reference's f32 log.
        ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float32,
                             device=self.device)
        alpha = torch.tensor(-data.zipf_alpha, dtype=torch.float32,
                             device=self.device)
        self._logits = alpha * rng.log_f32(ranks)

    def _key(self, step: int, salt: int) -> torch.Tensor:
        return rng.fold_in(rng.fold_in(self._base, int(step)), salt)

    def batch(self, step) -> dict:
        cfg, d = self.cfg, self.data
        b, s = d.global_batch, d.seq_len
        # Markov flavour: token_t = a Zipf draw + a drift of t + 1.
        base = rng.categorical(self._key(step, 0), self._logits, (b, s + 1))
        drift = torch.arange(1, s + 2, dtype=torch.int64, device=self.device)
        tokens = ((base + drift) % cfg.vocab_size).to(torch.int32)
        if cfg.uses_token_embedding:
            return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        emb = rng.normal(self._key(step, 1), (b, s, cfg.d_model),
                         torch.bfloat16, device=self.device)
        emb = emb * torch.tensor(0.1, dtype=torch.bfloat16, device=self.device)
        if cfg.causal:  # vlm backbone: next-token objective on paired labels
            return {"embeddings": emb, "labels": tokens[:, 1:]}
        # encoder (hubert): masked-frame prediction; -1 marks unmasked.
        masked = rng.bernoulli(self._key(step, 2), d.mask_fraction, (b, s),
                               device=self.device)
        labels = torch.where(masked, tokens[:, :-1], -1)
        return {"embeddings": emb, "labels": labels}

    def host_shard(self, batch: dict, host_index: int,
                   num_hosts: int) -> dict:
        """Per-host slice of the global batch (data-parallel loading)."""
        def slice_one(x):
            per = x.shape[0] // num_hosts
            return x[host_index * per:(host_index + 1) * per]

        return {k: slice_one(v) for k, v in batch.items()}
