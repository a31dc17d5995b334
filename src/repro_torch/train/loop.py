"""Training loop with checkpoint/restart and deterministic resume (port
of ``repro.train.loop``).

* Every ``checkpoint_every`` steps the whole :class:`TrainState` is saved
  atomically (optionally on a thread), int8 and bf16 moments included.
* ``resume=True`` restores the latest snapshot and the data pipeline
  *skips ahead* by step (batches are pure functions of (seed, step)).
* A ``failure_hook`` lets tests inject a crash mid-run and check that the
  restarted run ends in the state of an uninterrupted one, bitwise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLMData
from ..device import DeviceLike, resolve_device
from ..models import init_params, model_specs
from ..models.config import ModelConfig
from ..optim import AdamWConfig
from ..optim.schedule import linear_warmup_cosine
from .step import TrainState, init_train_state, make_train_step


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    async_checkpoint: bool = False
    num_microbatches: int = 1
    log_every: int = 10
    seed: int = 0
    base_lr: float = 3e-4
    warmup_steps: int = 20
    state_dtype: str = "float32"


def train_loop(cfg: ModelConfig, data_cfg: DataConfig, loop: TrainLoopConfig,
               resume: bool = False,
               failure_hook: Optional[Callable[[int], None]] = None,
               log_fn: Callable[[str], None] = print,
               device: DeviceLike = None) -> tuple[TrainState, list[dict]]:
    """Run the loop on ``device`` (default: the card); returns
    ``(final_state, metric history)``. The parameters come from
    ``init_params`` with a ``torch.Generator`` seeded by ``loop.seed`` (not
    ``jax.random``'s numbers)."""
    dev = resolve_device(device)
    opt = AdamWConfig(learning_rate=loop.base_lr, state_dtype=loop.state_dtype)
    lr_fn = linear_warmup_cosine(loop.base_lr, loop.warmup_steps, loop.steps)
    params = init_params(model_specs(cfg),
                         torch.Generator(dev).manual_seed(loop.seed), dev)
    state = init_train_state(cfg, params, opt)

    manager = None
    if loop.checkpoint_dir:
        manager = CheckpointManager(loop.checkpoint_dir,
                                    keep=loop.keep_checkpoints,
                                    async_save=loop.async_checkpoint)
        if resume:
            restored, at = manager.restore(state)
            if restored is not None:
                state = restored
                log_fn(f"[resume] restored checkpoint at step {at}")

    data = SyntheticLMData(cfg, data_cfg, device=dev)
    step_fn = make_train_step(cfg, opt, lr_fn,
                              num_microbatches=loop.num_microbatches)

    history: list[dict] = []
    start = int(state.step)
    t0 = time.time()
    try:
        for step in range(start, loop.steps):
            if failure_hook is not None:
                failure_hook(step)  # may raise to simulate preemption
            batch = data.batch(step)
            state, metrics = step_fn(state, batch)
            if step % loop.log_every == 0 or step == loop.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = time.time() - t0
                history.append(m)
                log_fn(f"[train] step={step} loss={m['loss']:.4f} "
                       f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f}")
            if manager and (step + 1) % loop.checkpoint_every == 0:
                manager.save(step + 1, state)
    except BaseException:
        if manager:   # an exception still lands the snapshot in flight
            manager.wait()
        raise
    if manager:
        manager.save(loop.steps, state)
        manager.wait()
    return state, history
