"""Train launcher: --arch selection, checkpoint/resume, microbatching.
Counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --smoke --steps 100 --checkpoint-dir ckpt --resume [--device cpu]
"""
from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, get_config
from ..data import DataConfig
from ..train import TrainLoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--state-dtype", choices=("float32", "bfloat16", "int8"),
                    default="float32")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    loop = TrainLoopConfig(
        steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, num_microbatches=args.microbatches,
        base_lr=args.lr, seed=args.seed, state_dtype=args.state_dtype,
        async_checkpoint=True)
    data = DataConfig(seed=args.seed, global_batch=args.global_batch,
                      seq_len=args.seq_len)
    return train_loop(cfg, data, loop, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
