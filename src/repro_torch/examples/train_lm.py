"""End-to-end training example: train an LM on the synthetic pipeline with
checkpoint/restart, cosine LR, grad clipping and (optionally) 8-bit Adam.
Counterpart of ``examples/train_lm.py``.

Presets:
    tiny  (default) — ~8M params, 300 steps: finishes on a CPU.
    100m            — ~100M-param qwen2-family config, a few hundred steps
                      on the card.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \
        --steps 300 --checkpoint-dir ckpt [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --resume ...
"""
import argparse

from ..data import DataConfig
from ..models.config import ModelConfig
from ..train import TrainLoopConfig, train_loop

PRESETS = {
    "tiny": ModelConfig(
        name="tiny-lm", family="dense", num_layers=4, d_model=256,
        num_heads=8, num_kv_heads=4, d_ff=704, vocab_size=2048,
        norm="rmsnorm", activation="silu", gated_mlp=True,
        seq_chunk_q=64, seq_chunk_kv=64),
    "100m": ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        norm="rmsnorm", activation="silu", gated_mlp=True, qkv_bias=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot directory (none: no checkpoints)")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--state-dtype", choices=("float32", "bfloat16", "int8"),
                    default="float32")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    print(f"training {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch}×{args.seq}")
    loop = TrainLoopConfig(
        steps=args.steps, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, num_microbatches=args.microbatches,
        log_every=args.log_every, base_lr=args.lr,
        warmup_steps=min(50, args.steps // 5), state_dtype=args.state_dtype,
        async_checkpoint=True)
    data = DataConfig(seed=0, global_batch=args.batch, seq_len=args.seq)
    state, history = train_loop(cfg, data, loop, resume=args.resume,
                                device=args.device)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"done: loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
