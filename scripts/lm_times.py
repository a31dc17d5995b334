"""Time the port's unsharded LM paths on the card: qwen2-7b's prefill and
decode (bf16 weights, kernel E) and granite-moe-1b-a400m's train step
(f32 state, remat "dots"), at the shapes of ``chip_smoke.py``'s
``[lm-shard]`` phase, from the ``repro_torch`` package under ``--src``.

Run it on two trees in one session to compare them on the same card, in
the order A, B, B, A (each in its own process):

    python scripts/lm_times.py --src other_tree/src --label A
    python scripts/lm_times.py --label B

It prints one JSON object with the medians (host clock, synchronised) and
the card's name and power limit. Weights and batches come from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEQ = 2048                       # the prefill: 1 x SEQ tokens
DECODE_B, PROMPT, NEW = 2, 64, 16
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 2048, 2
LR = 3e-4


def timed(torch, run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--train-steps", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("lm_times: no CUDA device is available")
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import (decode_step, forward, init_decode_cache,
                                    init_params, model_specs)
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {"label": args.label, "src": args.src}

    cfg = dataclasses.replace(get_config("qwen2-7b"), param_dtype="bfloat16",
                              remat="none", attn_impl="flash")
    params = init_params(model_specs(cfg),
                         torch.Generator("cuda").manual_seed(0), "cuda")
    g = np.random.default_rng(0)
    tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, (1, SEQ))).cuda()
    dtok = torch.from_numpy(g.integers(0, cfg.vocab_size,
                                       (DECODE_B, PROMPT + NEW))).cuda()
    with torch.no_grad():
        forward(cfg, params, tokens=tokens)                  # warm-up
        secs = [timed(torch, lambda: forward(cfg, params, tokens=tokens))[1]
                for _ in range(args.reps)]
    out["prefill_ms"] = 1e3 * statistics.median(secs)
    steps = []
    for rep in range(4):                    # the first pass warms up
        cache = init_decode_cache(cfg, DECODE_B, PROMPT + NEW, device="cuda")
        decode_step(cfg, params, cache, 0, tokens=dtok[:, :PROMPT])
        secs = [timed(torch, lambda: decode_step(
            cfg, params, cache, PROMPT + i,
            tokens=dtok[:, PROMPT + i:PROMPT + i + 1]))[1]
            for i in range(NEW)]
        steps += secs if rep else []
    out["decode_ms"] = 1e3 * statistics.median(steps)
    del params, cache
    torch.cuda.empty_cache()

    gcfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                               attn_impl="flash")
    gparams = init_params(model_specs(gcfg),
                          torch.Generator("cuda").manual_seed(0), "cuda")
    opt = AdamWConfig(learning_rate=LR)
    step = make_train_step(gcfg, opt, linear_warmup_cosine(
        LR, 1, args.train_steps), num_microbatches=TRAIN_MB)
    state = init_train_state(gcfg, gparams, opt)
    data = SyntheticLMData(gcfg, DataConfig(seed=0, global_batch=TRAIN_B,
                                            seq_len=TRAIN_S), "cuda")
    tsecs = []
    for i in range(args.train_steps):
        batch = data.batch(i)
        (state, _), s = timed(torch, lambda: step(state, batch))
        tsecs.append(s)
    out["train_step_s"] = statistics.median(tsecs[1:])    # after the first
    out["train_steps_s"] = tsecs
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
