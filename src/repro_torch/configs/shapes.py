"""Assigned input shapes (one set, shared by all 10 LM-family architectures).

    train_4k     seq 4,096   global_batch 256   (training, lowers train_step)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill, forward)
    decode_32k   seq 32,768  global_batch 128   (decode: 1 new token, KV cache = seq)
    long_500k    seq 524,288 global_batch 1     (long-context decode; sub-quadratic only)

Skips (documented in DESIGN.md §Arch-applicability): ``long_500k`` is skipped
for pure full-attention architectures; encoder-only (hubert) has no decode.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the DESIGN.md skip matrix."""
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only architecture: no autoregressive decode step"
    if shape.name == "long_500k":
        if not cfg.is_subquadratic:
            return False, "pure full-attention O(L^2): 500k context not runnable"
    if shape.name == "prefill_32k" and not cfg.causal:
        return True, "encoder forward (no causal mask)"
    return True, ""
