"""Configurations of the port: the Snowball solver's (``snowball``) and the
LM substrate's architectures (``--arch <id>``, as ``repro.configs``).

The six dense ``attn:mlp`` architectures have the JAX package's ``CONFIG``
and ``SMOKE``; the four that need MoE, Mamba or RWKV blocks are not ported
yet and :func:`get_config` raises for them.
"""
from __future__ import annotations

from . import (hubert_xlarge, llava_next_34b, nemotron_4_340b, qwen2_7b,
               stablelm_12b, starcoder2_7b)
from .shapes import SHAPES, InputShape, applicable  # noqa: F401

_MODULES = {
    "starcoder2-7b": starcoder2_7b,
    "stablelm-12b": stablelm_12b,
    "nemotron-4-340b": nemotron_4_340b,
    "qwen2-7b": qwen2_7b,
    "llava-next-34b": llava_next_34b,
    "hubert-xlarge": hubert_xlarge,
}

#: Architectures whose blocks (MoE, Mamba, RWKV) the port does not have yet.
UNPORTED = ("phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "jamba-1.5-large-398b")

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch in UNPORTED:
        raise NotImplementedError(
            f"{arch} needs MoE, Mamba or RWKV blocks, which the port does not "
            "have yet (ROADMAP queue 1 item 14)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
