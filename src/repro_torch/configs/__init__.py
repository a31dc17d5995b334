"""Configurations of the port: the Snowball solver's (``snowball``) and the
LM substrate's architectures (``--arch <id>``, as ``repro.configs``): the
JAX package's ``CONFIG`` and ``SMOKE`` of all ten.
"""
from __future__ import annotations

from . import (granite_moe_1b, hubert_xlarge, jamba_15_large, llava_next_34b,
               nemotron_4_340b, phi35_moe, qwen2_7b, rwkv6_1b6, stablelm_12b,
               starcoder2_7b)
from .shapes import SHAPES, InputShape, applicable  # noqa: F401

_MODULES = {
    "starcoder2-7b": starcoder2_7b,
    "stablelm-12b": stablelm_12b,
    "nemotron-4-340b": nemotron_4_340b,
    "qwen2-7b": qwen2_7b,
    "llava-next-34b": llava_next_34b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "granite-moe-1b-a400m": granite_moe_1b,
    "hubert-xlarge": hubert_xlarge,
    "rwkv6-1.6b": rwkv6_1b6,
    "jamba-1.5-large-398b": jamba_15_large,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
