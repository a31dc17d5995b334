"""Device resolution for every entry point of the port.

The port runs on the card. The CPU is used only when a caller asks for it
(``device="cpu"``), as the parity tests do; nothing falls back to it.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

_META: contextvars.ContextVar = contextvars.ContextVar("meta_device",
                                                      default=False)


@contextlib.contextmanager
def meta_device():
    """Within this context the entry points take the meta device (shapes
    without data): the dry run's context, and only its."""
    token = _META.set(True)
    try:
        yield
    finally:
        _META.reset(token)


def meta_allowed() -> bool:
    return _META.get()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is none.

    An explicit ``"cpu"`` selects the plain PyTorch versions of the kernels;
    an explicit CUDA device must exist; ``"meta"`` is taken only within
    :func:`meta_device`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card and "
                "never falls back to the CPU. Pass device='cpu' to run the "
                "plain PyTorch versions of the kernels explicitly.")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    if dev.type == "meta" and meta_allowed():
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
