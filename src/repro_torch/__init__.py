"""PyTorch/CUDA port of the Snowball solver (``repro`` is the JAX reference).

The package mirrors ``repro``'s subpackage and module names so each
counterpart is easy to find. It imports ``torch`` and numpy only. Every
entry point runs on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no card present it raises
(see :mod:`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
