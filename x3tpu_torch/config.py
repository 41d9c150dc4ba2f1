"""Configuration for the PyTorch port.

``X3Params`` and ``CodecCaps`` are x3tpu's own (``x3tpu.config`` has no
framework).  ``CodecCaps.engine`` and ``CodecCaps.resolved`` belong to the
JAX package (the latter imports jax); the port picks its engine from the
device instead, with no fallback between the two.
"""

from __future__ import annotations

import torch

from x3tpu.config import CodecCaps, X3Params

__all__ = ["CodecCaps", "X3Params", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The device a call runs on: ``"cuda"`` runs the CUDA kernel and
    raises when there is no card; ``"cpu"`` runs the plain PyTorch
    encoder.  Nothing else is accepted."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "x3tpu_torch: device='cuda' but torch.cuda.is_available() "
                "is False (use device='cpu' for the plain PyTorch encoder)"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"x3tpu_torch: unsupported device {device!r}")
