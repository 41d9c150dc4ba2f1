"""Lane-parallel bit sink and source, arithmetic coder and match finding."""

from typing import Dict, Tuple

import torch

_CACHE: Dict[Tuple[object, torch.device], torch.Tensor] = {}


def const(values: Tuple[int, ...], device) -> torch.Tensor:
    """An int64 tensor of ``values`` on ``device``, made once and reused:
    the encoder asks for the same few constants on every event, and on a
    GPU each new one would be a host-to-device copy."""
    key = (values, torch.device(device))
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.tensor(values, dtype=torch.int64,
                                       device=device)
    return t


def iota(width: int, device) -> torch.Tensor:
    """``torch.arange(width)`` on ``device``, made once and reused."""
    key = (width, torch.device(device))
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.arange(width, device=device)
    return t
