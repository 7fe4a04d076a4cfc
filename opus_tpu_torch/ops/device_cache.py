"""Per-device cache of constant tensors built from numpy (tables, bases,
windows), so a step uploads each constant once per device, not per call."""

from __future__ import annotations

import torch

_CACHE: dict = {}


def const(key, make, device) -> torch.Tensor:
    """The tensor ``make()`` (a numpy array) on ``device``, built on first
    use; ``key`` names it and must determine its content."""
    k = (key, str(torch.device(device)))
    t = _CACHE.get(k)
    if t is None:
        t = torch.as_tensor(make(), device=device)
        _CACHE[k] = t
    return t
