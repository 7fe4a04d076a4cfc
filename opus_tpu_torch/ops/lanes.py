"""Per-lane selection over a state tree: the one operation behind every
per-lane reset, update and conceal of the batched decoders."""

from __future__ import annotations

import torch


def lane_mask(lanes, batch: int, device) -> torch.Tensor:
    """``lanes`` ([B] bool, anything ``torch.as_tensor`` reads; None: every
    lane) as a [B] bool tensor on ``device``."""
    if lanes is None:
        return torch.ones(batch, dtype=torch.bool, device=device)
    m = torch.as_tensor(lanes, device=device).to(torch.bool)
    if m.shape != (batch,):
        raise ValueError(f"lane mask of shape {tuple(m.shape)}, expected "
                         f"({batch},)")
    return m


def select_lanes(mask: torch.Tensor, new, old):
    """``new`` on the lanes where ``mask`` [B] holds, ``old`` elsewhere, leaf
    by leaf over matching trees (dicts, NamedTuples, tuples and lists of
    tensors whose first dimension is the lane).  Lanes outside the mask
    keep ``old``'s values bit for bit."""
    if isinstance(old, torch.Tensor):
        m = mask.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(m, new, old)
    if isinstance(old, dict):
        return {k: select_lanes(mask, new[k], v) for k, v in old.items()}
    if isinstance(old, tuple) and hasattr(old, "_fields"):
        return type(old)(*(select_lanes(mask, n, o)
                           for n, o in zip(new, old)))
    if isinstance(old, (tuple, list)):
        return type(old)(select_lanes(mask, n, o) for n, o in zip(new, old))
    raise TypeError(f"select_lanes: unexpected leaf {type(old)}")
