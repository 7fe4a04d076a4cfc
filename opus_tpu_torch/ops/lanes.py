"""Per-lane selection over a state tree: the one operation behind every
per-lane reset, update and conceal of the batched decoders; and the
per-lane output a call assembles piece by piece."""

from __future__ import annotations

import numpy as np
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


class LaneOut:
    """A call's output over B lanes, assembled piece by piece: lane i's
    pieces follow each other from sample 0 (``dtype`` of the result)."""

    def __init__(self, batch: int, device, dtype=torch.int16):
        self.parts = []
        self.pos = np.zeros(batch, np.int64)
        self.device = device
        self.dtype = dtype

    def add(self, seg, n):
        """seg [B, L]: lane i appends its first n[i] samples."""
        n = np.asarray(n, np.int64)
        if n.any():
            self.parts.append((seg, self.pos.copy(), n))
            self.pos = self.pos + n

    def build(self):
        """-> (out [B, W], n [B] numpy): lane i's output is out[i, :n[i]]."""
        b = len(self.pos)
        width = int(self.pos.max(initial=0))
        out = torch.zeros((b, width + 1), dtype=self.dtype,
                          device=self.device)
        for seg, pos, n in self.parts:
            k = torch.arange(seg.shape[1], device=self.device)[None, :]
            ln = torch.as_tensor(n, device=self.device)[:, None]
            idx = torch.where(k < ln, torch.as_tensor(
                pos, device=self.device)[:, None] + k, width)
            out.scatter_(1, idx, seg.to(self.dtype))
        return out[:, :width], self.pos.copy()
