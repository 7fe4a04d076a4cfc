"""Per-lane loss flags for a simulated channel: the batched counterpart of
``opus_demo``'s ``_loss_flags`` (``opus_tpu/tools/opus_demo.py:53``;
reference: src/opus_demo.c's -loss / -sim_loss / -lossfile options).

``loss_flags(n, seeds, ...)`` gives [B, n] bool flags (True: the packet is
lost) from the same three sources, in the same order of precedence, lane
i equal to ``_loss_flags(n, ..., seed=seeds[i])``:

- ``lossfile``: a recorded pattern, one 0/1 per line (1: lost); one path
  for every lane or one path per lane;
- ``sim_loss_perc`` > 0: the generative loss model (``dnn/lossgen.py``),
  from ``model`` or the weight blob ``weights``, both shared by every lane
  (one ``BatchedLossGen``), or without either the stand-in
  ``random_model(seed)`` of each lane, as opus_demo builds it;
- ``loss_perc`` > 0: i.i.d. loss, ``default_rng(seed).random(n) <
  loss_perc / 100`` per lane.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dnn import lossgen


def _pattern(path: str, n: int) -> np.ndarray:
    flags = [int(line.split()[0]) != 0
             for line in open(path) if line.strip()]
    out = np.zeros(n, bool)
    out[:len(flags)] = flags[:n]
    return out


def loss_flags(n: int, seeds, loss_perc: float = 0.0,
               sim_loss_perc: float = 0.0, lossfile=None,
               model: Optional[lossgen.LossGenModel] = None,
               weights: Optional[str] = None, device="cuda") -> torch.Tensor:
    """[B, n] bool loss flags on ``device`` (the card by default), B =
    len(seeds)."""
    device = torch.device(device)
    seeds = [int(s) for s in seeds]
    b = len(seeds)
    if lossfile:
        paths = [lossfile] * b if isinstance(lossfile, str) else \
            list(lossfile)
        if len(paths) != b:
            raise ValueError(f"loss_flags: {len(paths)} loss files for {b} "
                             f"lanes")
        return torch.as_tensor(np.stack([_pattern(p, n) for p in paths])
                               .reshape(b, n), device=device)
    if sim_loss_perc > 0:
        if model is None and weights:
            from ..dnn.weights import parse_blob
            model = lossgen.model_from_arrays(
                parse_blob(open(weights, "rb").read()), device=device)
        groups = {None: list(range(b))} if model is not None else {}
        if model is None:
            for i, s in enumerate(seeds):
                groups.setdefault(s, []).append(i)
        out = torch.zeros((b, n), dtype=torch.bool, device=device)
        for key, lanes in groups.items():
            m = model if key is None else lossgen.random_model(key,
                                                               device=device)
            gen = lossgen.BatchedLossGen(m, [seeds[i] for i in lanes],
                                         device=device)
            flags = torch.stack([gen.sample(sim_loss_perc)
                                 for _ in range(n)], dim=1)
            out[torch.as_tensor(lanes, device=device)] = flags
        return out
    if loss_perc > 0:
        return torch.as_tensor(np.stack(
            [np.random.default_rng(s).random(n) < loss_perc / 100.0
             for s in seeds]).reshape(b, n), device=device)
    return torch.zeros((b, n), dtype=torch.bool, device=device)
