"""Decoded-quality measure shared by the encoder's tests, its fixture tool
and ``chip_smoke.py``: the SNR of a decoded stream against its input, at
the best alignment (the codec's delay is not compensated)."""

from __future__ import annotations

import numpy as np


def best_snr(ref: np.ndarray, out: np.ndarray, frame: int = 960,
             max_shift: int = 400) -> float:
    """Highest SNR in dB of ``out[sh:]`` against ``ref`` over shifts
    0..max_shift-1, skipping the first frame (encoder warm-up).  Same
    measure as the JAX package's encoder tests (``_best_snr``)."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    best = -99.0
    for sh in range(max_shift):
        a, o = ref[:len(out) - sh], out[sh:]
        m = min(len(a), len(o))
        if m < 2 * frame:
            continue
        err2 = np.mean((a[frame:m] - o[frame:m]) ** 2)
        sref = np.mean(a[frame:m] ** 2)
        best = max(best, 10 * np.log10(sref / (err2 + 1e-12)))
    return float(best)
