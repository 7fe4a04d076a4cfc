"""MDCT analysis and synthesis bases and window for CELT, as numpy
(copied from ``opus_tpu/ops/mdct.py``, whose module imports jax).

The MDCT and IMDCT are one matmul per short block against the fixed
basis, as the JAX package leaves them to XLA; the port leaves them to
``torch.matmul``.

Transform definition (celt/tests/test_unit_mdct.c::check):
    fwd:  out[k] = (4/N) * sum_n u[n] cos(2*pi*(n+.5+N/4)*(k+.5)/N)
    bwd:  t[n]   =         sum_k S[k] cos(2*pi*(n+.5+N/4)*(k+.5)/N)
with N = 2*N2, u the input windowed over ``overlap`` taper samples at each
end of its N2+overlap support.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _backward_basis(n2: int, overlap: int) -> np.ndarray:
    """[N2, N2] matrix: spectrum -> t[N2/2 : N2/2+N2] (the TDAC blend
    consumes it; see batched_decode._tdac)."""
    n = 2 * n2
    m = np.arange(n2, dtype=np.float64) + n2 / 2
    k = np.arange(n2, dtype=np.float64)
    phase = 2 * np.pi * (m[:, None] + 0.5 + n / 4) * (k[None, :] + 0.5) / n
    return np.cos(phase).astype(np.float32).T  # [N2(spec), N2(time)]


@lru_cache(maxsize=None)
def _window(overlap: int) -> np.ndarray:
    i = np.arange(overlap, dtype=np.float64)
    inner = np.sin(0.5 * np.pi * (i + 0.5) / overlap)
    return np.sin(0.5 * np.pi * inner * inner)


@lru_cache(maxsize=None)
def _forward_basis(n2: int, overlap: int) -> np.ndarray:
    """[N2+overlap, N2] matrix including the window taper and 4/N scale."""
    n = 2 * n2
    pad = (n2 - overlap) // 2
    j = np.arange(n2 + overlap, dtype=np.float64)
    k = np.arange(n2, dtype=np.float64)
    w = _window(overlap)
    taper = np.ones(n2 + overlap)
    taper[:overlap] = w
    taper[n2:] = w[::-1]
    phase = 2 * np.pi * (pad + j[:, None] + 0.5 + n / 4) * (k[None, :] + 0.5) / n
    return (np.cos(phase) * taper[:, None] * (4.0 / n)).astype(np.float32)
