"""MDCT synthesis basis and window for CELT, as numpy (copied from
``opus_tpu/ops/mdct.py``, whose module imports jax).

The IMDCT is one matmul per short block against the fixed basis, as the
JAX package leaves it to XLA; the port leaves it to ``torch.matmul``.

Transform definition (celt/tests/test_unit_mdct.c::check):
    bwd:  t[n] = sum_k S[k] cos(2*pi*(n+.5+N/4)*(k+.5)/N),  N = 2*N2.
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
