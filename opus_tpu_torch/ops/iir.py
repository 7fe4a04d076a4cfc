"""First-order IIR de-emphasis y[n] = x[n] + c*y[n-1]: kernel K2 and its
plain torch version.

``deemphasis`` is the wrapper: a CPU tensor runs ``deemphasis_plain``,
a CUDA tensor runs the hand-written CUDA kernel
(``opus_tpu_torch/csrc/deemphasis.cu``, one warp per stream: chunks of
the row with a zero carry, then a warp scan of the chunks' carries) or
raises.  It replaces the Pallas kernel
``opus_tpu/ops/iir_pallas.py:_kernel`` / ``deemphasis``.

The plain version is the JAX kernel's block form (iir_pallas.py:33-66):
within a 128-sample block y = x @ L^T + c^(k+1) * carry, L the lower-
triangular Toeplitz matrix of powers of c, so a 20 ms frame is 8
matmuls plus the carry (reference: deemphasis celt/celt_decoder.c:318).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .device_cache import const

BLOCK = 128

# launches of kernel K2 (counted where the kernel is launched, only there)
launches = 0


@lru_cache(maxsize=None)
def _toeplitz(coef: float, k: int) -> np.ndarray:
    """L[i, j] = coef^(i-j) for i >= j else 0 (applied as x @ L.T)."""
    i = np.arange(k)
    d = i[:, None] - i[None, :]
    return np.where(d >= 0, float(coef) ** np.maximum(d, 0),
                    0.0).astype(np.float32)


@lru_cache(maxsize=None)
def _powers(coef: float, k: int) -> np.ndarray:
    """coef^(n+1) for n in [0, k): the carry's contribution."""
    return (float(coef) ** (np.arange(k) + 1)).astype(np.float32)


def deemphasis_plain(x, mem, coef: float):
    """x: [B, N] f32, mem: [B] (y[-1]).  Returns (y [B, N], new mem)."""
    b, n0 = x.shape
    n = (n0 + BLOCK - 1) // BLOCK * BLOCK
    x = x.to(torch.float32)
    if n != n0:
        x = torch.nn.functional.pad(x, (0, n - n0))
    lt = const(("deemph_toeplitz_t", coef, BLOCK),
               lambda: _toeplitz(coef, BLOCK).T.copy(), x.device)
    pw = const(("deemph_powers", coef, BLOCK),
               lambda: _powers(coef, BLOCK), x.device)
    carry = mem.to(torch.float32)
    ys = []
    for blk in range(n // BLOCK):
        y = torch.matmul(x[:, blk * BLOCK:(blk + 1) * BLOCK], lt)
        y = y + carry[:, None] * pw[None, :]
        ys.append(y)
        carry = y[:, -1]
    y = torch.cat(ys, dim=1)
    if n != n0:
        return y[:, :n0], y[:, n0 - 1]
    return y, carry


def deemphasis(x, mem, coef: float):
    """Batched y[n] = x[n] + coef*y[n-1] (kernel K2 on the card)."""
    if x.device.type == "cpu":
        return deemphasis_plain(x, mem, coef)
    return _deemphasis_cuda(x, mem, coef)


def _deemphasis_cuda(x, mem, coef: float):
    import ctypes

    from ..cuda_build import check_launch, library

    global launches
    if not (x.is_cuda and mem.is_cuda and x.device == mem.device):
        raise ValueError("deemphasis: x and mem must be on one CUDA device")
    if x.dtype != torch.float32 or mem.dtype != torch.float32 \
            or x.dim() != 2 or mem.shape != (x.shape[0],):
        raise ValueError("deemphasis: x [B, N] f32 and mem [B] f32")
    x = x.contiguous()
    mem = mem.contiguous()
    b, n = x.shape
    y = torch.empty_like(x)
    mem_out = torch.empty_like(mem)
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.opus_deemphasis_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(mem.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(mem_out.data_ptr()),
        ctypes.c_int(b), ctypes.c_int(n), ctypes.c_float(coef),
        ctypes.c_void_p(stream))
    check_launch(rc, "deemphasis")
    launches += 1
    return y, mem_out
