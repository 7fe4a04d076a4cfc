"""Copy of the DRED Laplace decoder of ``opus_tpu/bitstream/laplace.py``
(``laplace_decode_p0`` and its table builder) for the PyTorch port, which
imports nothing of the JAX package (reference: celt/laplace.c,
ec_laplace_decode_p0).  Exact 32-bit integer arithmetic over a 15-bit
probability space.
"""

from __future__ import annotations

from .range_coder import RangeDecoder


def _p0_icdf(decay: int):
    icdf = [max(7, decay)]
    for i in range(1, 7):
        icdf.append(max(7 - i, (icdf[i - 1] * decay) >> 15))
    icdf.append(0)
    return icdf


def laplace_decode_p0(dec: RangeDecoder, p0: int, decay: int) -> int:
    sign_icdf = [32768 - p0, (32768 - p0) // 2, 0]
    s = dec.dec_icdf16(sign_icdf, 15)
    if s == 2:
        s = -1
    if s != 0:
        icdf = _p0_icdf(decay)
        value = 1
        while True:
            v = dec.dec_icdf16(icdf, 15)
            value += v
            if v != 7:
                break
        return s * value
    return 0
