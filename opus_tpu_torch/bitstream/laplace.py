"""Copy of the DRED Laplace coder of ``opus_tpu/bitstream/laplace.py``
(``laplace_encode_p0``, ``laplace_decode_p0`` and their table builder) for
the PyTorch port, which imports nothing of the JAX package (reference:
celt/laplace.c, ec_laplace_encode_p0 / ec_laplace_decode_p0).  Exact
32-bit integer arithmetic over a 15-bit probability space.
"""

from __future__ import annotations

from .range_coder import RangeDecoder, RangeEncoder


def _p0_icdf(decay: int):
    icdf = [max(7, decay)]
    for i in range(1, 7):
        icdf.append(max(7 - i, (icdf[i - 1] * decay) >> 15))
    icdf.append(0)
    return icdf


def laplace_encode_p0(enc: RangeEncoder, value: int, p0: int,
                      decay: int) -> None:
    """DRED variant with explicit zero probability ``p0`` (16-bit tables)."""
    sign_icdf = [32768 - p0, (32768 - p0) // 2, 0]
    s = 0 if value == 0 else (1 if value > 0 else 2)
    enc.enc_icdf16(s, sign_icdf, 15)
    value = abs(value)
    if value:
        icdf = _p0_icdf(decay)
        value -= 1
        while True:
            enc.enc_icdf16(min(value, 7), icdf, 15)
            value -= 7
            if value < 0:
                break


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
