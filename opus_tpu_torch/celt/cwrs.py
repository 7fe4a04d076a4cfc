"""Copy of ``opus_tpu/celt/cwrs.py`` for the PyTorch port, which imports
nothing of the JAX package.

CWRS: combinatorial index <-> pulse-vector codec for the PVQ codebooks
(reference: celt/cwrs.c).

V(N,K) = number of N-dim integer vectors with L1 norm K (signs on nonzero),
U(N,K) = number of those where the first element's |value| > 0 is counted
half-way; both obey U(N,K) = U(N-1,K) + U(N,K-1) + U(N-1,K-1).

The reference uses precomputed uint32 rows; here we build the exact table once
with unbounded Python ints (all values actually used fit in 32 bits by
construction — fits_in32() gates the pulse cache).
"""

from __future__ import annotations

from functools import lru_cache

BITRES = 3

# Table dimensions: largest band in any supported mode is 208 samples
# (custom-mode cap, celt/cwrs.c comment), K up to CELT_MAX_PULSES=128 plus
# the +2 slack used by the row recurrences.
_MAX_LO = 134   # min(N, K): K is capped at CELT_MAX_PULSES=128 (+ slack)
_MAX_HI = 212   # max(N, K): largest band is 208 samples (+ slack)


def _build_u_table():
    # stored as u[min][max] (U is symmetric)
    u = [[0] * (_MAX_HI + 1) for _ in range(_MAX_LO + 1)]
    u[0][0] = 1
    for k in range(1, _MAX_HI + 1):
        u[1][k] = 1
    def get(a, b):
        lo, hi = (a, b) if a < b else (b, a)
        return u[lo][hi]

    for n in range(2, _MAX_LO + 1):
        for k in range(n, _MAX_HI + 1):
            u[n][k] = get(n - 1, k) + get(n, k - 1) + get(n - 1, k - 1)
    return u


_U = _build_u_table()


def pvq_u(n: int, k: int) -> int:
    """U(N,K); symmetric, so stored/accessed as (min, max)."""
    lo, hi = (n, k) if n < k else (k, n)
    return _U[lo][hi]


def pvq_v(n: int, k: int) -> int:
    """V(N,K): size of the PVQ codebook."""
    return pvq_u(n, k) + pvq_u(n, k + 1)


def log2_frac(val: int, frac: int) -> int:
    """Ceil(log2(val)) in 1/2**frac-bit units (reference: celt/cwrs.c:45)."""
    l = val.bit_length()
    if val & (val - 1):
        if l > 16:
            val = ((val - 1) >> (l - 16)) + 1
        else:
            val <<= 16 - l
        l = (l - 1) << frac
        while True:
            b = val >> 16
            l += b << frac
            val = (val + b) >> b
            val = (val * val + 0x7FFF) >> 15
            frac -= 1
            if frac < 0:
                break
        return l + (1 if val > 0x8000 else 0)
    return (l - 1) << frac


@lru_cache(maxsize=None)
def get_required_bits(n: int, maxk: int, frac: int = BITRES) -> tuple:
    """bits[k] = log2_frac(V(n,k)) for k in 0..maxk."""
    assert maxk > 0
    return tuple([0] + [log2_frac(pvq_v(n, k), frac) for k in range(1, maxk + 1)])


def icwrs(y) -> int:
    """Pulse vector -> codebook index (reference: icwrs celt/cwrs.c:444)."""
    n = len(y)
    assert n >= 2
    j = n - 1
    i = 1 if y[j] < 0 else 0
    k = abs(y[j])
    while j > 0:
        j -= 1
        i += pvq_u(n - j, k)
        k += abs(y[j])
        if y[j] < 0:
            i += pvq_u(n - j, k + 1)
    return i


def cwrsi(n: int, k: int, i: int) -> list[int]:
    """Codebook index -> pulse vector (reference: cwrsi celt/cwrs.c:467)."""
    assert k > 0 and n > 1
    y = []
    while n > 2:
        if k >= n:
            # lots-of-pulses case
            p = pvq_u(n, k + 1)
            s = i >= p
            if s:
                i -= p
            k0 = k
            q = pvq_u(n, n)
            if q > i:
                k = n
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
            else:
                while True:
                    p = pvq_u(k, n)
                    if p <= i:
                        break
                    k -= 1
            i -= p
            val = k0 - k
            y.append(-val if s else val)
        else:
            # lots-of-dimensions case
            p = pvq_u(k, n)
            q = pvq_u(k + 1, n)
            if p <= i < q:
                i -= p
                y.append(0)
            else:
                s = i >= q
                if s:
                    i -= q
                k0 = k
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
                i -= p
                val = k0 - k
                y.append(-val if s else val)
        n -= 1
    # n == 2
    p = 2 * k + 1
    s = i >= p
    if s:
        i -= p
    k0 = k
    k = (i + 1) >> 1
    if k:
        i -= 2 * k - 1
    val = k0 - k
    y.append(-val if s else val)
    # n == 1
    val = -k if i else k
    y.append(val)
    return y


def encode_pulses(enc, y, n: int, k: int) -> None:
    assert k > 0
    enc.enc_uint(icwrs(y), pvq_v(n, k))


def decode_pulses(dec, n: int, k: int) -> list[int]:
    return cwrsi(n, k, dec.dec_uint(pvq_v(n, k)))
