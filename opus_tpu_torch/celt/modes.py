"""Copy of ``opus_tpu/celt/modes.py`` for the PyTorch port, which imports
nothing of the JAX package.

CELT mode construction: band layout, allocation matrix, window, pulse cache
(reference: celt/modes.c, celt/rate.c compute_pulse_cache).

Modes are built at import/first-use time from the same deterministic integer
algorithms the reference uses offline (celt/dump_modes/); nothing is loaded
from the reference's generated static tables.  The standard Opus modes are the
48 kHz family (2.5/5/10/20 ms); custom Fs/frame sizes are supported like
CUSTOM_MODES.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from .cwrs import BITRES, get_required_bits, log2_frac

MAX_PSEUDO = 40
LOG_MAX_PSEUDO = 6
CELT_MAX_PULSES = 128
MAX_FINE_BITS = 8
FINE_OFFSET = 21
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
MAX_PERIOD = 1024

# 21 standard bands at 2.5 ms/48 kHz resolution (RFC 6716 table; modes.c:42)
EBAND5MS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40,
            48, 60, 78, 100)

# Bit allocation matrix, 1/32 bit/sample units (modes.c:50)
BITALLOC_SIZE = 11
BAND_ALLOCATION = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    90, 80, 75, 69, 63, 56, 49, 40, 34, 29, 20, 18, 10, 0, 0, 0, 0, 0, 0, 0, 0,
    110, 100, 90, 84, 78, 71, 65, 58, 51, 45, 39, 32, 26, 20, 12, 0, 0, 0, 0, 0, 0,
    118, 110, 103, 93, 86, 80, 75, 70, 65, 59, 53, 47, 40, 31, 23, 15, 4, 0, 0, 0, 0,
    126, 119, 112, 104, 95, 89, 83, 78, 72, 66, 60, 54, 47, 39, 32, 25, 17, 12, 1, 0, 0,
    134, 127, 120, 114, 103, 97, 91, 85, 78, 72, 66, 60, 54, 47, 41, 35, 29, 23, 16, 10, 1,
    144, 137, 130, 124, 113, 107, 101, 95, 88, 82, 76, 70, 64, 57, 51, 45, 39, 33, 26, 15, 1,
    152, 145, 138, 132, 123, 117, 111, 105, 98, 92, 86, 80, 74, 67, 61, 55, 49, 43, 36, 20, 1,
    162, 155, 148, 142, 133, 127, 121, 115, 108, 102, 96, 90, 84, 77, 71, 65, 59, 53, 46, 30, 1,
    172, 165, 158, 152, 143, 137, 131, 125, 118, 112, 106, 100, 94, 87, 81, 75, 69, 63, 56, 45, 20,
    200, 200, 200, 200, 200, 200, 200, 200, 198, 193, 188, 183, 178, 173, 168, 163, 158, 153, 148, 129, 104,
)

# Bark critical-band edges for custom-mode band layout (modes.c:83)
_BARK_FREQ = (0, 100, 200, 300, 400, 510, 630, 770, 920, 1080, 1270, 1480,
              1720, 2000, 2320, 2700, 3150, 3700, 4400, 5300, 6400, 7700,
              9500, 12000, 15500, 20000)
_BARK_BANDS = 25


def get_pulses(i: int) -> int:
    """Pseudo-pulse index -> actual pulse count (rate.h:48)."""
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def _fits_in32(n: int, k: int) -> bool:
    max_n = (32767, 32767, 32767, 1476, 283, 109, 60, 40, 29, 24, 20, 18, 16, 14, 13)
    max_k = (32767, 32767, 32767, 32767, 1172, 238, 95, 53, 36, 27, 22, 18, 16, 15, 13)
    if n >= 14:
        if k >= 14:
            return False
        return n <= max_n[k]
    return k <= max_k[n]


@dataclass
class PulseCache:
    size: int
    index: np.ndarray   # int16 [(LM+2) * nbEBands]
    bits: np.ndarray    # uint8 [size]
    caps: np.ndarray    # uint8 [(LM+1) * 2 * nbEBands]


@dataclass
class CeltMode:
    Fs: int
    overlap: int
    nbEBands: int
    effEBands: int
    preemph: tuple
    eBands: tuple        # nbEBands+1 (custom modes carry +2 in ref; +1 used)
    maxLM: int
    nbShortMdcts: int
    shortMdctSize: int
    nbAllocVectors: int
    allocVectors: np.ndarray    # uint8 [nbAllocVectors, nbEBands]
    logN: tuple
    window: np.ndarray          # float32 [overlap]
    cache: PulseCache
    qext_cache: PulseCache | None = None

    @property
    def frame_size(self) -> int:
        return self.shortMdctSize * self.nbShortMdcts


def _compute_ebands(fs: int, frame_size: int, res: int) -> list[int]:
    """Band layout for custom modes (modes.c:90)."""
    if fs == 400 * frame_size:
        return list(EBAND5MS)
    nbark = 1
    while nbark < _BARK_BANDS and _BARK_FREQ[nbark + 1] * 2 < fs:
        nbark += 1
    lin = 0
    while lin < nbark and _BARK_FREQ[lin + 1] - _BARK_FREQ[lin] < res:
        lin += 1
    low = (_BARK_FREQ[lin] + res // 2) // res
    high = nbark - lin
    nb = low + high
    ebands = [0] * (nb + 2)
    for i in range(low):
        ebands[i] = i
    offset = ebands[low - 1] * res - _BARK_FREQ[lin - 1] if low > 0 else 0
    for i in range(high):
        target = _BARK_FREQ[lin + i]
        ebands[i + low] = (target + offset // 2 + res) // (2 * res) * 2
        offset = ebands[i + low] * res - target
    for i in range(nb):
        if ebands[i] < i:
            ebands[i] = i
    ebands[nb] = (_BARK_FREQ[nbark] + res) // (2 * res) * 2
    if ebands[nb] > frame_size:
        ebands[nb] = frame_size
    for i in range(1, nb - 1):
        if ebands[i + 1] - ebands[i] < ebands[i] - ebands[i - 1]:
            ebands[i] -= (2 * ebands[i] - ebands[i - 1] - ebands[i + 1]) // 2
    # remove empty bands
    j = 0
    for i in range(nb):
        if ebands[i + 1] > ebands[j]:
            j += 1
            ebands[j] = ebands[i + 1]
    return ebands[:j + 1]


def _compute_allocation_table(fs: int, short_mdct_size: int,
                              ebands: list[int]) -> np.ndarray:
    nb = len(ebands) - 1
    max_bands = len(EBAND5MS) - 1
    table = np.zeros((BITALLOC_SIZE, nb), dtype=np.uint8)
    if fs == 400 * short_mdct_size:
        return np.array(BAND_ALLOCATION, dtype=np.uint8).reshape(BITALLOC_SIZE, max_bands)
    for i in range(BITALLOC_SIZE):
        for j in range(nb):
            k = 0
            while k < max_bands:
                if 400 * EBAND5MS[k] > ebands[j] * fs // short_mdct_size:
                    break
                k += 1
            if k > max_bands - 1:
                table[i, j] = BAND_ALLOCATION[i * max_bands + max_bands - 1]
            else:
                a1 = ebands[j] * fs // short_mdct_size - 400 * EBAND5MS[k - 1]
                a0 = 400 * EBAND5MS[k] - ebands[j] * fs // short_mdct_size
                table[i, j] = ((a0 * BAND_ALLOCATION[i * max_bands + k - 1]
                                + a1 * BAND_ALLOCATION[i * max_bands + k])
                               // (a0 + a1))
    return table


def compute_pulse_cache(ebands: list[int], lm: int, logn: list[int]) -> PulseCache:
    """Per-band-size PVQ bit tables + caps (reference: rate.c:74)."""
    nb = len(ebands) - 1
    cindex = np.full((lm + 2) * nb, -1, dtype=np.int16)
    entries = []  # (N, K, offset)
    curr = 0
    for i in range(lm + 2):
        for j in range(nb):
            n = (ebands[j + 1] - ebands[j]) << i >> 1
            cindex[i * nb + j] = -1
            found = False
            for k in range(i + 1):
                lim = nb if k != i else j
                for m in range(lim):
                    if n == (ebands[m + 1] - ebands[m]) << k >> 1:
                        cindex[i * nb + j] = cindex[k * nb + m]
                        found = True
                        break
                if found:
                    break
            if cindex[i * nb + j] == -1 and n != 0:
                k = 0
                while k < MAX_PSEUDO and _fits_in32(n, get_pulses(k + 1)):
                    k += 1
                entries.append((n, k, curr))
                cindex[i * nb + j] = curr
                curr += k + 1
    bits = np.zeros(curr, dtype=np.uint8)
    for n, k, off in entries:
        tmp = get_required_bits(n, get_pulses(k), BITRES)
        for j in range(1, k + 1):
            bits[off + j] = tmp[get_pulses(j)] - 1
        bits[off] = k

    caps = np.zeros((lm + 1) * 2 * nb, dtype=np.uint8)
    ci = 0
    for i in range(lm + 1):
        for c in (1, 2):
            for j in range(nb):
                n0 = ebands[j + 1] - ebands[j]
                if n0 << i == 1:
                    max_bits = c * (1 + MAX_FINE_BITS) << BITRES
                else:
                    lm0 = 0
                    if n0 > 2:
                        n0 >>= 1
                        lm0 -= 1
                    elif n0 <= 1:
                        lm0 = min(i, 1)
                        n0 <<= lm0
                    pc = cindex[(lm0 + 1) * nb + j]
                    max_bits = int(bits[pc + bits[pc]]) + 1
                    n = n0
                    for k in range(i - lm0):
                        max_bits <<= 1
                        offset = ((logn[j] + ((lm0 + k) << BITRES)) >> 1) - QTHETA_OFFSET
                        num = 459 * ((2 * n - 1) * offset + max_bits)
                        den = ((2 * n - 1) << 9) - 459
                        qb = min((num + (den >> 1)) // den, 57)
                        assert qb >= 0
                        max_bits += qb
                        n <<= 1
                    if c == 2:
                        max_bits <<= 1
                        offset = ((logn[j] + (i << BITRES)) >> 1) - \
                            (QTHETA_OFFSET_TWOPHASE if n == 2 else QTHETA_OFFSET)
                        ndof = 2 * n - 1 - (1 if n == 2 else 0)
                        fac = 512 if n == 2 else 487
                        num = fac * (max_bits + ndof * offset)
                        den = (ndof << 9) - fac
                        qb = min((num + (den >> 1)) // den, 64 if n == 2 else 61)
                        assert qb >= 0
                        max_bits += qb
                    ndof = c * n + (1 if (c == 2 and n > 2) else 0)
                    offset = ((logn[j] + (i << BITRES)) >> 1) - FINE_OFFSET
                    if n == 2:
                        offset += (1 << BITRES) >> 2
                    num = max_bits + ndof * offset
                    den = (ndof - 1) << BITRES
                    qb = min((num + (den >> 1)) // den, MAX_FINE_BITS)
                    assert qb >= 0
                    max_bits += c * qb << BITRES
                max_bits = (4 * max_bits // (c * ((ebands[j + 1] - ebands[j]) << i))) - 64
                assert 0 <= max_bits < 256
                caps[ci] = max_bits
                ci += 1
    return PulseCache(size=curr, index=cindex, bits=bits, caps=caps)


def _preemph_coefs(fs: int) -> tuple:
    if fs == 96000:
        return (0.9230041504, 0.2200012207, 1.5128347184, 0.6610107422)
    if fs < 12000:
        return (0.3500061035, -0.1799926758, 0.2719968125, 3.6765136719)
    if fs < 24000:
        return (0.6000061035, -0.1799926758, 0.4424998650, 2.2598876953)
    if fs < 40000:
        return (0.7799987793, -0.1000061035, 0.7499771125, 1.3333740234)
    return (0.8500061035, 0.0, 1.0, 1.0)


def _vorbis_window(overlap: int) -> np.ndarray:
    i = np.arange(overlap, dtype=np.float64)
    inner = np.sin(0.5 * math.pi * (i + 0.5) / overlap)
    return (np.sin(0.5 * math.pi * inner * inner)).astype(np.float32)


@lru_cache(maxsize=None)
def mode_create(fs: int, frame_size: int) -> CeltMode:
    """Build a CELT mode (reference: opus_custom_mode_create modes.c:227).

    The standard modes are fs=48000 frame_size in {120,240,480,960} (and the
    QEXT 96 kHz family); any (fs, frame_size) valid for CUSTOM_MODES works.
    """
    if not (8000 <= fs <= 96000):
        raise ValueError("bad Fs")
    if not (40 <= frame_size <= 2048) or frame_size % 2:
        raise ValueError("bad frame size")
    if frame_size * 1000 < fs:
        raise ValueError("frames under 1 ms unsupported")

    if frame_size * 75 >= fs and frame_size % 16 == 0:
        lm = 3
    elif frame_size * 150 >= fs and frame_size % 8 == 0:
        lm = 2
    elif frame_size * 300 >= fs and frame_size % 4 == 0:
        lm = 1
    else:
        lm = 0
    if (frame_size >> lm) * 300 > fs:
        raise ValueError("shorts longer than 3.3 ms unsupported")

    nb_short_mdcts = 1 << lm
    short_mdct_size = frame_size // nb_short_mdcts
    res = (fs + short_mdct_size) // (2 * short_mdct_size)

    ebands = _compute_ebands(fs, short_mdct_size, res)
    nb_ebands = len(ebands) - 1
    if (ebands[nb_ebands] - ebands[nb_ebands - 1]) << lm > 208:
        raise ValueError("band too large for PVQ")

    eff_ebands = nb_ebands
    while ebands[eff_ebands] > short_mdct_size:
        eff_ebands -= 1

    overlap = (short_mdct_size >> 2) << 2
    alloc = _compute_allocation_table(fs, short_mdct_size, ebands)
    logn = [log2_frac(ebands[i + 1] - ebands[i], BITRES) for i in range(nb_ebands)]
    cache = compute_pulse_cache(ebands, lm, logn)

    return CeltMode(
        Fs=fs, overlap=overlap, nbEBands=nb_ebands, effEBands=eff_ebands,
        preemph=_preemph_coefs(fs), eBands=tuple(ebands), maxLM=lm,
        nbShortMdcts=nb_short_mdcts, shortMdctSize=short_mdct_size,
        nbAllocVectors=BITALLOC_SIZE, allocVectors=alloc, logN=tuple(logn),
        window=_vorbis_window(overlap), cache=cache)


# ---------------------------------------------------------------------------
# QEXT: extra high-frequency bands above the nominal 20 kHz limit
# (reference: compute_qext_mode modes.c:501, qext_eBands modes.c:486-499)

NB_QEXT_BANDS = 14

# Band edges in shortMdctSize units covering 20-48 kHz.  The _240 layout is
# used when shortMdctSize*48000 == 120*Fs (48 kHz/120 and 96 kHz/240 modes);
# _180 when shortMdctSize*48000 == 90*Fs.
_QEXT_EBANDS_240 = (100, 110, 120, 130, 140, 150, 160, 170, 180, 190, 200,
                    210, 220, 230, 240)
_QEXT_LOGN_240 = (27,) * 14
_QEXT_EBANDS_180 = (74, 82, 90, 98, 106, 114, 122, 130, 138, 146, 154, 162,
                    168, 174, 180)
_QEXT_LOGN_180 = (24,) * 12 + (21, 21)

_QEXT_MODES: dict = {}


def compute_qext_mode(m: CeltMode) -> CeltMode:
    """Derive the extension-band mode from a base mode (reference:
    compute_qext_mode modes.c:501).  The qext mode shares everything with
    the base except the band layout (14 bands over 20-48 kHz) and its own
    PVQ pulse cache."""
    key = (m.Fs, m.shortMdctSize, m.maxLM)
    hit = _QEXT_MODES.get(key)
    if hit is not None:
        return hit
    if m.shortMdctSize * 48000 == 120 * m.Fs:
        ebands, logn = _QEXT_EBANDS_240, _QEXT_LOGN_240
    elif m.shortMdctSize * 48000 == 90 * m.Fs:
        ebands, logn = _QEXT_EBANDS_180, _QEXT_LOGN_180
    else:
        raise ValueError("mode has no QEXT band layout")
    eff = NB_QEXT_BANDS
    while ebands[eff] > m.shortMdctSize:
        eff -= 1
    cache = compute_pulse_cache(list(ebands), m.maxLM, list(logn))
    qm = CeltMode(
        Fs=m.Fs, overlap=m.overlap, nbEBands=NB_QEXT_BANDS, effEBands=eff,
        preemph=m.preemph, eBands=ebands, maxLM=m.maxLM,
        nbShortMdcts=m.nbShortMdcts, shortMdctSize=m.shortMdctSize,
        nbAllocVectors=0, allocVectors=None, logN=logn,
        window=m.window, cache=cache)
    _QEXT_MODES[key] = qm
    return qm


def bits2pulses(mode: CeltMode, band: int, lm: int, bits: int) -> int:
    """Bisection over the per-band bit cache (rate.h:54)."""
    lm += 1
    cache = mode.cache.bits
    off = int(mode.cache.index[lm * mode.nbEBands + band])
    lo = 0
    hi = int(cache[off])
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if int(cache[off + mid]) >= bits:
            hi = mid
        else:
            lo = mid
    lo_bits = -1 if lo == 0 else int(cache[off + lo])
    if bits - lo_bits <= int(cache[off + hi]) - bits:
        return lo
    return hi


def pulses2bits(mode: CeltMode, band: int, lm: int, pulses: int) -> int:
    lm += 1
    off = int(mode.cache.index[lm * mode.nbEBands + band])
    return 0 if pulses == 0 else int(mode.cache.bits[off + pulses]) + 1
