"""SILK fixed-point macros as int32-exact torch ops.

Port of ``opus_tpu/ops/silk_fixed.py`` (reference: silk/SigProc_FIX.h,
macros.h, Inlines.h).  Every value is an int64 tensor holding an int32
value.  The JAX module emulates 64-bit intermediates with uint32 limbs
because a TPU has no int64; here a 32x32 product fits int64 exactly, so
the products are plain int64 multiplies and ``w32`` wraps back to int32
wherever the reference (and the JAX code) wraps.  Adds, subtracts,
multiplies and left shifts commute with the wrap, so ``w32`` is needed
only before what does not: right shifts, compares, divisions, selects.

Traps where torch and XLA differ, and what is done about them:

- ``//`` floors, ``jax.lax.div`` truncates: ``div32`` uses
  ``rounding_mode="trunc"``.
- Integer division by zero raises on the CPU and is undefined on the
  card, while XLA defines it: every divisor that can be 0 on a lane whose
  result is discarded is replaced by 1 there.
- A uint32 shift by >= 32 gives 0 under XLA: ``shl32`` keeps that meaning
  with the count kept in range.
"""

from __future__ import annotations

import torch

I32_MAX = 2147483647
I32_MIN = -2147483648
M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)


def w32(x):
    """Wrap an int64 tensor to the int32 value with the same low 32 bits."""
    return ((x + (1 << 31)) & M32) - (1 << 31)


def shl32(x, s):
    """XLA's ``(x.astype(uint32) << s.astype(uint32)).astype(int32)``: 0
    for a count outside [0, 32)."""
    if not torch.is_tensor(s):
        return w32(x << s) if 0 <= s < 32 else torch.zeros_like(x)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, w32(x << torch.where(ok, s, 0)), 0)


def smulwb(a, b):
    """(a32 * b.int16) >> 16; the JAX split form, value-exact for int16 b
    and wrapped as the JAX code wraps for any other b."""
    return w32(w32((a >> 16) * b) + (w32((a & 0xFFFF) * b) >> 16))


def smulww(a, b):
    """(a32 * b32) >> 16, wrapped to int32 (the reference keeps the low 32
    bits of the 64-bit product's shift)."""
    return w32((a * b) >> 16)


def smmul(a, b):
    """(a*b) >> 32, signed (silk_SMMUL)."""
    return (a * b) >> 32


def sat16(a):
    return a.clamp(-32768, 32767)


def sat32(a):
    """silk_SAT32 of an int64 value."""
    return a.clamp(I32_MIN, I32_MAX)


def add_sat32(a, b):
    return sat32(a + b)


def lshift_sat32(a, shift: int):
    hi = I32_MAX >> shift
    lo = I32_MIN >> shift
    return torch.where(a > hi, I32_MAX,
                       torch.where(a < lo, I32_MIN, a << shift))


def lshift_sat32_dyn(a, shift):
    """LSHIFT_SAT32 with a per-lane shift; counts outside [0, 32) act as
    XLA's uint32 shift by >= 32 (limits 0 and -1, shifted value 0)."""
    sh = torch.where((shift < 0) | (shift > 32), 32, shift)
    hi = I32_MAX >> sh
    lo = I32_MIN >> sh
    return torch.where(a > hi, I32_MAX,
                       torch.where(a < lo, I32_MIN, shl32(a, sh)))


def rshift_round(a, shift: int):
    if shift == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (shift - 1)) + 1) >> 1


def _round_shift64(v, s):
    """(v + (1 << (s-1))) >> s for an int64 v and count s in [1, 63], the
    sum wrapped mod 2**64 as the JAX limb form wraps it (it leaves int64
    only for v near 2**62 with s = 63)."""
    if torch.is_tensor(s):
        s = s.clamp(1, 63)            # other counts only on discarded lanes
        r = torch.ones_like(v) << (s - 1)
    else:
        r = torch.full_like(v, 1 << (s - 1))
    ovf = v > (2 ** 63 - 1) - r
    # v + r - 2**64 computed as (v - 2**63) + (r - 2**63), both in range
    t = torch.where(ovf, (v + _I64_MIN) + (r + _I64_MIN), v + r)
    return t >> s


def rshift_round64(v, s):
    """RSHIFT_ROUND64 of an int64 value by s >= 1: the low 32 bits."""
    return w32(_round_shift64(v, s))


def rshift_round64_checked(v, s):
    """RSHIFT_ROUND64 returning (low-32 value, fits-in-int32 flag)."""
    r = _round_shift64(v, s)
    val = w32(r)
    return val, r == val


def clz32(x):
    """Leading zeros of the low 32 bits (32 for 0)."""
    u = (x & M32).to(torch.float64)
    return 32 - torch.frexp(u).exponent.to(torch.int64)


def div32(a, b):
    """C-style truncating int32 division (silk_DIV32_16 / silk_DIV32); a
    zero divisor gives a (callers discard that lane)."""
    b = torch.where(b == 0, 1, b)
    return w32(torch.div(a, b, rounding_mode="trunc"))


def inverse32_varq(b32, qres):
    """silk_INVERSE32_varQ (Inlines.h:139); qres an int or per-lane."""
    absb = torch.where(b32 > 0, b32, -b32)
    b_headrm = clz32(absb) - 1
    b32_nrm = shl32(b32, b_headrm)
    b32_inv = div32(torch.full_like(b32, 0x7FFFFFFF >> 2), b32_nrm >> 16)
    result = w32(b32_inv << 16)
    err_q32 = w32(((1 << 29) - smulwb(b32_nrm, b32_inv)) << 3)
    result = w32(result + smulww(err_q32, b32_inv))
    lshift = 61 - b_headrm - qres
    le0 = lshift <= 0
    sat = lshift_sat32_dyn(result, torch.where(le0, (-lshift).clamp_max(31),
                                               0))
    shifted = result >> torch.where((~le0) & (lshift < 32), lshift, 31)
    return torch.where(le0, sat, torch.where(lshift < 32, shifted, 0))


def div32_varq(a32, b32, qres: int):
    """silk_DIV32_varQ (Inlines.h:93)."""
    absa = torch.where(a32 > 0, a32, -a32)
    a_headrm = clz32(absa) - 1
    a32_nrm = shl32(a32, a_headrm)
    absb = torch.where(b32 > 0, b32, -b32)
    b_headrm = clz32(absb) - 1
    b32_nrm = shl32(b32, b_headrm)
    b32_inv = div32(torch.full_like(b32, 0x7FFFFFFF >> 2), b32_nrm >> 16)
    result = smulwb(a32_nrm, b32_inv)
    a32_nrm = w32(a32_nrm - (smmul(b32_nrm, result) << 3))
    result = w32(result + smulwb(a32_nrm, b32_inv))
    lshift = 29 + a_headrm - b_headrm - qres
    lt0 = lshift < 0
    sat = lshift_sat32_dyn(result, torch.where(lt0, (-lshift).clamp_max(31),
                                               0))
    shifted = result >> torch.where((~lt0) & (lshift < 32), lshift, 31)
    return torch.where(lt0, sat, torch.where(lshift < 32, shifted, 0))


def log2lin(in_log_q7):
    """silk_log2lin, exact int32 (silk/log2lin.c)."""
    neg = in_log_q7 < 0
    big = in_log_q7 >= 3967
    v = in_log_q7.clamp(0, 3966)
    out = torch.ones_like(v) << (v >> 7)
    frac_q7 = v & 0x7F
    poly = frac_q7 + ((frac_q7 * (128 - frac_q7) * -174) >> 16)
    out2 = torch.where(v < 2048, out + ((out * poly) >> 7),
                       out + (out >> 7) * poly)
    return torch.where(neg, 0, torch.where(big, I32_MAX, out2))


def wrap16(x):
    """The int16 value with the same low 16 bits."""
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def smulbb(a, b):
    """silk_SMULBB: the int16 parts of a and b multiplied."""
    return wrap16(a) * wrap16(b)


RAND_A = 196314165
RAND_C = 907633515


def silk_rand(seed):
    """silk_RAND (SigProc_FIX.h): one step of SILK's LCG, int32 values."""
    return w32(RAND_C + seed * RAND_A)


def _rand_table(n: int):
    """[2, n] int64: after k + 1 steps of silk_RAND the state is (A[k] seed
    + C[k]) mod 2**32, with A[k] = a**(k+1) and C[k] = c (a**(k+1) - 1) /
    (a - 1), both mod 2**32."""
    import numpy as np
    out = np.zeros((2, n), np.int64)
    a, c = 1, 0
    for k in range(n):
        a, c = (RAND_A * a) & M32, (RAND_A * c + RAND_C) & M32
        out[0, k], out[1, k] = a, c
    return out


def _mulu32(s, a):
    """(s a) mod 2**32 for s, a in [0, 2**32) as int64, a split in 16-bit
    halves so that no product passes 2**48."""
    return (s * (a & 0xFFFF) + (((s * (a >> 16)) & 0xFFFF) << 16)) & M32


def silk_rand_seq(seed, n: int):
    """The n states that n steps of silk_RAND pass through from ``seed``
    [B] (int32 values), in closed form: [B, n] int32 values, state k the
    seed after k + 1 steps.  One gather-free product a sample, no chain."""
    from .device_cache import const
    tab = const(("silk_rand", n), lambda: _rand_table(n), seed.device)
    return w32(_mulu32((seed & M32)[:, None], tab[0]) + tab[1])


def sum_sqr_shift(x):
    """silk_sum_sqr_shift (sum_sqr_shift.c) over the last axis of x [B, n]
    (int16 values): (energy [B], shift [B]) with the energy < 2**31 after
    the shift.  Both passes shift each pair's sum of squares before adding
    it, as the reference does, so the int64 sums are exact in any order."""
    n = x.shape[1]
    sq = x * x
    terms = sq[:, 0:n - 1:2] + sq[:, 1:n:2]
    if n % 2:
        terms = torch.cat([terms, sq[:, n - 1:]], dim=1)
    shft0 = 31 - (32 - int(n).bit_length())
    nrg = n + (terms >> shft0).sum(1)
    shft = (shft0 + 3 - clz32(nrg)).clamp_min(0)
    return (terms >> shft[:, None]).sum(1), shft


def sqrt_approx(x):
    """silk_SQRT_APPROX (Inlines.h): 0 for x <= 0."""
    pos = x > 0
    u = torch.where(pos, x, 1) & M32
    lz = clz32(u)
    frac = torch.where(lz <= 24, u >> (24 - lz).clamp_min(0),
                       u << (lz - 24).clamp_min(0)) & 0x7F
    y = torch.where((lz & 1) != 0, 32768, 46214) >> (lz >> 1)
    y = y + ((y * (213 * frac)) >> 16)
    return torch.where(pos, y, 0)


def bwexpander(ar, chirp_q16: int):
    """silk_bwexpander (bwexpander.c), the 16-bit one, over [B, d] with one
    chirp for every lane: coefficient i scaled by the chirp's i-th power
    in Q16, rounded and wrapped to int16."""
    d = ar.shape[1]
    chirps = []
    c = chirp_q16
    for _ in range(d):
        chirps.append(c)
        c += ((c * (chirp_q16 - 65536) >> 15) + 1) >> 1
    cv = torch.as_tensor(chirps, dtype=torch.int64, device=ar.device)
    return wrap16(rshift_round(ar * cv[None, :], 16))
