"""The port's SILK fixed-point helpers (opus_tpu_torch/ops/silk_fixed.py,
int64 arithmetic with an explicit wrap to int32) against the JAX package's
int32-lane versions (opus_tpu/ops/silk_fixed.py and the 64-bit limb
helpers of opus_tpu/models/fused_silk_dec.py) on seeded random and
boundary int32 inputs.  Every output must be identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import opus_tpu.models.fused_silk_dec as JF
import opus_tpu.ops.silk_fixed as J
from opus_tpu_torch.ops import silk_fixed as P

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
EDGES = np.asarray([0, 1, -1, 2, -2, 32767, -32767, -32768, 32768, 65535,
                    65536, -65536, I32_MIN, I32_MAX, I32_MIN + 1,
                    I32_MAX - 1, 1 << 30, -(1 << 30), (1 << 30) - 1],
                   np.int64)


def _pairs(seed, n=4096, b_int16=False):
    """Boundary x boundary pairs, then n seeded random pairs."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.repeat(EDGES, len(EDGES)),
                        rng.integers(I32_MIN, I32_MAX + 1, n)])
    if b_int16:
        e16 = EDGES[(EDGES >= -32768) & (EDGES <= 32767)]
        b = np.concatenate([np.resize(e16, len(EDGES) ** 2),
                            rng.integers(-32768, 32768, n)])
    else:
        b = np.concatenate([np.tile(EDGES, len(EDGES)),
                            rng.integers(I32_MIN, I32_MAX + 1, n)])
    return a, b


def _j(x):
    return jnp.asarray(np.asarray(x, np.int64).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _eq(got, ref, mask=None):
    got = got.numpy().astype(np.int64)
    ref = np.asarray(ref).astype(np.int64)
    if mask is not None:
        got, ref = got[mask], ref[mask]
    bad = np.nonzero(got != ref)[0]
    assert bad.size == 0, (bad[:5], got[bad[:5]], ref[bad[:5]])


@pytest.mark.parametrize("b_int16", [True, False])
def test_torch_silk_fixed_products(b_int16):
    a, b = _pairs(1, b_int16=b_int16)
    _eq(P.smulwb(_t(a), _t(b)), J.smulwb(_j(a), _j(b)))
    _eq(P.smulww(_t(a), _t(b)), J.smulww(_j(a), _j(b)))
    _eq(P.smmul(_t(a), _t(b)), J.smmul(_j(a), _j(b)))
    _eq(P.add_sat32(_t(a), _t(b)), J.add_sat32(_j(a), _j(b)))


def test_torch_silk_fixed_shifts_and_saturation():
    a, _b = _pairs(2)
    ta, ja = _t(a), _j(a)
    _eq(P.sat16(ta), J.sat16(ja))
    _eq(P.clz32(ta), J.clz32(ja))
    for s in (0, 1, 4, 15, 31):
        _eq(P.lshift_sat32(ta, s), J.lshift_sat32(ja, s))
    for s in (1, 2, 4, 8, 12, 16, 31):
        _eq(P.rshift_round(ta, s), J.rshift_round(ja, s))
    rng = np.random.default_rng(3)
    for counts in (np.full(len(a), 0), np.full(len(a), 31),
                   np.full(len(a), 32), np.full(len(a), 40),
                   rng.integers(0, 48, len(a))):
        _eq(P.lshift_sat32_dyn(ta, _t(counts)),
            J.lshift_sat32_dyn(ja, _j(counts)))
    x = np.concatenate([np.arange(-200, 4200), a])
    _eq(P.log2lin(_t(x)), J.log2lin(_j(x)))


def test_torch_silk_fixed_division_and_inverse():
    """div32, inverse32_varq (static and per-lane qres) and div32_varq.
    Lanes whose divisor is 0 (a zero b, or b = 0 / INT32_MIN normalised to
    a zero denominator) are undefined in XLA and are discarded by every
    caller: they are only required not to raise."""
    a, b = _pairs(4)
    ta, tb = _t(a), _t(b)
    _eq(P.div32(ta, tb), jnp.asarray(J.div32(_j(a), _j(np.where(b == 0, 1,
                                                                 b)))),
        mask=b != 0)
    assert P.div32(_t([5, 7]), _t([0, 2])).tolist()[1] == 3
    ok_b = (b != 0) & (b != I32_MIN)
    for q in (16, 30, 47, 61, 62):
        _eq(P.inverse32_varq(tb, q), J.inverse32_varq(_j(b), q), mask=ok_b)
    q = np.random.default_rng(5).integers(0, 70, len(b))
    _eq(P.inverse32_varq(tb, _t(q)), JF._inverse32_varq_dyn(_j(b), _j(q)),
        mask=ok_b)
    for q in (0, 14, 16, 29):
        _eq(P.div32_varq(ta, tb, q), J.div32_varq(_j(a), _j(b), q),
            mask=ok_b)


def test_torch_silk_fixed_64bit_helpers():
    """The JAX limb helpers (mul64 + rshift_round64 / shr64, _sub64 +
    _sat32_64, _rshift_round64_checked) against int64 arithmetic, with
    the product 2**62 = INT32_MIN**2 at shift 63, where the rounding sum
    leaves int64 and both sides must wrap alike."""
    a, b = _pairs(6)
    rng = np.random.default_rng(7)
    s = rng.integers(1, 64, len(a))
    a = np.concatenate([a, [I32_MIN, I32_MIN, I32_MAX]])
    b = np.concatenate([b, [I32_MIN, I32_MIN, I32_MIN]])
    s = np.concatenate([s, [63, 62, 63]])
    v = _t(a) * _t(b)
    hi, lo = J.mul64(_j(a), _j(b))
    _eq(P.rshift_round64(v, _t(s)), J.rshift_round64(hi, lo, _j(s)))
    for k in (1, 16, 31):
        _eq(P.rshift_round64(v, k), J.rshift_round64(hi, lo, k))
    val, fits = P.rshift_round64_checked(v, _t(s))
    jval, jfits = JF._rshift_round64_checked(hi, lo, _j(s))
    _eq(val, jval)
    _eq(fits.to(torch.int64), np.asarray(jfits).astype(np.int64))
    sh = rng.integers(0, 64, len(a))
    _eq(P.w32(v >> _t(sh)), J.shr64(hi, lo, _j(sh)))
    fhi, flo = JF._shr64_full(hi, lo, _j(sh))
    full = (np.asarray(fhi).astype(np.int64) << 32) \
        | np.asarray(flo).astype(np.int64)
    _eq(v >> _t(sh), full)
    sat = P.sat32(_t(a) - (v >> 31))
    _eq(sat, JF._sat32_64(*JF._sub64(JF._ext64(_j(a)), (hi, lo), shift=31)))
