"""The port's [B]-lane range encoder (opus_tpu_torch/ops/rc_enc_kernel.py)
against the JAX package's kernel-safe encoder (opus_tpu/ops/rc_enc_kernel.py
+ its ``finalize``, run under tests/np_shim) and the scalar coder
(opus_tpu/bitstream/range_coder.py) on the masked op-sequence fuzz of
tests/test_rc_enc_kernel.py: encode, bit_logp, icdf, raw bits and uint
with carries.  Bytes, final range and the error flag are integers and must
be identical; a buffer too small for the stream sets the error flag on
both sides the same way."""

import numpy as np
import pytest
import torch

from opus_tpu_torch.ops import rc_enc_kernel as TE

from test_range_vec import ICDF_T, _gen, _py_encode


def _drive(mod, kinds, active, params, values, B, S, dry=False):
    """One op sequence through either encoder module (same API)."""
    if mod is TE:
        e = TE.re_init(B, "cpu")
        dig, end = TE.page_bufs(B, S, "cpu")
        arr = lambda a: torch.as_tensor(np.asarray(a, np.int64))  # noqa
    else:
        e = mod.re_init((B,))
        dig = mod.PageBuf(np.zeros((S + 4, B), np.int32), is_ref=False)
        end = mod.PageBuf(np.zeros((S + 1, B), np.int32), is_ref=False)
        arr = lambda a: np.asarray(a).astype(np.int32)            # noqa
    for t in range(len(kinds)):
        am = torch.as_tensor(active[t]) if mod is TE else active[t]
        k = kinds[t]
        pv, vv = arr(params[t]), arr(values[t])
        if k == 0:
            e = mod.re_encode(e, dig, vv, vv + 1, pv, am, dry=dry)
        elif k == 1:
            e = mod.re_enc_bit_logp(e, dig, vv, int(params[t][0]), am,
                                    dry=dry)
        elif k == 2:
            e = mod.re_enc_icdf(e, dig, vv, ICDF_T, 4, am, dry=dry)
        elif k == 3:
            bits = arr(np.where(active[t], params[t], 0))
            e = mod.re_enc_bits(e, end, vv, bits, am, dry=dry)
        else:
            e = mod.re_enc_uint(e, dig, end, vv, pv, am, dry=dry)
    return e, dig, end


def _jax_encode(kinds, active, params, values, B, S):
    from tests.np_shim import install, uninstall
    import opus_tpu.ops.rc_enc_kernel as RE

    mods = install(extra_modules=[RE])
    try:
        e, dig, end = _drive(RE, kinds, active, params, values, B, S)
        e = RE.re_done(e, dig)
        out, err, rng = RE.finalize(e, dig.buf, end.buf, S)
        tells = (np.asarray(RE.re_tell(e)), np.asarray(RE.re_tell_frac(e)))
        return (np.asarray(out), np.asarray(err).astype(np.int64),
                np.asarray(rng).astype(np.int64), tells)
    finally:
        uninstall(mods)


@pytest.mark.parametrize("seed,S", [(2, 96), (7, 96), (19, 96), (5, 14),
                                    (11, 9)])
def test_torch_rc_enc_bytes_match_jax_and_scalar(seed, S):
    B, STEPS = 48, 36
    kinds, active, params, values = _gen(seed, B, STEPS)
    e, dig, end = _drive(TE, kinds, active, params, values, B, S)
    tells = (TE.re_tell(e).numpy(), TE.re_tell_frac(e).numpy())
    e = TE.re_done(e, dig)
    out, err, rng = TE.finalize(e, dig, end, S)
    j_out, j_err, j_rng, j_tells = _jax_encode(kinds, active, params,
                                               values, B, S)
    assert np.array_equal(out.numpy(), j_out)
    assert np.array_equal(err.numpy(), j_err)
    assert np.array_equal(rng.numpy(), j_rng)
    assert np.array_equal(tells[0], j_tells[0])
    assert np.array_equal(tells[1], j_tells[1])
    pencs = _py_encode(kinds, active, params, values, B, S)
    for b in range(B):
        assert int(rng[b]) == pencs[b].rng & 0xFFFFFFFF, b
        if not err[b]:
            assert out[b].numpy().tobytes() == bytes(pencs[b].buf[:S]), b
    if S < 20:
        assert err.any(), "the small buffers must overflow some lanes"


def test_torch_rc_enc_dry_mode_tracks_tells():
    B, S, STEPS = 32, 96, 24
    kinds, active, params, values = _gen(5, B, STEPS)
    e, _d, _e = _drive(TE, kinds, active, params, values, B, S)
    e_dry, dig, end = _drive(TE, kinds, active, params, values, B, S,
                             dry=True)
    assert torch.equal(e["rng"], e_dry["rng"])
    assert torch.equal(e["nbits_total"], e_dry["nbits_total"])
    assert not dig.buf.any() and not end.buf.any()
    assert not e_dry["ndigits"].any()
