"""The plain version of kernel K3 (celt_enc_kernel.encode_frame_plain, the
port of the JAX ``_symbol_pass`` + ``finalize`` with the header bits)
against the JAX twin ``unrolled_encode_frame``: fed the JAX front end's
stored outputs (tests/data/torch_celt20ms_64k_enc.npz), it gives the JAX
twin's payload bytes, final range and error flag on every one of the
8 x 8 fixture lane-frames, and its energy memory, energy error and
delayed_intra (the same f32 operations in the same order).  One live
check runs the JAX twin itself (under tests/np_shim) on one frame of two
streams."""

import os

import numpy as np
import pytest
import torch

from opus_tpu_torch.models import celt_enc_kernel as CK

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_celt20ms_64k_enc.npz")


def fixture_inputs(fx, f: int):
    ins = {k: torch.as_tensor(fx["in_" + k][f]) for k in CK.FIN_KEYS}
    for k in CK.IIN_KEYS[1:]:
        ins[k] = torch.as_tensor(fx["in_" + k][f]).to(torch.int64)
    ins["silence"] = torch.as_tensor(fx["fr_silence"][f]).to(torch.int64)
    return torch.as_tensor(fx["X"][f]), ins


@pytest.mark.parametrize("f", range(8))
def test_torch_enc_symbols_match_jax_twin(f):
    fx = np.load(FIXTURE)
    X, ins = fixture_inputs(fx, f)
    out = CK.encode_frame_plain(X, ins, CK.enc_tabs(), 160)
    assert np.array_equal(out["payload"].numpy(), fx["payload"][f])
    assert np.array_equal(out["rng"].numpy(), fx["rng"][f].astype(np.int64))
    assert np.array_equal(out["err"].numpy(), fx["err"][f])
    if f + 1 < fx["X"].shape[0]:
        # the JAX state carry of the next frame: energy memory (silence
        # resets it) and the energy error clamped to +-0.5
        sil = fx["fr_silence"][f][:, None]
        old_e = np.where(sil, np.float32(-28.0), out["old_e"].numpy())
        assert np.array_equal(old_e, fx["st_old_band_e"][f + 1])
        assert np.array_equal(out["error"].numpy().clip(-0.5, 0.5),
                              fx["st_energy_error"][f + 1])
        assert np.array_equal(out["delayed_intra"].numpy(),
                              fx["st_delayed_intra"][f + 1])


def test_torch_enc_symbols_live_jax_twin():
    """One frame of two fixture streams through the JAX twin itself."""
    from tests.np_shim import install, uninstall
    import opus_tpu.models.celt_enc_kernel as EK
    import opus_tpu.models.celt_enc_fused as JEF
    import opus_tpu.ops.rc_enc_kernel as RCE

    fx = np.load(FIXTURE)
    pcm = fx["pcm"][:2, 1]
    mods = install(extra_modules=[EK, JEF, RCE])
    cur = {}
    orig = EK._front_end

    def spy(*a, **kw):
        cur["out"] = orig(*a, **kw)
        return cur["out"]

    EK._front_end = spy
    try:
        tabs = EK.ETabs(48000, 960)
        state = JEF.fused_celt_enc_init(2, tabs.enc)
        payload, rngv, err, _st = EK.unrolled_encode_frame(pcm, state, tabs,
                                                           160)
    finally:
        EK._front_end = orig
        uninstall(mods)
    _e, _d, _n, ins_j, X, front = cur["out"]
    ins = {"silence": torch.as_tensor(np.asarray(front["silence"])
                                      ).to(torch.int64)}
    for k in CK.FIN_KEYS + CK.IIN_KEYS[1:]:
        v = ins_j[k]
        v = np.stack(v, axis=1) if isinstance(v, list) else np.asarray(v)
        ins[k] = torch.as_tensor(v)
        if k not in CK.FIN_KEYS:
            ins[k] = ins[k].to(torch.int64)
    out = CK.encode_frame_plain(torch.as_tensor(np.asarray(X)), ins,
                                CK.enc_tabs(), 160)
    assert np.array_equal(out["payload"].numpy(), np.asarray(payload))
    assert np.array_equal(out["rng"].numpy(),
                          np.asarray(rngv).astype(np.int64))
    assert np.array_equal(out["err"].numpy(), np.asarray(err))
