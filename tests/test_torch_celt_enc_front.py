"""The port's encoder front end (celt_enc_kernel._front_end: silence,
pre-emphasis, MDCTs, band energies, transient / dynalloc / tf / spreading
/ trim analysis) against the JAX package's, as stored in the encoder
fixture (tests/data/torch_celt20ms_64k_enc.npz, written by
tools/make_torch_enc_fixture.py): given the fixture's encoder state before
each frame, the port's integer decisions equal the JAX twin's on all
8 x 8 lane-frames.

X and the band energies come from f32 matmuls whose summation order
differs (torch vs numpy BLAS), so they are held to a ULP budget: an
MDCT coefficient is a 1080-term f32 dot product of the window (|basis|
sums to <= 2.25), so its error is <= 1080 u 2.25 max|input| ~ 1.5e-4
max|input| (u = 2**-24).  X = freq / be and ble = log2(be) turn that into
|dX| <= 1.5e-4 max|input| / be and |dble| <= 1.5e-4 max|input| / (be ln 2)
per band, plus a few ULPs of the result."""

import os

import numpy as np
import pytest
import torch

from opus_tpu_torch.models import celt_enc_fused as EF
from opus_tpu_torch.models import celt_enc_kernel as CK

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_celt20ms_64k_enc.npz")
MDCT_REL = 1.5e-4
INT_KEYS = ("is_transient", "tf_res", "tf_select", "offsets_cnt",
            "spread_calc", "trim_calc")


def fixture_state(fx, f: int) -> dict:
    """The JAX encoder state before frame f, as the port's state dict."""
    st = {}
    for k in EF.fused_celt_enc_init(1, CK.enc_tabs(), "cpu"):
        v = torch.as_tensor(fx["st_" + k][f])
        st[k] = v.to(torch.int64) if v.dtype == torch.int32 else v
    return st


@pytest.mark.parametrize("f", range(8))
def test_torch_enc_front_end_matches_jax(f):
    fx = np.load(FIXTURE)
    tabs = CK.enc_tabs()
    st = fixture_state(fx, f)
    pcm = torch.as_tensor(fx["pcm"][:, f])
    ins, X, front = CK._front_end(pcm, st, tabs, 160)
    for k in INT_KEYS:
        assert np.array_equal(ins[k].numpy(), fx["in_" + k][f]), k
    assert np.array_equal(ins["silence"].numpy() != 0, fx["fr_silence"][f])
    for k in ("prev_cb", "consec_transient"):
        assert np.array_equal(ins[k].numpy(), fx["in_" + k][f]), k
    assert np.array_equal(front["transient_got_disabled"].numpy(),
                          fx["fr_transient_got_disabled"][f])

    dsp = EF._encode_dsp(pcm, st["mem"], st["hist"], tabs,
                         torch.zeros(8, dtype=torch.bool))
    tr = front["is_transient"][:, None]
    be = torch.where(tr, dsp["be_s"], dsp["be_l"]).numpy().astype(np.float64)
    scale = MDCT_REL * dsp["full"].abs().amax(dim=1).numpy()[:, None] / be
    bm = tabs.band_map[:tabs.nx_rows]
    dx = np.abs(X.numpy() - fx["X"][f])
    assert (dx <= scale[:, bm] + 1e-6).all(), dx.max()
    db = np.abs(ins["ble_b"].numpy() - fx["in_ble_b"][f])
    assert (db <= scale / np.log(2) + 1e-5).all(), db.max()
    # pre-emphasis is elementwise f32 in the same order: identical
    assert np.array_equal(front["mem"].numpy(), fx["fr_mem"][f])
    assert np.array_equal(front["hist"].numpy(), fx["fr_hist"][f])
