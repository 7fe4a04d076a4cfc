"""``FusedSilkDecoder.set_osce`` (the port's SILK-WB decoder with LACE or
NoLACE enhancement) against the scalar decoder with ``OSCEEnhancer``
(``OpusDecoder.set_osce``), on the CPU, over the SILK fixture's 8 streams
x 8 frames: tests/data/torch_osce_wb20ms.npz, written by
tools/make_torch_osce_fixture.py.

Held to the fixture on every lane-frame: the OSCE inputs the decoder
hands the enhancer (num_bits exact; the enhancer's periods and numbits
exact, its features within FEAT_ATOL), the first frame after a reset
equal to the unenhanced one bit for bit, the enhanced int16 within
chip_smoke.py's ``osce_pcm_bound`` (1 LSB plus OSCE_RTOL of the frame's
peak float output, which the random-weight models drive past full scale),
and the synthesis untouched by the enhancement (its history and final
range those of the unenhanced decode).  NB, MB and WB 10 ms frames pass
through unchanged.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu_torch.dnn import osce as PO
from opus_tpu_torch.models import fused_silk_dec as PF

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FEAT_ATOL = 1e-6       # float64 steps rounded once (test_torch_osce.py)


@pytest.fixture(scope="module")
def fx():
    sfx = dict(np.load(os.path.join(DATA, "torch_silk16k_24k.npz")))
    ofx = dict(np.load(os.path.join(DATA, "torch_osce_wb20ms.npz")))
    return sfx, ofx


@pytest.fixture(scope="module")
def models():
    return CS.osce_models("cpu")


@pytest.mark.parametrize("method", [PO.OSCE_METHOD_LACE,
                                    PO.OSCE_METHOD_NOLACE])
def test_fused_silk_osce_matches_scalar_decoder(fx, models, method):
    sfx, ofx = fx
    m = method - 1
    frames, lens = sfx["frames"], sfx["lens"]
    dec = PF.FusedSilkDecoder(frames.shape[0], fs_khz=16, device="cpu",
                              max_payload=frames.shape[2])
    dec.set_osce(method, models[method])
    env = CS.osce_env(ofx, method)
    got = []
    for f in range(frames.shape[1]):
        xq, err = dec.decode_packed(torch.from_numpy(frames[:, f]),
                                    torch.from_numpy(lens[:, f]))
        assert not err.any()
        got.append(xq.numpy())
        assert np.array_equal(dec.osce_in["num_bits"].numpy(),
                              ofx["num_bits"][m][:, f])
        feats, numbits, periods = dec.osce.frame_features
        assert np.array_equal(periods.numpy(), ofx["periods"][m][:, f])
        assert np.array_equal(numbits.numpy(), ofx["numbits"][m][:, f])
        err_f = np.abs(feats.numpy() - ofx["features"][m][:, f]).max()
        assert err_f <= FEAT_ATOL, (f, err_f)
        # the synthesis keeps the unenhanced history
        assert np.array_equal(dec.state["synth"]["out_buf"][:, -320:].numpy(),
                              sfx["xq"][:, f])
        assert np.array_equal(dec.final_range.numpy(),
                              sfx["final_range"][:, f])
    got = np.stack(got, 1)
    assert np.array_equal(got[:, 0], sfx["xq"][:, 0])
    lsb, share = CS.osce_compare(got, ofx["xq"][m], env, "CPU test")
    print(f"method {method}: enhanced PCM within {lsb} LSB of the scalar "
          f"decoder ({share:.2f} of the bound)")


@pytest.mark.parametrize("pre,fs_khz,nb_subfr", [("nb_", 8, 4),
                                                 ("mb_", 12, 4),
                                                 ("wb10_", 16, 2)])
def test_fused_silk_osce_passes_through_other_frames(fx, models, pre,
                                                     fs_khz, nb_subfr):
    sfx, ofx = fx
    frames, lens = sfx[pre + "frames"], sfx[pre + "lens"]
    dec = PF.FusedSilkDecoder(frames.shape[0], fs_khz=fs_khz,
                              nb_subfr=nb_subfr, device="cpu",
                              max_payload=frames.shape[2])
    dec.set_osce(PO.OSCE_METHOD_LACE, models[PO.OSCE_METHOD_LACE])
    for f in range(frames.shape[1]):
        xq, _err = dec.decode_packed(torch.from_numpy(frames[:, f]),
                                     torch.from_numpy(lens[:, f]))
        for m in range(2):
            assert np.array_equal(xq.numpy(), ofx[pre + "xq"][m][:, f])
        assert dec.osce.reset_count.tolist() == [2] * frames.shape[0]
    dec.set_osce(PO.OSCE_METHOD_NONE, None)
    assert dec.osce is None
