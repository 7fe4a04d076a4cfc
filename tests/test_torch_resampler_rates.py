"""The decoder-direction resampler from 16 kHz at 8, 12 and 24 kHz
(opus_tpu_torch/silk/resampler.py ``resample_16k``) against the JAX
package's scalar ``Resampler(16000, fs)`` (opus_tpu/silk/resampler.py), and
``BatchedDeepPLC.dred_decode`` at those rates (opus_tpu_torch/models/
deep_plc.py) against ``OpusDecoder(fs).dred_decode``, on the CPU.

Bounds: the resampler bit for bit (int32 arithmetic carried in int64, the
state across pieces); dred_decode's int16 within chip_smoke.plc_rate_lsb(fs)
(3, 3 and 4 LSB): the 16 kHz concealment is within 1 LSB of JAX's and a
1-LSB input step moves the resampler's output by at most its largest sum
of |h| (``chip_smoke.resampler_l1``), rounded up.  The JAX outputs are
tests/data/torch_sim_loss.npz's (tools/make_torch_sim_loss_fixture.py):
tests/data/torch_deep_plc.npz's first step (16 good frames, then 60 ms of
DRED concealment) on its 9 streams at each rate.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu.silk.resampler import Resampler
from opus_tpu_torch.dnn import dred as PD
from opus_tpu_torch.dnn import dred_dec as PDD
from opus_tpu_torch.dnn import rdovae as PR
from opus_tpu_torch.models.deep_plc import BatchedDeepPLC
from opus_tpu_torch.silk import resampler as PRS

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(DATA, "torch_sim_loss.npz"))


@pytest.fixture(scope="module")
def plc_inputs():
    pfx = np.load(os.path.join(DATA, "torch_deep_plc.npz"))
    dfx = np.load(os.path.join(DATA, "torch_dred_recovery.npz"))
    dd = PDD.OpusDREDDecoder(PR.random_dec_model(42, device="cpu"),
                             PD.random_stats(43), device="cpu")
    dreds = [dd.parse(bytes(dfx["packets"][i, :dfx["lens"][i]]), 16000,
                      16000)[0] for i in range(len(dfx["lens"]))]
    return torch.from_numpy(pfx["hist"]), dd.process_batch(dreds)


@pytest.mark.parametrize("piece", [160, 320])
@pytest.mark.parametrize("fs", CS.PLC_RATES)
def test_resampler_rates_bit_exact_with_jax(fs, piece):
    """5 lanes (speech-like noise, a full-scale lane, a lane alternating at
    -32768) over 6 pieces of 10 or 20 ms (a 20 ms piece splits into two
    batches), the state carried."""
    rng = np.random.default_rng(fs + piece)
    b, n = 5, 6
    x = np.clip(rng.standard_normal((b, n, piece)) * 8000, -32768,
                32767).astype(np.int64)
    x[0] = 32767
    x[1, :, ::2] = -32768
    st = PRS.dec_resampler_init(b, fs)
    refs = [Resampler(16000, fs) for _ in range(b)]
    for k in range(n):
        y, st = PRS.resample_16k(torch.from_numpy(x[:, k]), st, fs)
        ref = np.array([r.process(x[i, k].tolist())
                        for i, r in enumerate(refs)])
        assert np.array_equal(y.numpy(), ref), (fs, k)


@pytest.mark.parametrize("fs", CS.PLC_RATES)
def test_dred_decode_at_rate_matches_jax(fx, plc_inputs, fs):
    hist, batch = plc_inputs
    models = CS.plc_models("cpu")
    plc = BatchedDeepPLC(*models, hist.shape[0], fs=fs, device="cpu")
    for k in range(16):
        plc.lpcnet.update(hist[:, k])
    k = fs // 1000
    out = plc.dred_decode(batch, fx[f"rate_off{k}"], 6 * fs // 100).numpy()
    ref = fx[f"rate_pcm{k}"]
    err = int(np.abs(out.astype(np.int64) - ref).max())
    bound = CS.plc_rate_lsb(fs)
    print(f"dred_decode at {fs} Hz: {out.size} samples within {err} LSB of "
          f"JAX (bound {bound}: resampler |h| sum "
          f"{CS.resampler_l1(fs):.3f})")
    assert out.shape == ref.shape and err <= bound


def test_dred_decode_per_lane_frame_sizes_and_mask(plc_inputs):
    """Lanes with their own offsets and frame sizes (10, 20 and 60 ms) and
    one outside the mask, at 24 kHz: each concealing lane equals the same
    call made on it alone (its FEC choices and FARGAN periods exactly, its
    int16 within the rate's bound: a GEMM over 1 lane sums in another
    order than over 4), the masked-out lane's output is zero and its state
    (the resampler's too) unchanged bit for bit."""
    hist, batch = plc_inputs
    lanes = [0, 1, 2, 3]
    sub = PDD.DREDBatch(batch.fec_features[lanes], batch.nb_latents[lanes],
                        batch.dred_offset[lanes])
    models = CS.plc_models("cpu")
    fs = 24000
    offs = np.array([480, 240 + 17, 2400, 0])
    fsz = np.array([240, 480, 1440, 480])
    mask = torch.tensor([True, True, True, False])
    plc = BatchedDeepPLC(*models, 4, fs=fs, device="cpu")
    for k in range(16):
        plc.lpcnet.update(hist[lanes, k])
    rs0, lp0 = plc.rs, plc.lpcnet._state()
    out = plc.dred_decode(sub, offs, fsz, lanes=mask).numpy()
    assert out.shape == (4, 1440) and not out[3].any()
    for a, z in zip(torch.utils._pytree.tree_leaves(
            (plc.rs, plc.lpcnet._state())),
            torch.utils._pytree.tree_leaves((rs0, lp0))):
        assert torch.equal(a[3], z[3])
    for i in range(3):
        one = BatchedDeepPLC(*models, 1, fs=fs, device="cpu")
        for k in range(16):
            one.lpcnet.update(hist[lanes[i]:lanes[i] + 1, k])
        d1 = PDD.DREDBatch(sub.fec_features[i:i + 1], sub.nb_latents[i:i + 1],
                           sub.dred_offset[i:i + 1])
        ref = one.dred_decode(d1, offs[i:i + 1], int(fsz[i])).numpy()[0]
        for (m, fec, per), (_, fec1, per1) in zip(plc.trace, one.trace):
            assert m[i] and fec[i] == fec1[0] and per[i] == per1[0]
        for m, _, _ in plc.trace[len(one.trace):]:
            assert not m[i]
        err = int(np.abs(out[i, :fsz[i]].astype(np.int64) - ref).max())
        assert err <= CS.plc_rate_lsb(fs), err
        assert not out[i, fsz[i]:].any()
