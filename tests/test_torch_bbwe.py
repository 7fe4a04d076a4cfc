"""The port's neural blind bandwidth extension (opus_tpu_torch/dnn/bbwe.py)
against the JAX package's (opus_tpu/dnn/bbwe.py) on the CPU: the same
numpy inputs through both, lanes of the port against calls of the JAX
functions, state carried; and the whole ``BBWE.process`` at B = 8 against
tests/data/torch_bbwe.npz (written by tools/make_torch_bbwe_fixture.py
from the JAX ``BBWE`` on 8 seeded streams x 8 frames).

Bounds:

- the upsampler: bit for bit (the JAX function's float64 operations in
  its order), its float32 output and its float64 state;
- the interpolator: UP_RTOL (one float32 ulp) of each output.  numpy's
  ``np.dot`` sums the 8 taps through BLAS (here one fused multiply-add
  after another); the port sums the products in tap order in float64:
  the float64 sums differ by a few float64 ulps, so a float32 rounding
  can differ only where the sum lies that close to a rounding boundary.
  Measured: equal on every output;
- the activation x sin(log|x|): UP_RTOL (float64 log and sin of
  different libraries, rounded to float32).  Measured: equal;
- the features: FEAT_ATOL 1e-6 (the float64 FFT of pocketfft in numpy and
  in torch, the band sums in numpy's order, each rounded once to
  float32), digital silence and the first frame against the zeroed
  spectrum memory included (their instantaneous-frequency terms are
  0 / (0 + 1e-9) and 1e-18 / (1e-18 + 1e-9), well conditioned).
  Measured: equal on all 8 x 8 frames;
- the feature net (tanh and GRU outputs in [-1, 1]): COND_ATOL 1e-5, f32
  products of up to 384 inputs in another order, fed back through the
  GRU;
- the output int16 within ``chip_smoke.bbwe_pcm_bound`` of the frame's
  peak |float output| and the previous frame's: 1 LSB plus BBWE_RTOL of
  it.  Measured: 1 LSB.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu.dnn import bbwe as JB
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import bbwe as PB

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
UP_RTOL = 2.0 ** -23
FEAT_ATOL = 1e-6
COND_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(os.path.join(DATA, "torch_bbwe.npz")))


@pytest.fixture(scope="module")
def model():
    return PB.random_model(CS.BBWE_SEED, device="cpu")


def _leaves(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if x is not None]


def test_random_model_and_converter_equal_jax(model):
    jm = JB.random_model(CS.BBWE_SEED)
    conv = convert.bbwe_from_jax(jm)
    assert type(conv) is PB.BBWEModel
    ours, theirs = _leaves(model), _leaves(conv)
    assert len(ours) == len(theirs) == 28
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    assert tuple(model.af2[0].w.shape) == (PB.COND_DIM, 9 * PB.KSIZE)
    assert tuple(model.tdshape2[1].w.shape) == (2 * 21, 120)


@pytest.mark.parametrize("stage", ["upsamp_2x", "interpol_3_2"])
def test_resampler_stages_match_jax(fx, stage):
    """Two calls in a row on 2 lanes x 3 channels of random input against
    the JAX function per channel; and the calls the fixture captured inside
    the running JAX BBWE (their states and inputs)."""
    rng = np.random.default_rng(7)
    n = 80 if stage == "upsamp_2x" else 160
    p_fn, j_fn = getattr(PB, stage), getattr(JB, stage)
    ps = PB.resamp_init(2, device="cpu")
    js = [[JB.resamp_init() for _ in range(3)] for _ in range(2)]
    for call in range(2):
        x = (rng.standard_normal((2, 3, n)) * 0.4).astype(np.float32)
        ps, got = p_fn(ps, _t(x))
        for lane in range(2):
            for ch in range(3):
                js[lane][ch], ref = j_fn(js[lane][ch], x[lane, ch])
                ref = ref.astype(np.float32)
                if stage == "upsamp_2x":
                    assert np.array_equal(got[lane, ch].numpy(), ref)
                    assert np.array_equal(ps.upsamp[lane, ch].numpy(),
                                          js[lane][ch].upsamp)
                else:
                    err = np.abs(got[lane, ch].numpy() - ref)
                    assert (err <= UP_RTOL * np.abs(ref)).all(), err.max()
                    assert np.array_equal(ps.interpol[lane, ch].numpy(),
                                          js[lane][ch].interpol)
    key = "up2" if stage == "upsamp_2x" else "ip"
    x, out = fx[key + "_x"], fx[key + "_out"].astype(np.float32)
    st = PB.resamp_init(1, len(x), device="cpu")
    if stage == "upsamp_2x":
        st = st._replace(upsamp=_t(fx["up2_state"][None]))
    else:
        st = st._replace(interpol=_t(fx["ip_state"][None]))
    _st, got = p_fn(st, _t(x[None]))
    err = np.abs(got[0].numpy() - out)
    assert (err <= UP_RTOL * np.abs(out)).all(), err.max()
    print(f"{stage}: {int((err > 0).sum())} of {out.size} stored outputs "
          f"differ")


def test_valin_activation_matches_jax():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(4096) * np.exp(rng.standard_normal(4096) * 3)) \
        .astype(np.float32)
    x[:4] = [0.0, -0.0, 1e-7, -40000.0]
    ref = JB.valin_activation(x)
    got = PB.valin_activation(_t(x)).numpy()
    err = np.abs(got - ref)
    assert (err <= UP_RTOL * np.abs(ref)).all(), err.max()


def test_features_match_jax(fx):
    """The fixture's 8 streams (speech-like, digital silence, an onset
    after silence, full-scale square and noise), 8 frames of 2 x 10 ms,
    against the JAX function live and the fixture's stored features."""
    xq = fx["bbwe_in"].astype(np.int64)
    ps = PB.bwe_feature_init(8, device="cpu")
    js = [JB.bwe_feature_init() for _ in range(8)]
    worst = 0.0
    for f in range(xq.shape[1]):
        ps, got = PB.bwe_calculate_features(ps, _t(xq[:, f]))
        for lane in range(8):
            js[lane], ref = JB.bwe_calculate_features(js[lane], xq[lane, f])
            err = float(np.abs(got[lane].numpy() - ref).max())
            assert err <= FEAT_ATOL, (f, lane, err)
            worst = max(worst, err)
            assert np.array_equal(ps.signal_history[lane].numpy(),
                                  js[lane].signal_history)
        assert np.abs(got.numpy() - fx["bbwe_feats"][:, f]).max() \
            <= FEAT_ATOL
    print(f"features: max err {worst:.3g} against JAX")


def test_feature_net_matches_jax(fx, model):
    """The fixture's features through the port's feature net (2 frames of
    2 x 10 ms, state carried) against the JAX conditioning vectors."""
    st = PB.init_state(8, device="cpu")
    for f in range(fx["bbwe_cond"].shape[1]):
        st, cond = PB.feature_net(model, st, _t(fx["bbwe_feats"][:, f]))
        err = float(np.abs(cond.numpy() - fx["bbwe_cond"][:, f]).max())
        assert err <= COND_ATOL, (f, err)


def test_conv1d_seq_two_wide_memory_equals_steps(model):
    """nndsp.conv1d_seq with a memory two inputs wide (BBWE's k=3 convs)
    equals nnet.conv1d step by step."""
    from opus_tpu_torch.dnn import nndsp, nnet
    rng = np.random.default_rng(9)
    xs = _t(rng.standard_normal((2, 3, PB.FEATURE_DIM)).astype(np.float32))
    mem = _t(rng.standard_normal((2, 2 * PB.FEATURE_DIM))
             .astype(np.float32))
    out, new = nndsp.conv1d_seq(model.fnet_conv1, mem, xs,
                                nnet.ACTIVATION_TANH)
    m = mem
    for k in range(3):
        o, m = nnet.conv1d(model.fnet_conv1, m, xs[:, k],
                           nnet.ACTIVATION_TANH)
        assert torch.allclose(out[:, k], o, rtol=0, atol=1e-6)
    assert torch.equal(new, m)


def test_bbwe_process_matches_jax_fixture(fx, model):
    """The port's BBWE at B = 8 over the fixture's 8 frames (stage-major
    within a frame) against the JAX BBWE (subframe by subframe): int16
    output within bbwe_pcm_bound, peaks close; then reset() starts over."""
    ext = PB.BBWE(model, 8, device="cpu")
    xq = fx["bbwe_in"].astype(np.int64)
    outs, peaks = [], []
    for f in range(xq.shape[1]):
        outs.append(ext.process(_t(xq[:, f])).numpy())
        peaks.append(ext.peak.numpy())
    got = np.stack(outs, 1)
    env = CS.peak_env(fx["bbwe_peak"])
    lsb, share, _ = CS.within(got, fx["bbwe_out"], CS.bbwe_pcm_bound(env),
                           "BBWE vs JAX")
    rel = np.abs(np.stack(peaks, 1) - fx["bbwe_peak"]) \
        / np.maximum(fx["bbwe_peak"], 1e-3)
    assert rel.max() <= 1e-4, rel.max()
    assert (got[4] == 0).all()              # digital silence stays silent
    print(f"BBWE: int16 within {lsb:.0f} LSB of JAX ({share:.2f} of the "
          f"bound)")
    ext.reset()
    again = ext.process(_t(xq[:, 0])).numpy()
    assert np.array_equal(again, got[:, 0])


def test_signal_net_stage_major_equals_subframe_calls(fx, model):
    """The signal net over a frame's 4 subframes in one stage-major call
    against 4 calls of one subframe each, state carried."""
    x = _t(fx["bbwe_in"][:, 0].astype(np.float32) / 32768.0)
    cond = _t(np.ascontiguousarray(fx["bbwe_cond"][:, 0]))
    st0 = PB.init_state(8, device="cpu")
    st_a, whole = PB.signal_net(model, st0, x, cond)
    st_b, parts = st0, []
    for s in range(4):
        st_b, y = PB.signal_net(model, st_b, x[:, s * 80:(s + 1) * 80],
                                cond[:, s:s + 1])
        parts.append(y)
    parts = torch.cat(parts, dim=1)
    scale = whole.abs().amax(dim=1, keepdim=True).clamp_min(1e-3)
    assert ((whole - parts).abs() <= 1e-5 * scale).all()
    assert torch.allclose(st_a.resamp.upsamp, st_b.resamp.upsamp, rtol=0,
                          atol=1e-5)


def test_bbwe_rejects_other_frame_sizes_and_defaults_to_cuda(model):
    ext = PB.BBWE(model, 2, device="cpu")
    with pytest.raises(ValueError):
        ext.process(torch.zeros((2, 240), dtype=torch.int64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PB.BBWE(model, 2)
