"""The port's LPCNet feature analysis and neural pitch estimator
(opus_tpu_torch/dnn/{features,pitchdnn}.py) against the JAX package's
(opus_tpu/dnn/{features,pitchdnn}.py) on the same seeded numpy inputs, on
the CPU, a few lanes at a time.

Integer decisions must be equal, and each test prints how many it held:
the pitch DNN's argmax, the pitch period floor(0.5 + 256 / 2**(...)),
the frame at which Burg reaches its gain limit and the order at which
Levinson bails out (both read from the zeros the numpy loops leave above
it).  Float bounds, each from an f32 budget (u = 2**-24 ~ 6e-8):

- PITCH_ATOL 1e-5 on the pitch parameter: the GEMMs' f32 sums in another
  order than XLA's move a logit by a few u of its ~64-term sum, and the
  softmax refinement moves by at most 2/60 of that; carried through 20
  GRU steps (measured: below 2e-6);
- FEAT_ATOL 1e-4 on the 36 features: the cepstra (|c| < ~40) come from
  numpy's f32 18-term DCT, whose BLAS sum order the port does not copy
  (it rounds the exact sum once): at most 18 u sum|terms| ~ 2e-4, a few u
  of the result in practice; the pitch as above (measured: below 6e-6);
- exact where the port runs numpy's own operations in its order: the
  biquad (float64, one step a sample), ``celt_fir`` (f32 products, f64
  sums), the band-gain interpolation; float64 results that take another
  summation order (FFT, Burg, Levinson, dot products) within 1e-12 of
  their scale.
"""

import numpy as np
import pytest
import torch

from opus_tpu.dnn import features as JF
from opus_tpu.dnn import nnet as JN
from opus_tpu.dnn import pitchdnn as JP
from opus_tpu.dnn import weights as JW
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import features as PF
from opus_tpu_torch.dnn import pitchdnn as PP
from opus_tpu_torch.dnn import weights as PW

PITCH_ATOL = 1e-5
FEAT_ATOL = 1e-4
SEED = 45


def _capture_jax_logits(monkeypatch, model):
    """Records the 180 logits of every JAX ``compute_pitch`` on ``model``:
    the output of its final dense layer (pitchdnn.py:74), read as the JAX
    package computes it.  Returns the list it appends to."""
    logits = []
    orig = JN.dense

    def dense(layer, x, activation):
        out = orig(layer, x, activation)
        if layer is model.final:
            logits.append(np.asarray(out)[:180])
        return out

    monkeypatch.setattr(JN, "dense", dense)
    return logits


def _period(p):
    """features.py:421 on numpy's float32 pitch."""
    return int(np.floor(0.5 + 256.0 / 2.0 ** ((1.0 / 60)
                                              * ((float(p) + 1.5) * 60))))


@pytest.fixture(scope="module")
def models():
    return JP.random_model(SEED), PP.random_model(SEED, device="cpu")


def _speech(n, seed, level):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 100 + 40 * (seed % 3)
    ph = np.cumsum(f0 * (1 + 0.1 * np.sin(2 * np.pi * 3 * t))) / 16000
    x = 0.25 * (np.sin(2 * np.pi * ph) + 0.5 * np.sin(4 * np.pi * ph)) \
        + 0.01 * rng.standard_normal(n)
    return np.round(np.clip(x, -1, 1) * level)


def _signals(kind, nf):
    """Two lanes of nf 10 ms frames of int16-valued f32 PCM."""
    n = nf * 160
    rng = np.random.default_rng({"speech": 1, "silence_noise": 2,
                                 "noise": 3}[kind])
    if kind == "speech":
        x = [_speech(n, 1, 32767), _speech(n, 2, 9000)]
    elif kind == "silence_noise":
        x = [np.zeros(n), np.zeros(n)]
        x[0][n // 2:] = np.round(rng.standard_normal(n - n // 2) * 30)
        x[1][7 * 160:] = np.round(rng.standard_normal(n - 7 * 160) * 3000)
    else:
        x = [np.round(rng.standard_normal(n) * 8000),
             np.clip(np.round(rng.standard_normal(n) * 20000), -32768,
                     32767)]
    return np.stack(x).astype(np.float32)


def test_torch_pitchdnn_matches_jax_over_20_frames(models, monkeypatch):
    jm, pm = models
    jl = _capture_jax_logits(monkeypatch, jm)
    b, nf = 2, 20
    rng = np.random.default_rng(7)
    js = [JP.init_state() for _ in range(b)]
    ps = PP.init_state(b, device="cpu")
    n_argmax = n_period = 0
    err = 0.0
    for f in range(nf):
        iff = rng.uniform(-1, 1, (b, JP.PITCH_IF_FEATURES)).astype(np.float32)
        xc = rng.uniform(-1, 1, (b, JP.NB_XCORR_FEATURES)).astype(np.float32)
        ps, logits = PP.pitch_logits(pm, ps, torch.from_numpy(iff),
                                     torch.from_numpy(xc))
        pos, pitch = PP.refine(logits)
        for i in range(b):
            js[i], jp = JP.compute_pitch(jm, js[i], iff[i], xc[i])
            assert int(np.argmax(jl[-1])) == int(pos[i]), (f, i)
            assert _period(jp) == int(PF.pitch_period(pitch[i:i + 1])[0])
            err = max(err, abs(float(jp) - float(pitch[i])))
            n_argmax += 1
            n_period += 1
    for i in range(b):
        for f in PP.PitchDNNState._fields:
            np.testing.assert_allclose(getattr(ps, f)[i].numpy(),
                                       np.asarray(getattr(js[i], f)),
                                       atol=PITCH_ATOL)
    print(f"pitch DNN: {n_argmax} argmax and {n_period} pitch periods equal; "
          f"pitch max err {err:.3g}")
    assert err <= PITCH_ATOL


def _lead_zeros_order(a):
    """The order a numpy loop stopped at: the index of the last nonzero
    coefficient (the loops leave exact zeros above it)."""
    nz = np.nonzero(np.asarray(a))[0]
    return int(nz.max()) if len(nz) else -1


@pytest.mark.parametrize("kind", ["speech", "silence_noise", "noise"])
def test_torch_frame_features_match_jax_over_40_frames(models, kind,
                                                       monkeypatch):
    """compute_frame_features, burg_cepstral_analysis and
    lpc_from_cepstrum over 40 frames, state carried; the pitch DNN's argmax
    read on both sides at every frame."""
    jm, pm = models
    nf = 40
    x = _signals(kind, nf)
    b = x.shape[0]
    p_pos = []
    orig_p = PP.refine

    def p_spy(logits):
        pos, pitch = orig_p(logits)
        p_pos.extend(int(v) for v in pos)
        return pos, pitch

    j_logits = _capture_jax_logits(monkeypatch, jm)
    monkeypatch.setattr(PP, "refine", p_spy)
    js = [JF.init_state() for _ in range(b)]
    ps = PF.init_state(b, device="cpu")
    pfeat = []
    for f in range(nf):
        ps, pf = PF.compute_frame_features(
            ps, torch.from_numpy(x[:, f * 160:(f + 1) * 160]), pm)
        pfeat.append(pf)
    # the stateless analyses of every lane-frame in one batch
    pfeat = torch.cat(pfeat)                              # [nf * b, 36]
    frames = torch.from_numpy(x.reshape(b, nf, 160).transpose(1, 0, 2)
                              .reshape(nf * b, 160).copy())
    pburg = PF.burg_cepstral_analysis(frames).numpy()
    plpc = PF.lpc_from_cepstrum(pfeat)[0].numpy()
    pfeat = pfeat.numpy()
    n_period = n_lev = 0
    err = dict(feat=0.0, burg=0.0, lpc=0.0)
    for f in range(nf):
        fr = x[:, f * 160:(f + 1) * 160]
        for i in range(b):
            k = f * b + i
            js[i], jfeat = JF.compute_frame_features(js[i], fr[i], jm)
            jburg = JF.burg_cepstral_analysis(fr[i])
            jlpc, _ = JF.lpc_from_cepstrum(jfeat)
            assert _period(jfeat[18]) == int(
                PF.pitch_period(torch.tensor(pfeat[k:k + 1, 18]))[0]), (f, i)
            assert _lead_zeros_order(jfeat[20:]) \
                == _lead_zeros_order(pfeat[k, 20:]), (f, i)
            assert _lead_zeros_order(jlpc) == _lead_zeros_order(plpc[k])
            n_period += 1
            n_lev += 2
            err["feat"] = max(err["feat"], np.abs(jfeat - pfeat[k]).max())
            err["burg"] = max(err["burg"], np.abs(jburg - pburg[k]).max())
            err["lpc"] = max(err["lpc"], np.abs(jlpc - plpc[k]).max())
    assert [int(np.argmax(v)) for v in j_logits] == p_pos
    print(f"{kind}: {len(p_pos)} argmax, {n_period} pitch periods, {n_lev} "
          f"Levinson bail-outs equal; max err {err}")
    assert max(err.values()) <= FEAT_ATOL, err


def _burg_inputs():
    """Rows of 79 f32 samples: a clean sinusoid and a two-tone (both reach
    the 1e-3 gain limit), speech, noise, silence with one click, near
    silence."""
    rng = np.random.default_rng(11)
    n = np.arange(79)
    rows = [8000 * np.sin(0.3 * n), 5000 * np.sin(0.2 * n)
            + 3000 * np.sin(0.7 * n + 1), _speech(79, 4, 20000),
            rng.standard_normal(79) * 1000, np.where(n == 40, 20000.0, 0.0),
            np.round(rng.standard_normal(79))]
    return np.stack(rows).astype(np.float32)


def test_torch_burg_analysis_gain_limit_matches_jax():
    x = _burg_inputs()
    a, nrg = PF.burg_analysis(torch.from_numpy(x), 1e-3, 79, 1, 16)
    stops = []
    for i in range(len(x)):
        ja, jn = JF.burg_analysis(x[i], 1e-3, 79, 1, 16)
        stops.append(_lead_zeros_order(ja))
        assert stops[-1] == _lead_zeros_order(a[i].numpy()), i
        np.testing.assert_allclose(a[i].numpy(), ja, atol=FEAT_ATOL)
        np.testing.assert_allclose(float(nrg[i]), jn, rtol=1e-9,
                                   atol=1e-12 * float(np.sum(x[i] ** 2.0)))
    print(f"Burg: {len(x)} stop orders equal: {stops}")
    assert min(stops) < 15, "no row reached the gain limit"


def test_torch_lpcn_lpc_bail_out_matches_jax():
    """Levinson on the Burg rows' lag products, on the autocorrelations of
    one and of two pure tones (predictable past 30 dB, so they bail out
    after 2 and 4 orders), of an AR(1) process (never) and on zeros."""
    x = _burg_inputs().astype(np.float64)
    k = np.arange(17)
    ac = np.concatenate([
        np.stack([[np.dot(r[:79 - j], r[j:]) for j in k] for r in x]),
        np.stack([np.cos(0.3 * k) + 1e-6 * (k == 0),
                  np.cos(0.3 * k) + 0.5 * np.cos(1.1 * k) + 1e-6 * (k == 0),
                  0.9 ** k, 0.0 * k])])
    lpc, err = PF.lpcn_lpc(torch.from_numpy(ac), 16)
    orders = []
    for i in range(len(ac)):
        jl, je = JF._lpcn_lpc(ac[i], 16)
        orders.append(_lead_zeros_order(jl))
        assert orders[-1] == _lead_zeros_order(lpc[i].numpy()), i
        np.testing.assert_allclose(lpc[i].numpy(), jl, atol=FEAT_ATOL)
        np.testing.assert_allclose(float(err[i]), je, rtol=1e-9)
    print(f"Levinson: {len(ac)} bail-out orders equal: {orders}")
    assert {1, 3, 15, -1} <= set(orders), orders


def test_torch_feature_primitives_exact():
    rng = np.random.default_rng(3)
    x = np.round(rng.standard_normal((3, 160)) * 5000).astype(np.float32)
    mem = rng.standard_normal((3, 2))
    y, m = PF.biquad(torch.from_numpy(x), torch.from_numpy(mem))
    for i in range(3):
        jm = mem[i].copy()
        assert np.array_equal(JF._biquad(x[i], jm, JF._LP_B, JF._LP_A),
                              y[i].numpy())
        assert np.array_equal(jm, m[i].numpy())
    xh = np.round(rng.standard_normal((3, 176)) * 5000).astype(np.float32)
    num = rng.standard_normal((3, 16)).astype(np.float32) * 0.3
    got = PF.celt_fir(torch.from_numpy(xh), torch.from_numpy(num), 160, 16)
    for i in range(3):
        assert np.array_equal(JF.celt_fir(xh[i], num[i], 160, 16),
                              got[i].numpy())
    w = rng.standard_normal((3, 320))
    X = PF.forward_transform(torch.from_numpy(w)).numpy()
    for i in range(3):
        jx = JF.forward_transform(w[i])
        assert np.abs(X[i] - jx).max() <= 1e-12 * np.abs(jx).max()
        np.testing.assert_allclose(
            PF.compute_band_energy(torch.from_numpy(X[i:i + 1]))[0].numpy(),
            JF.compute_band_energy(jx), rtol=1e-6)
    assert np.array_equal(PF.HALF_WINDOW, JF.HALF_WINDOW)
    assert np.array_equal(PF.DCT_TABLE, JF.DCT_TABLE)
    assert np.array_equal(PF._BAND_M, JF._BAND_M)
    assert np.array_equal(PF._COMPENSATION, JF._COMPENSATION)
    assert np.array_equal(PF.EBAND5MS, JF.EBAND5MS)


def test_torch_pitchdnn_blob_and_convert_round_trip(models):
    jm, pm = models
    jarr = JP.model_to_arrays(jm)
    parr = PP.model_to_arrays(pm)
    blob = JW.write_blob(jarr)
    assert PW.write_blob(parr) == blob
    back = PP.model_from_arrays(PW.parse_blob(blob), device="cpu")
    conv = convert.pitchdnn_from_jax(jm)
    for f in PP.PitchDNNModel._fields:
        for a, b, c in zip(getattr(pm, f), getattr(back, f), getattr(conv, f)):
            if a is None:
                assert b is None and c is None
                continue
            assert np.array_equal(a.numpy(), b.numpy()), f
            assert np.array_equal(a.numpy(), c.numpy()), f
