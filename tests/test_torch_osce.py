"""The port's OSCE (opus_tpu_torch/dnn/{nndsp,osce_features,osce}.py)
against the JAX package's (opus_tpu/dnn/{nndsp,osce_features,osce}.py) on
the CPU: the same numpy inputs from seeds, a few lanes against as many
calls of the JAX functions, state carried across frames.

The port runs the 4 subframes of a filter stage in one call; the JAX
functions run them one by one.  Bounds:

- the adaptive filters (outputs of magnitude <= ~5): FILTER_ATOL 1e-5.
  The kernels and gains come from f32 dense layers of 64 inputs whose sums
  XLA and torch order differently (~1e-7 relative typical, <= 64 u = 4e-6
  relative worst case); the correlations are float64 here and 16-term
  float32 dots in numpy (a few ulps);
- the features: integers (periods, num_bits) and numbits exact; the
  float features within FEAT_ATOL 1e-6: every step is float64 rounded once
  to float32 in both, so only the FFT's and BLAS's float64 orders differ;
- the feature net's conditioning vectors (tanh and GRU outputs in [-1, 1])
  within COND_ATOL 1e-5: f32 products of up to 768 inputs in another
  order, fed back through the GRU over 3 frames;
- LACE's and NoLACE's float32 output within chip_smoke.py's OSCE bound
  (``osce_pcm_bound``) taken in full-scale units: 1 / 32768 plus
  OSCE_RTOL of the larger peak |output| of the frame and the one before.
  The same products' differences and the de-emphasis's (K2's plain
  Toeplitz form against numpy's serial loop) are relative to the
  magnitudes they come from, and the random-weight stages drive those
  far past full scale (NoLACE's first frames peak at 700-3000).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu.dnn import nndsp as JD
from opus_tpu.dnn import nnet as JN
from opus_tpu.dnn import osce as JO
from opus_tpu.dnn import osce_features as JF
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import nndsp as PD
from opus_tpu_torch.dnn import nnet as PN
from opus_tpu_torch.dnn import osce as PO
from opus_tpu_torch.dnn import osce_features as PF

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FILTER_ATOL = 1e-5
FEAT_ATOL = 1e-6
COND_ATOL = 1e-5
F, FR, OV, KS = 64, 80, 40, 16
LANES = (0, 5, 7)        # speech at 24 kb/s, at 12 kb/s, silence then noise


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lin(rng, m, n):
    w = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return JN.np_linear(w, b), PN.np_linear(w, b, device="cpu")


def _close(got, ref, atol, what):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    assert err <= atol, f"{what}: max err {err:.3g} > {atol}"
    return err


@pytest.mark.parametrize("in_ch,out_ch", [(1, 1), (1, 2), (2, 2), (2, 1)])
def test_adaconv_matches_jax(in_ch, out_ch):
    rng = np.random.default_rng(10 * in_ch + out_ch)
    kj, kp = _lin(rng, F, in_ch * out_ch * KS)
    gj, gp = _lin(rng, F, out_ch)
    win = JD.compute_overlap_window(OV)
    b, n = 2, 4
    js = [JD.adaconv_init(in_ch, out_ch, KS) for _ in range(b)]
    ps = PD.adaconv_init(b, in_ch, out_ch, KS, device="cpu")
    for frame in range(2):
        x = (rng.standard_normal((b, in_ch, n * FR)) * 0.5).astype(np.float32)
        fe = (rng.standard_normal((b, n, F)) * 0.5).astype(np.float32)
        ps, got = PD.adaconv_process_frame(ps, _t(x), _t(fe), kp, gp, FR, OV,
                                           in_ch, out_ch, KS, KS - 1,
                                           JO.CONV_GAIN_A, 0.0)
        for lane in range(b):
            for s in range(n):
                seg = x[lane, :, s * FR:(s + 1) * FR].reshape(-1)
                js[lane], ref = JD.adaconv_process_frame(
                    js[lane], seg, fe[lane, s], kj, gj, FR, OV, in_ch,
                    out_ch, KS, KS - 1, JO.CONV_GAIN_A, 0.0, win)
                _close(got[lane, :, s * FR:(s + 1) * FR].numpy(),
                       ref.reshape(out_ch, FR), FILTER_ATOL,
                       f"frame {frame} lane {lane} subframe {s}")
            _close(ps.last_kernel[lane].numpy(), js[lane].last_kernel,
                   FILTER_ATOL, "last kernel")
            assert np.array_equal(ps.history[lane].numpy(), js[lane].history)


def test_adacomb_matches_jax():
    """Lags that change between subframes, 300 (the history's limit) among
    them, and a lag change across frames."""
    rng = np.random.default_rng(3)
    kj, kp = _lin(rng, F, KS)
    gj, gp = _lin(rng, F, 1)
    ggj, ggp = _lin(rng, F, 1)
    win = JD.compute_overlap_window(OV)
    lags = np.array([[[300, 120, 121, 7], [60, 60, 61, 288]],
                     [[7, 300, 32, 300], [150, 33, 300, 200]]])
    b, n = lags.shape[1], lags.shape[2]
    js = [JD.adacomb_init(KS) for _ in range(b)]
    ps = PD.adacomb_init(b, KS, device="cpu")
    for frame in range(lags.shape[0]):
        x = (rng.standard_normal((b, n * FR)) * 0.5).astype(np.float32)
        fe = (rng.standard_normal((b, n, F)) * 0.5).astype(np.float32)
        ps, got = PD.adacomb_process_frame(
            ps, _t(x), _t(fe), kp, gp, ggp, _t(lags[frame]), FR, OV, KS, 8,
            JO.COMB_GAIN_A, 0.0, JO.LOG_GAIN_LIMIT)
        for lane in range(b):
            for s in range(n):
                js[lane], ref = JD.adacomb_process_frame(
                    js[lane], x[lane, s * FR:(s + 1) * FR], fe[lane, s], kj,
                    gj, ggj, int(lags[frame, lane, s]), FR, OV, KS, 8,
                    JO.COMB_GAIN_A, 0.0, JO.LOG_GAIN_LIMIT, win)
                _close(got[lane, s * FR:(s + 1) * FR].numpy(), ref,
                       FILTER_ATOL, f"frame {frame} lane {lane} sub {s}")
            st = js[lane]
            assert int(ps.last_pitch_lag[lane]) == st.last_pitch_lag
            assert np.array_equal(ps.history[lane].numpy(), st.history)
            _close(ps.last_global_gain[lane].item(), st.last_global_gain,
                   FILTER_ATOL, "global gain")


@pytest.mark.parametrize("interpolate_k,frame,pool", [(1, 80, 4),
                                                      (2, 160, 8)])
def test_adashape_matches_jax(interpolate_k, frame, pool):
    """NoLACE's shaper (interpolate_k 1) and BBWE's (2, 160 samples)."""
    rng = np.random.default_rng(4 + interpolate_k)
    hidden, tenv = frame // interpolate_k, frame // pool
    a1fj, a1fp = _lin(rng, 2 * F, hidden)
    a1tj, a1tp = _lin(rng, 2 * (tenv + 1), hidden)
    a2j, a2p = _lin(rng, 2 * hidden, hidden)
    b, n = 2, 4
    js = [JD.adashape_init(F, frame, pool, interpolate_k) for _ in range(b)]
    ps = PD.adashape_init(b, F, frame, pool, interpolate_k, device="cpu")
    for k in range(2):
        x = (rng.standard_normal((b, n * frame)) * 0.5).astype(np.float32)
        fe = (rng.standard_normal((b, n, F)) * 0.5).astype(np.float32)
        ps, got = PD.adashape_process_frame(ps, _t(x), _t(fe), a1fp, a1tp,
                                            a2p, frame, pool, interpolate_k)
        for lane in range(b):
            for s in range(n):
                js[lane], ref = JD.adashape_process_frame(
                    js[lane], x[lane, s * frame:(s + 1) * frame], fe[lane, s],
                    a1fj, a1tj, a2j, frame, pool, interpolate_k)
                _close(got[lane, s * frame:(s + 1) * frame].numpy(), ref,
                       FILTER_ATOL, f"frame {k} lane {lane} sub {s}")
            # the log envelope: numpy's float32 log is not correctly
            # rounded, the port's is
            _close(ps.alpha1t_mem[lane].numpy(), js[lane].alpha1t_mem,
                   FILTER_ATOL, "envelope memory")


def test_calculate_features_matches_jax():
    """4 lanes of distinct lags and signal types (inactive, unvoiced,
    voiced at the shortest and longest lags) over 2 frames."""
    rng = np.random.default_rng(5)
    b = 4
    sig_type = np.array([0, 1, 2, 2])
    st_p = PF.init_feature_state(b, device="cpu")
    st_j = [JF.init_feature_state() for _ in range(b)]
    t = np.arange(320) / 16000
    for frame in range(2):
        xq = np.stack([(3000 * (lane + 1) * np.sin(2 * np.pi * 140 * t)
                        + 300 * rng.standard_normal(320)).astype(np.int64)
                       for lane in range(b)])
        num_bits = rng.integers(20, 500, b)
        a_q12 = (rng.standard_normal((b, 2, 16)) * 600).astype(np.int64)
        lags = np.array([[40, 41, 42, 43], [100, 100, 100, 100],
                         [32, 33, 34, 35], [288, 287, 286, 285]])
        ltp = rng.integers(-3000, 12000, (b, 20))
        gains = rng.integers(1 << 10, 1 << 24, (b, 4))
        st_p, feats, numbits, periods = PF.calculate_features(
            st_p, _t(xq), _t(num_bits), _t(a_q12), _t(lags), _t(ltp),
            _t(gains), _t(sig_type), 16)
        for lane in range(b):
            st_j[lane], f_j, nb_j, per_j = JF.calculate_features(
                st_j[lane], xq[lane], int(num_bits[lane]), a_q12[lane],
                lags[lane], ltp[lane], gains[lane], int(sig_type[lane]), 16)
            assert np.array_equal(periods[lane].numpy(), per_j)
            assert np.array_equal(numbits[lane].numpy(), nb_j)
            _close(feats[lane].numpy(), f_j, FEAT_ATOL,
                   f"frame {frame} lane {lane} features")
            assert st_p.numbits_smooth[lane].item() == \
                st_j[lane].numbits_smooth
            assert np.array_equal(st_p.signal_history[lane].numpy(),
                                  st_j[lane].signal_history)


def test_numbits_embedding_matches_jax():
    scales = JO.default_numbits_scales()
    nb = np.array([0.0, 1.0, 49.9, 50.0, 123.45, 650.0, 1e4], np.float32)
    got = PO.numbits_embedding(_t(nb), _t(scales)).numpy()
    for k, v in enumerate(nb):
        _close(got[k], JO.numbits_embedding(float(v), scales), FEAT_ATOL,
               f"numbits {v}")


@pytest.fixture(scope="module")
def models():
    return {1: (JO.random_lace_model(50),
                PO.random_lace_model(50, device="cpu")),
            2: (JO.random_nolace_model(60),
                PO.random_nolace_model(60, device="cpu"))}


@pytest.fixture(scope="module")
def frames():
    """LANES' first 3 frames: the SILK fixture's unenhanced PCM and the
    features, numbits and periods the JAX enhancer computed from them."""
    sfx = np.load(os.path.join(DATA, "torch_silk16k_24k.npz"))
    ofx = np.load(os.path.join(DATA, "torch_osce_wb20ms.npz"))
    lanes = list(LANES)
    return dict(x=sfx["xq"][lanes, :3].astype(np.float32) / 32768.0,
                features=ofx["features"][0][lanes, :3],
                numbits=ofx["numbits"][0][lanes, :3],
                periods=ofx["periods"][0][lanes, :3].astype(np.int64))


def _leaves(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if x is not None]


@pytest.mark.parametrize("method", [1, 2])
def test_random_models_and_converters_equal_jax(models, method):
    jm, pm = models[method]
    conv = convert.lace_from_jax if method == 1 else convert.nolace_from_jax
    port_leaves = _leaves(pm)
    assert len(port_leaves) == len(_leaves(conv(jm)))
    for a, b in zip(port_leaves, _leaves(conv(jm))):
        assert torch.equal(a, b)
    to_arrays = (JO.lace_model_to_arrays, PO.lace_model_to_arrays) \
        if method == 1 else (JO.nolace_model_to_arrays,
                             PO.nolace_model_to_arrays)
    ja, pa = to_arrays[0](jm), to_arrays[1](pm)
    assert [a.name for a in pa] == [a.name for a in ja]
    for a, b in zip(pa, ja):
        assert a.type == b.type and np.array_equal(a.data, np.asarray(b.data))


@pytest.mark.parametrize("method,what", [(1, "feature_net"), (1, "frame"),
                                         (2, "feature_net"), (2, "frame")])
def test_osce_models_match_jax(models, frames, method, what):
    """The feature net alone, and LACE's / NoLACE's whole frame, over 3
    frames with state carried on 3 lanes."""
    jm, pm = models[method]
    nl = len(LANES)
    if method == 1:
        js = [JO.lace_init_state() for _ in range(nl)]
        ps = PO.lace_init_state(nl, device="cpu")
        jproc, pproc = JO.lace_process_frame, PO.lace_process_frame
    else:
        js = [JO.nolace_init_state() for _ in range(nl)]
        ps = PO.nolace_init_state(nl, device="cpu")
        jproc, pproc = JO.nolace_process_frame, PO.nolace_process_frame
    peak = [0.0] * nl
    for f in range(3):
        args = [frames[k][:, f] for k in ("x", "features", "numbits",
                                          "periods")]
        if what == "feature_net":
            fs, cond = PO.feature_net(pm, ps.fnet, *map(_t, args[1:]))
            ps = ps._replace(fnet=fs)
            for lane in range(nl):
                j, ref = JO.feature_net(jm, js[lane].fnet,
                                        *(a[lane] for a in args[1:]))
                js[lane] = js[lane]._replace(fnet=j)
                _close(cond[lane].numpy(), ref, COND_ATOL,
                       f"frame {f} lane {lane} cond")
                _close(fs.conv2_mem[lane].numpy(), j.conv2_mem, COND_ATOL,
                       "conv2 memory")
            continue
        ps, out = pproc(pm, ps, *map(_t, args))
        for lane in range(nl):
            js[lane], ref = jproc(jm, js[lane], *(a[lane] for a in args))
            env = max(peak[lane], float(np.max(np.abs(ref))))
            peak[lane] = float(np.max(np.abs(ref)))
            _close(out[lane].numpy(), ref, CS.osce_pcm_bound(env) / 32768,
                   f"frame {f} lane {lane} output (peak {env:.3g})")
            _close(ps.fnet.gru[lane].numpy(), js[lane].fnet.gru, COND_ATOL,
                   "GRU state")
            assert ps.preemph_mem[lane].item() == js[lane].preemph_mem


def test_enhancer_passes_through_and_resets_off_wideband_20ms():
    """Frames that are not 16 kHz with 4 subframes come back unchanged and
    reset every lane; the first frame after a reset passes through."""
    model = PO.random_lace_model(50, device="cpu")
    enh = PO.OSCEEnhancer(PO.OSCE_METHOD_LACE, model, 2, device="cpu")
    rng = np.random.default_rng(6)
    xq = _t(rng.integers(-8000, 8000, (2, 320)))
    args = dict(num_bits=_t(np.array([100, 200])),
                pred_coef_q12=_t(rng.integers(-500, 500, (2, 2, 16))),
                pitch_lags=_t(np.full((2, 4), 100)),
                ltp_coef_q14=_t(np.zeros((2, 20), np.int64)),
                gains_q16=_t(np.full((2, 4), 1 << 16)),
                signal_type=_t(np.array([2, 1])), lpc_order=16)
    assert torch.equal(enh.enhance_frame(xq, fs_khz=16, nb_subfr=4, **args),
                       xq)
    assert enh.reset_count.tolist() == [1, 1]
    for fs_khz, nb in ((8, 4), (12, 4), (16, 2)):
        assert enh.enhance_frame(xq, fs_khz=fs_khz, nb_subfr=nb, **args) \
            is xq
        assert enh.reset_count.tolist() == [2, 2]
    assert torch.equal(enh.enhance_frame(xq, fs_khz=16, nb_subfr=4, **args),
                       xq)
    with pytest.raises(ValueError):
        PO.OSCEEnhancer(0, model, 2, device="cpu")
