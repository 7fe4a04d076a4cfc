"""The port's RDOVAE and FARGAN networks and their batched drivers
(opus_tpu_torch/dnn/{rdovae,fargan}.py, models/batched_dnn.py) against the
JAX package's (opus_tpu/dnn/{rdovae,fargan}.py, models/batched_dnn.py) on
seeded random weights at the published widths and seeded numpy inputs.

Bounds.  The random models, the converted JAX models and the weight blobs
are equal array for array and byte for byte.  The forward passes differ
only in the order of the matrix products' sums (the activations are
bit-exact, tests/test_torch_dnn_nnet.py), so everything is held to the JAX
package's own batched-vs-scalar bound, rtol 2e-4 / atol 2e-5
(tests/test_dnn_recovery.py).  Measured at B = 4 (the tests print it):
the RDOVAE encoder within 6.6e-7 over 4 steps, the decoder within 4.2e-7
over 3 qframes, FARGAN's PCM within 2.4e-7 after priming and 6 frames (28
subframes of feedback through its GRUs and exp(gain)).
Pitch periods are integers and compared exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opus_tpu.dnn import dred as JD
from opus_tpu.dnn import fargan as JF
from opus_tpu.dnn import rdovae as JR
from opus_tpu.dnn import weights as JW
from opus_tpu.models import batched_dnn as JB
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import dred as PD
from opus_tpu_torch.dnn import fargan as PF
from opus_tpu_torch.dnn import rdovae as PV
from opus_tpu_torch.dnn import weights as PW
from opus_tpu_torch.models import batched_dnn as PB

RTOL, ATOL = 2e-4, 2e-5
B = 4


def _leaves(tree):
    """A model's arrays in field order (None leaves skipped)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields") or isinstance(tree, tuple):
        return [a for v in tree for a in _leaves(v)]
    return [np.asarray(tree.cpu() if torch.is_tensor(tree) else tree)]


def _structure(tree):
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return (type(tree).__name__,
                tuple((f, _structure(getattr(tree, f))) for f in tree._fields))
    if isinstance(tree, tuple):
        return tuple(_structure(v) for v in tree)
    return tuple(tree.shape)


def _same_model(jax_model, port_model):
    assert _structure(jax_model) == _structure(port_model)
    a, b = _leaves(jax_model), _leaves(port_model)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def models():
    return dict(
        jenc=JR.random_enc_model(41), penc=PV.random_enc_model(41,
                                                               device="cpu"),
        jdec=JR.random_dec_model(42), pdec=PV.random_dec_model(42,
                                                               device="cpu"),
        jfg=JF.random_model(46), pfg=PF.random_model(46, device="cpu"))


def test_torch_dnn_random_models_equal_jax(models):
    """random_enc_model / random_dec_model / random_model / random_stats:
    the published widths (~0.8 M FARGAN and ~0.5 M RDOVAE decoder
    parameters) and the same arrays as the JAX package's from the seed;
    the converters give the same models from the JAX ones."""
    for j, p in (("jenc", "penc"), ("jdec", "pdec"), ("jfg", "pfg")):
        _same_model(models[j], models[p])
    _same_model(models["jfg"], convert.fargan_from_jax(models["jfg"]))
    _same_model(models["jenc"], convert.rdovae_enc_from_jax(models["jenc"]))
    _same_model(models["jdec"], convert.rdovae_dec_from_jax(models["jdec"]))
    n_fg = sum(a.size for a in _leaves(models["pfg"]))
    n_dec = sum(a.size for a in _leaves(models["pdec"]))
    assert 800_000 < n_fg < 830_000 and 500_000 < n_dec < 530_000, \
        (n_fg, n_dec)
    js, ps = JD.random_stats(43), PD.random_stats(43)
    assert PD.DREDStats._fields == JD.DREDStats._fields
    for f in JD.DREDStats._fields:
        assert np.array_equal(getattr(js, f), getattr(ps, f))
        assert getattr(ps, f).dtype == np.uint8
    conv = convert.dred_stats_from_jax(js)
    assert all(np.array_equal(getattr(conv, f), getattr(js, f))
               for f in JD.DREDStats._fields)


def test_torch_dnn_weight_blobs_round_trip(models):
    """model_to_arrays -> write_blob is byte-identical to the JAX
    package's blob; the port's parse_blob -> *_from_arrays rebuilds the
    same models (so the same forward pass, bit for bit)."""
    jblob = JW.write_blob(JR.model_to_arrays(models["jenc"], models["jdec"]))
    pblob = PW.write_blob(PV.model_to_arrays(models["penc"], models["pdec"]))
    assert pblob == jblob
    arrays = PW.parse_blob(pblob)
    _same_model(models["jenc"], PV.enc_model_from_arrays(arrays,
                                                         device="cpu"))
    _same_model(models["jdec"], PV.dec_model_from_arrays(arrays,
                                                         device="cpu"))
    jblob = JW.write_blob(JF.model_to_arrays(models["jfg"]))
    pblob = PW.write_blob(PF.model_to_arrays(models["pfg"]))
    assert pblob == jblob
    _same_model(models["jfg"], PF.model_from_arrays(PW.parse_blob(pblob),
                                                    device="cpu"))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


def test_torch_rdovae_encode_dframe(models):
    rng = np.random.default_rng(50)
    js = JR.enc_init_state((B,))
    ps = PV.enc_init_state((B,), device="cpu")
    worst = 0.0
    for t in range(4):
        x = (0.5 * rng.standard_normal((B, 40))).astype(np.float32)
        js, jz, ji = JR.encode_dframe(models["jenc"], js, jnp.asarray(x))
        ps, pz, pi = PV.encode_dframe(models["penc"], ps, torch.from_numpy(x))
        for a, b in ((jz, pz), (ji, pi)) + tuple(zip(js.conv, ps.conv)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                       atol=ATOL)
            worst = max(worst, _err(a, b))
    print(f"RDOVAE encoder, 4 steps at B={B}: max abs err {worst:.3g}")


def test_torch_rdovae_decode_qframe_decode_all_and_batched(models):
    rng = np.random.default_rng(51)
    init = (0.5 * rng.standard_normal((B, 24))).astype(np.float32)
    lat = (0.5 * rng.standard_normal((3, B, 81))).astype(np.float32)
    _, jq = JB.rdovae_decode_frames(models["jdec"], jnp.asarray(init),
                                    jnp.asarray(lat))
    _, pq = PB.rdovae_decode_frames(models["pdec"], torch.from_numpy(init),
                                    torch.from_numpy(lat))
    assert pq.shape == (3, B, 80)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=RTOL,
                               atol=ATOL)
    # one qframe step, and decode_all of one stream (T x 81 -> 4T x 20)
    js = JR.dec_init_state(models["jdec"], jnp.asarray(init))
    ps = PV.dec_init_state(models["pdec"], torch.from_numpy(init))
    js, jq1 = JR.decode_qframe(models["jdec"], js, jnp.asarray(lat[0]))
    ps, pq1 = PV.decode_qframe(models["pdec"], ps, torch.from_numpy(lat[0]))
    np.testing.assert_allclose(pq1.numpy(), np.asarray(jq1), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(js.gru + js.conv, ps.gru + ps.conv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    ja = JR.decode_all(models["jdec"], jnp.asarray(init[1]),
                       jnp.asarray(lat[:, 1]))
    pa = PV.decode_all(models["pdec"], torch.from_numpy(init[1]),
                       torch.from_numpy(lat[:, 1]))
    assert pa.shape == (12, 20)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    print(f"RDOVAE decoder, 3 qframes at B={B}: max abs err "
          f"{_err(jq, pq):.3g}")


def test_torch_fargan_period_from_feature_exact():
    """The period's floor(0.5 + 256 / 2**x) rounds at .5: the port's
    float32 steps with the power rounded once from float64 give JAX's
    integer on 200 k features over the pitch range, its edges included."""
    rng = np.random.default_rng(52)
    f = np.zeros((200_000, 20), np.float32)
    f[:, 18] = rng.uniform(-2.5, 2.5, len(f)).astype(np.float32)
    f[:8, 18] = [-1.5, 0.0, 1.0, -2.5, 2.5, -0.5, 0.5, 1.5]
    a = np.asarray(JF.period_from_feature(jnp.asarray(f)))
    b = PF.period_from_feature(torch.from_numpy(f)).numpy()
    assert b.dtype == np.int32
    assert np.array_equal(a, b), np.nonzero(a != b)[0][:5]


def test_torch_fargan_cont_and_synthesize_6_frames(models):
    """cont (priming on 320 samples and 5 feature frames), then 6 frames
    of synthesize_frame at B = 4: state and PCM within the bound, the
    periods equal as integers on every frame; the K2 route's de-emphasis
    stays within the bound of JAX's scan."""
    rng = np.random.default_rng(53)
    pcm0 = np.clip(0.2 * rng.standard_normal((B, 320)), -1,
                   1).astype(np.float32)
    f0 = (0.3 * rng.standard_normal((B, 5, 20))).astype(np.float32)
    js = JF.cont(models["jfg"], JF.init_state((B,)), jnp.asarray(pcm0),
                 jnp.asarray(f0))
    ps = PF.cont(models["pfg"], PF.init_state(B, device="cpu"),
                 torch.from_numpy(pcm0), torch.from_numpy(f0))
    for a, b in zip(js[:3] + js.gru + (js.deemph_mem,),
                    ps[:3] + ps.gru + (ps.deemph_mem,)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    assert np.array_equal(np.asarray(js.last_period), ps.last_period.numpy())
    worst = 0.0
    for t in range(6):
        f = (0.3 * rng.standard_normal((B, 20))).astype(np.float32)
        if t >= 4:
            # period 39 < 44: frame 5's pitch positions wrap (fargan.c:80)
            f[:, 18] = 1.2
        js, jp = JF.synthesize_frame(models["jfg"], js, jnp.asarray(f))
        ps, pp = PF.synthesize_frame(models["pfg"], ps, torch.from_numpy(f))
        assert pp.shape == (B, 160)
        assert np.array_equal(np.asarray(js.last_period),
                              ps.last_period.numpy()), t
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(ps.pitch_buf.numpy(),
                                   np.asarray(js.pitch_buf), rtol=RTOL,
                                   atol=ATOL)
        worst = max(worst, _err(jp, pp))
    print(f"FARGAN cont + 6 frames at B={B}: max abs PCM err {worst:.3g}")


def _leaves_t(state):
    return [state.pitch_buf, state.cond_conv1_mem, state.fwc0_mem,
            *state.gru, state.deemph_mem, state.last_period]


def test_torch_fargan_unprimed_and_batched_frames(models):
    """From the zero state (last_period 0: the pitch positions clip to the
    buffer before the gather) over 3 frames, fargan_synthesize_frames and
    fargan_batch_step against the JAX package's batched drivers; the
    caller's state tensors are left as they were."""
    rng = np.random.default_rng(54)
    feats = (0.3 * rng.standard_normal((3, B, 20))).astype(np.float32)
    _, jpcm = JB.fargan_synthesize_frames(models["jfg"], JF.init_state((B,)),
                                          jnp.asarray(feats))
    st = PF.init_state(B, device="cpu")
    before = [a.clone() for a in _leaves_t(st)]
    _, ppcm = PB.fargan_synthesize_frames(models["pfg"], st,
                                          torch.from_numpy(feats))
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves_t(st)))
    assert ppcm.shape == (3, B, 160)
    np.testing.assert_allclose(ppcm.numpy(), np.asarray(jpcm), rtol=RTOL,
                               atol=ATOL)
    step = PB.fargan_batch_step(models["pfg"])
    s = PF.init_state(B, device="cpu")
    for t in range(3):
        s, p = step(s, torch.from_numpy(feats[t]))
        assert torch.equal(p, ppcm[t])

