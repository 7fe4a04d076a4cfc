"""The port's neural layer runtime and weight blobs
(opus_tpu_torch/dnn/{nnet,weights}.py) against the JAX package's
(opus_tpu/dnn/{nnet,weights}.py) on the same seeded numpy inputs.

Bounds: the activations are the same float32 operations in the same order,
so they are bit-exact (0 ULP) elementwise; the softmax's row sum is taken
in another order (1 ULP of the sum).  Layers with a matrix product sum in
another order than XLA's: rtol 1e-5 / atol 1e-6 (a 600-term f32 dot
product of O(1) terms errs up to ~600 u = 4e-5 of its terms' magnitude
sum; measured on 688-term products with outputs of order 1-4: 3e-6).
The weight blobs are byte-identical, and every weight format dequantizes
to the JAX package's matrix bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opus_tpu.dnn import nnet as J
from opus_tpu.dnn import weights as JW
from opus_tpu_torch.dnn import nnet as P
from opus_tpu_torch.dnn import weights as PW

RTOL, ATOL = 1e-5, 1e-6


def _extremes():
    """Values at the approximations' edges: +-60, lpcnet_exp2's -50
    cutoff on either side (after the 1/ln 2 scaling of lpcnet_exp too),
    the float32 exponent's wrap, signed zeros and tiny values."""
    x = [-60, 60, -50.0, -49.99, -50.01, -51, -34.6, -34.7, -35.0, -72.1,
         -72.2, 88.0, 100.0, -100.0, 0.0, -0.0, 1e-30, -1e-30, 1e-6, 0.5,
         -0.5, 1.0, 8.9, 9.0, 9.1]
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ["tanh_approx", "sigmoid_approx",
                                  "lpcnet_exp2", "lpcnet_exp"])
def test_torch_dnn_approximations_bit_exact(name):
    rng = np.random.default_rng(1)
    x = np.concatenate([_extremes(),
                        (12 * rng.standard_normal(20000)).astype(np.float32)])
    a = np.asarray(getattr(J, name)(jnp.asarray(x)))
    b = getattr(P, name)(torch.from_numpy(x)).numpy()
    assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
        x[a.view(np.int32) != b.view(np.int32)][:5]
    if name == "lpcnet_exp2":
        assert (b[x < -50] == 0).all() and (b[(x >= -50) & (x < 0)] > 0).all()


@pytest.mark.parametrize("act", range(7))
def test_torch_dnn_compute_activation(act):
    rng = np.random.default_rng(2 + act)
    x = (4 * rng.standard_normal((6, 33))).astype(np.float32)
    x[0, :len(_extremes())] = _extremes()
    a = np.asarray(J.compute_activation(jnp.asarray(x), act))
    b = P.compute_activation(torch.from_numpy(x), act).numpy()
    if act == J.ACTIVATION_SOFTMAX:
        # rows sum to 1; the sum's order differs: 1 ULP of the row sum
        np.testing.assert_allclose(b.sum(-1), 1.0, rtol=1e-6)
        np.testing.assert_allclose(b, a, rtol=2e-7, atol=1e-30)
    else:
        assert np.array_equal(a, b)


def _lin(rng, m, n, bias=True, diag=False):
    w = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32) if bias else None
    d = rng.standard_normal(n).astype(np.float32) if diag else None
    return J.np_linear(w, b, d), P.np_linear(w, b, d, device="cpu")


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(b.numpy() if torch.is_tensor(b) else b,
                               np.asarray(a), rtol=rtol, atol=atol)


def test_torch_dnn_linear_dense_glu_with_diag():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    jl, pl = _lin(rng, 48, 144, diag=True)
    _close(J.linear(jl, jnp.asarray(x)), P.linear(pl, torch.from_numpy(x)))
    jl, pl = _lin(rng, 48, 48, bias=False)
    _close(J.glu(jl, jnp.asarray(x)), P.glu(pl, torch.from_numpy(x)))
    for act in range(7):
        jl, pl = _lin(rng, 48, 20)
        _close(J.dense(jl, jnp.asarray(x), act),
               P.dense(pl, torch.from_numpy(x), act))
    with pytest.raises(ValueError):
        P.linear(P.np_linear(np.zeros((4, 8), np.float32),
                             diag=np.zeros(8, np.float32), device="cpu"),
                 torch.zeros(2, 4))


def test_torch_dnn_gru_over_steps():
    rng = np.random.default_rng(4)
    ji, pi = _lin(rng, 40, 96)
    jr, pr = _lin(rng, 32, 96, diag=True)
    js = jnp.zeros((3, 32))
    ps = torch.zeros(3, 32)
    for t in range(6):
        x = rng.standard_normal((3, 40)).astype(np.float32)
        js = J.gru(ji, jr, js, jnp.asarray(x))
        ps = P.gru(pi, pr, ps, torch.from_numpy(x))
        _close(js, ps)


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_torch_dnn_conv1d_streaming(dilation):
    rng = np.random.default_rng(5 + dilation)
    n_in, ksize = 16, 3
    jl, pl = _lin(rng, n_in * ksize, 24)
    mem_n = n_in * dilation * (ksize - 1)
    jm, pm = jnp.zeros((2, mem_n)), torch.zeros(2, mem_n)
    for t in range(7):
        x = rng.standard_normal((2, n_in)).astype(np.float32)
        jo, jm = J.conv1d_dilated(jl, jm, jnp.asarray(x), dilation,
                                  J.ACTIVATION_TANH)
        po, pm = P.conv1d_dilated(pl, pm, torch.from_numpy(x), dilation,
                                  P.ACTIVATION_TANH)
        _close(jo, po)
        assert np.array_equal(np.asarray(jm), pm.numpy())


@pytest.mark.parametrize("ktime", [1, 3])
def test_torch_dnn_conv2d_streaming(ktime):
    rng = np.random.default_rng(9 + ktime)
    out_ch, in_ch, kh, height = 4, 3, 3, 10
    w = rng.standard_normal((out_ch, in_ch, ktime, kh)).astype(np.float32)
    b = rng.standard_normal(out_ch).astype(np.float32)
    jc = J.Conv2d(jnp.asarray(w), jnp.asarray(b))
    pc = P.Conv2d(torch.from_numpy(w), torch.from_numpy(b))
    shape = (2, ktime - 1, in_ch, height + kh - 1)
    jm, pm = jnp.zeros(shape), torch.zeros(shape)
    for t in range(4):
        x = rng.standard_normal((2, in_ch, height + kh - 1)) \
            .astype(np.float32)
        jo, jm = J.conv2d(jc, jm, jnp.asarray(x), height, J.ACTIVATION_TANH)
        po, pm = P.conv2d(pc, pm, torch.from_numpy(x), height,
                          P.ACTIVATION_TANH)
        assert po.shape == (2, out_ch, height)
        _close(jo, po)
        assert np.array_equal(np.asarray(jm), pm.numpy())


def test_torch_dnn_embedding():
    rng = np.random.default_rng(12)
    table = rng.standard_normal((224, 12)).astype(np.float32)
    idx = rng.integers(0, 224, (3, 5))
    assert np.array_equal(
        np.asarray(J.embedding(jnp.asarray(table), jnp.asarray(idx))),
        P.embedding(torch.from_numpy(table), torch.from_numpy(idx)).numpy())


def _blob_arrays(rng):
    """One array of every weight type, and a sparse and an int8 layer."""
    rows, cols = 16, 8
    dense = rng.standard_normal(rows * cols).astype(np.float32)
    idx = np.array([2, 0, 4, 1, 4], np.int32)       # per 8 rows: count, pos
    sparse = rng.standard_normal(3 * 32).astype(np.float32)
    q = rng.integers(-128, 128, rows * cols).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, rows).astype(np.float32)
    bias = rng.standard_normal(rows).astype(np.float32)
    return [
        JW.WeightArray("d_weights_float", JW.WEIGHT_TYPE_FLOAT, dense),
        JW.WeightArray("d_bias", JW.WEIGHT_TYPE_FLOAT, bias),
        JW.WeightArray("s_weights_float", JW.WEIGHT_TYPE_FLOAT, sparse),
        JW.WeightArray("s_weights_idx", JW.WEIGHT_TYPE_INT, idx),
        JW.WeightArray("q_weights_int8", JW.WEIGHT_TYPE_INT8, q),
        JW.WeightArray("q_sparse_int8", JW.WEIGHT_TYPE_QWEIGHT,
                       rng.integers(-128, 128, 96).astype(np.int8)),
        JW.WeightArray("q_scale", JW.WEIGHT_TYPE_FLOAT, scale),
    ]


def test_torch_dnn_blob_round_trip_and_dequantize():
    """write_blob is byte-identical; the port's parse_blob reads the JAX
    blob back; linear_params dequantizes every format to JAX's matrix."""
    rng = np.random.default_rng(13)
    jarr = _blob_arrays(rng)
    blob = JW.write_blob(jarr)
    parr = [PW.WeightArray(a.name, a.type, a.data) for a in jarr]
    assert PW.write_blob(parr) == blob
    parsed = PW.parse_blob(blob)
    jparsed = JW.parse_blob(blob)
    assert parsed.keys() == jparsed.keys()
    for k in parsed:
        assert parsed[k].type == jparsed[k].type
        assert np.array_equal(parsed[k].data, jparsed[k].data)
    kinds = [dict(float_weights="d_weights_float", bias="d_bias"),
             dict(float_weights="s_weights_float",
                  weights_idx="s_weights_idx"),
             dict(weights="q_weights_int8", scale="q_scale"),
             dict(weights="q_sparse_int8", weights_idx="s_weights_idx",
                  scale="q_scale")]
    for kw in kinds:
        jl = JW.linear_params(jparsed, nb_inputs=8, nb_outputs=16, **kw)
        pl = PW.linear_params(parsed, nb_inputs=8, nb_outputs=16,
                              device="cpu", **kw)
        assert np.array_equal(np.asarray(jl.w), pl.w.numpy()), kw
        assert (jl.bias is None) == (pl.bias is None)
    c = PW.conv2d_params(parsed, float_weights="d_weights_float",
                         bias="d_bias", in_channels=2, out_channels=16,
                         ktime=2, kheight=2, device="cpu")
    jc = JW.conv2d_params(jparsed, float_weights="d_weights_float",
                          bias="d_bias", in_channels=2, out_channels=16,
                          ktime=2, kheight=2)
    assert np.array_equal(np.asarray(jc.w), c.w.numpy())
    assert np.array_equal(np.asarray(jc.bias), c.bias.numpy())


@pytest.mark.parametrize("cut", [10, 64 + 5])
def test_torch_dnn_parse_blob_rejects_malformed(cut):
    rng = np.random.default_rng(14)
    blob = PW.write_blob([PW.WeightArray(a.name, a.type, a.data)
                          for a in _blob_arrays(rng)])
    with pytest.raises(ValueError):
        PW.parse_blob(blob[:cut])
    bad = bytearray(blob)
    bad[0:4] = b"XXXX"
    with pytest.raises(ValueError):
        PW.parse_blob(bytes(bad))
