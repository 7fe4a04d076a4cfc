"""The port's SILK upsampler to 48 kHz (opus_tpu_torch/silk/resampler.py)
against the JAX package's (opus_tpu/silk/resampler_jax.py) and the scalar
Resampler (opus_tpu/silk/resampler.py): exact, on 4 lanes x 5 frames of
seeded int16 input plus full-scale saturating lanes, with the state carried
across from JAX through opus_tpu_torch.convert half way."""

import jax.numpy as jnp
import numpy as np
import torch

from opus_tpu.models import celt_dec_fused as JD
from opus_tpu.models import hybrid_dec_fused as JH
from opus_tpu.silk import resampler_jax as RJ
from opus_tpu.silk.resampler import Resampler
from opus_tpu_torch import convert
from opus_tpu_torch.silk import resampler as RP


def _input(b, nf, n, seed):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((b, nf, n)) * 9000, -32768,
                32767).astype(np.int64)
    x[0] = rng.choice([32767, -32768], size=(nf, n))     # saturating lane
    x[1, :, ::7] = 32767
    return x


def test_torch_upsampler_equals_jax_and_scalar():
    b, nf, n = 4, 5, 320
    x = _input(b, nf, n, 0)
    ref = np.zeros((b, nf, 960), np.int64)
    for i in range(b):
        rs = Resampler(16000, 48000)
        for f in range(nf):
            ref[i, f] = rs.process([int(v) for v in x[i, f]])

    # frames 0-1 in JAX, the state carried into the port for frames 2-4
    st_j = RJ.upsampler_init(b, 16)
    for f in range(2):
        out_j, st_j = RJ.upsample_to_48k(jnp.asarray(x[:, f], jnp.int32),
                                         st_j, 16, 20)
        assert np.array_equal(np.asarray(out_j), ref[:, f])
    jax_state = dict(JH.hybrid_init_state(b, JD.DecTabs(48000, 960,
                                                          start=17)),
                     rs=st_j)
    st_p = convert.hybrid_state_from_jax(jax_state, "cpu")["rs"]
    for f in range(2, nf):
        out_p, st_p = RP.upsample_to_48k(torch.from_numpy(x[:, f]), st_p,
                                         16, 20)
        out_j, st_j = RJ.upsample_to_48k(jnp.asarray(x[:, f], jnp.int32),
                                         st_j, 16, 20)
        assert np.array_equal(out_p.numpy(), ref[:, f]), f
        assert np.array_equal(out_p.numpy(), np.asarray(out_j)), f
        for k in ("s_iir", "s_fir", "delay"):
            assert np.array_equal(st_p[k].numpy(),
                                  np.asarray(getattr(st_j, k))), (f, k)


def test_torch_upsampler_fir_plan_and_init_equal_jax():
    for fs in (8, 12, 16):
        idx, coef = RP._fir_plan(fs, 20)
        idx_j, coef_j, delay_j, n_out = RJ._fir_plan(fs, 20)
        assert np.array_equal(idx, idx_j) and np.array_equal(coef, coef_j)
        assert n_out == 960 and RP.input_delay(fs) == delay_j
        st = RP.upsampler_init(3, fs)
        st_j = RJ.upsampler_init(3, fs)
        for k in ("s_iir", "s_fir", "delay"):
            assert st[k].shape == np.asarray(getattr(st_j, k)).shape
