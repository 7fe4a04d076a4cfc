"""The port's synthesis (opus_tpu_torch/models/batched_decode.py) and the
plain de-emphasis of kernel K2 (opus_tpu_torch/ops/iir.py) against the
JAX package on the same seeded numpy inputs.

Tolerances: both sides run the same f32 matmuls, comb taps and recursion
in another order; the IMDCT is a 960-term dot product whose f32 error
bound is ~960 u (u = 2**-24) of the term sum, so 1e-5 of max(1, max|y|)
(the random energies here drive the PCM past full scale).  De-emphasis:
the block form and the scan differ by a few u of y/(1 - c) per sample;
2e-6 of max|y|.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opus_tpu.models import batched_decode as JB
from opus_tpu.ops import iir_pallas
from opus_tpu_torch.models import batched_decode as TB
from opus_tpu_torch.ops import iir

COEF = 0.8500061035


def _inputs(seed, b=8, n=960, nb=21):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 1, n)).astype(np.float32) * 0.1
    e = rng.uniform(-4, 8, (b, 1, nb)).astype(np.float32)
    transient = rng.random(b) < 0.5
    silence = np.zeros(b, bool)
    silence[0] = True
    periods = rng.integers(15, 720, (b, 3)).astype(np.int32)
    gains = rng.uniform(0.0, 0.6, (b, 3, 3)).astype(np.float32)
    gains[1] = 0.0                      # one stream with the comb off
    st = dict(tail=rng.standard_normal((b, 60)).astype(np.float32),
              hist=rng.standard_normal((b, 1026)).astype(np.float32),
              deemph=rng.standard_normal(b).astype(np.float32))
    return x, e, transient, silence, periods, gains, st


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_decode_step_matches_jax(seed):
    x, e, transient, silence, periods, gains, st = _inputs(seed)
    jpcm, jst = JB.decode_step(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(transient),
        jnp.asarray(silence), jnp.asarray(periods), jnp.asarray(gains),
        JB.DecState(**{k: jnp.asarray(v) for k, v in st.items()}))
    tpcm, tst = TB.decode_step(
        torch.from_numpy(x), torch.from_numpy(e),
        torch.from_numpy(transient), torch.from_numpy(silence),
        torch.from_numpy(periods), torch.from_numpy(gains),
        {k: torch.from_numpy(v) for k, v in st.items()})
    ref = np.asarray(jpcm)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(tpcm.numpy() - ref).max() <= 1e-5 * scale
    for k in ("tail", "hist", "deemph"):
        ref = np.asarray(getattr(jst, k))
        scale = max(1.0, np.abs(ref).max())
        assert np.abs(tst[k].numpy() - ref).max() <= 1e-5 * scale, k


@pytest.mark.parametrize("b,n", [(8, 960), (4, 200)])
def test_torch_deemphasis_plain_matches_jax(b, n):
    rng = np.random.default_rng(b * n)
    x = (rng.standard_normal((b, n)) * 3000).astype(np.float32)
    mem = (rng.standard_normal(b) * 3000).astype(np.float32)
    y_s, m_s = iir_pallas.deemphasis_scan(jnp.asarray(x), jnp.asarray(mem),
                                          COEF)
    y_k, m_k = iir_pallas.deemphasis(jnp.asarray(x), jnp.asarray(mem), COEF,
                                     interpret=True)
    y_t, m_t = iir.deemphasis(torch.from_numpy(x), torch.from_numpy(mem),
                              COEF)
    scale = np.abs(np.asarray(y_s)).max()
    for ref, mref in ((y_s, m_s), (y_k, m_k)):
        assert np.abs(y_t.numpy() - np.asarray(ref)).max() <= 2e-6 * scale
        assert np.abs(m_t.numpy() - np.asarray(mref)).max() <= 2e-6 * scale


def test_torch_deemphasis_carry_across_calls():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 1920)).astype(np.float32))
    mem = torch.zeros(3)
    y_full, m_full = iir.deemphasis(x, mem, COEF)
    y1, m1 = iir.deemphasis(x[:, :960], mem, COEF)
    y2, m2 = iir.deemphasis(x[:, 960:], m1, COEF)
    assert torch.allclose(torch.cat([y1, y2], 1), y_full, atol=1e-5)
    assert torch.allclose(m2, m_full, atol=1e-5)
