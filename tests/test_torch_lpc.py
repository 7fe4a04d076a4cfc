"""The port's SILK LPC synthesis (opus_tpu_torch/ops/lpc.py, the plain
version of kernel K4) against the JAX package's: the lax.scan branch of
batched_silk._lpc_subframe at every SILK subframe length (sf 40, 60, 80),
and the Pallas kernel lpc_pallas.lpc_subframe in interpret mode at sf 40
and 80 (it computes only sf // 8 * 8 samples, so not at 60).  Identical
outputs and state."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opus_tpu.models.batched_silk import _lpc_subframe
from opus_tpu.ops.lpc_pallas import lpc_subframe as pallas_lpc_subframe
from opus_tpu_torch.ops import lpc


def _inputs(b, sf, order, seed):
    rng = np.random.default_rng(seed)
    res = rng.integers(-1 << 24, 1 << 24, size=(b, sf))
    a = rng.integers(-28000, 28000, size=(b, 16))
    a[:, order:] = 0
    slpc = rng.integers(-1 << 27, 1 << 27, size=(b, 16))
    return res, a, slpc


def _port(slpc, res, a_rev, order_half):
    v, s = lpc.lpc_subframe_plain(torch.from_numpy(slpc),
                                  torch.from_numpy(res),
                                  torch.from_numpy(a_rev), order_half)
    assert v.dtype == torch.int32 and s.dtype == torch.int32
    return v.numpy(), s.numpy()


@pytest.mark.parametrize("b,sf,order", [(4, 80, 16), (130, 40, 10),
                                        (1, 80, 16), (8, 60, 12)])
def test_torch_lpc_plain_matches_scan(b, sf, order):
    res, a, slpc = _inputs(b, sf, order, 42 + b)
    v_ref, s_ref = _lpc_subframe(jnp.asarray(slpc, jnp.int32),
                                 jnp.asarray(res, jnp.int32),
                                 jnp.asarray(a, jnp.int32), order >> 1)
    v, s = _port(slpc, res, a[:, ::-1].copy(), order >> 1)
    assert np.array_equal(v, np.asarray(v_ref))
    assert np.array_equal(s, np.asarray(s_ref))


def test_torch_lpc_plain_saturation_paths():
    """Extreme states/residuals exercise ADD_SAT32/LSHIFT_SAT32 (the case
    of tests/test_lpc_pallas.py)."""
    b, sf = 8, 32
    rng = np.random.default_rng(0)
    res = rng.choice(np.array([2**31 - 1, -2**31, 0, 12345], np.int64),
                     size=(b, sf))
    a_rev = rng.integers(-32768, 32767, size=(b, 16))
    slpc = rng.choice(np.array([2**30, -2**30, 7, -7], np.int64),
                      size=(b, 16))
    v_ref, s_ref = _lpc_subframe(jnp.asarray(slpc, jnp.int32),
                                 jnp.asarray(res, jnp.int32),
                                 jnp.asarray(a_rev[:, ::-1], jnp.int32), 8)
    v, s = _port(slpc, res, a_rev, 8)
    assert np.array_equal(v, np.asarray(v_ref))
    assert np.array_equal(s, np.asarray(s_ref))


@pytest.mark.parametrize("sf", [40, 80])
def test_torch_lpc_plain_matches_pallas_interpret(sf):
    res, a, slpc = _inputs(16, sf, 16, 7 + sf)
    a_rev = a[:, ::-1].copy()
    v_ref, s_ref = pallas_lpc_subframe(
        jnp.asarray(slpc, jnp.int32), jnp.asarray(res, jnp.int32),
        jnp.asarray(a_rev, jnp.int32), 8, interpret=True)
    v, s = _port(slpc, res, a_rev, 8)
    assert np.array_equal(v, np.asarray(v_ref))
    assert np.array_equal(s, np.asarray(s_ref))


def test_torch_lpc_wrapper_routes_cpu_to_plain():
    """A CPU tensor runs the plain version and counts no launch; any other
    device goes to the kernel's checks, which refuse a non-CUDA tensor
    instead of falling back."""
    res, a, slpc = _inputs(5, 60, 16, 3)
    args = (torch.from_numpy(slpc), torch.from_numpy(res),
            torch.from_numpy(a[:, ::-1].copy()), 8)
    before = lpc.launches
    v, s = lpc.lpc_subframe(*args)
    vp, sp = lpc.lpc_subframe_plain(*args)
    assert torch.equal(v, vp) and torch.equal(s, sp)
    assert lpc.launches == before
    meta = [x.to("meta") for x in args[:3]]
    with pytest.raises(ValueError):
        lpc.lpc_subframe(*meta, 8)
    assert lpc.launches == before
