"""The postfilter phases that kernel_celt_decode_to_pcm carries to the next
frame, against the JAX reference's rule (fused_celt_decode_to_pcm,
opus_tpu/models/celt_dec_fused.py:1710-1715; libopus celt_decoder.c:
1592-1596): for LM != 0 the old phase becomes the new postfilter, for LM 0
it becomes the current one (period at least COMBFILTER_MINPERIOD).

Both functions run with their symbol pass replaced by the same fixed
output (distinct old, current and new postfilter values on every stream),
so the carry is checked at LM 0 (2.5 ms) without an LM-0 symbol pass, and
at LM 3 (20 ms).  Integer carries must be identical, gains too (they are
copied, not computed).
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.models import celt_dec_kernel as CK
from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state

B = 4
PF_OLD = dict(pf_period_old=[40, 15, 700, 90],
              pf_gain_old=[0.125, 0.25, 0.375, 0.5],
              pf_tapset_old=[2, 1, 0, 2])
PF_CUR = dict(pf_period=[100, 0, 300, 20],
              pf_gain=[0.1875, 0.0, 0.65625, 0.09375],
              pf_tapset=[1, 0, 2, 1])
PF_NEW = dict(pf_pitch=[200, 250, 0, 40],
              pf_gain=[0.28125, 0.75, 0.0, 0.46875],
              pf_tapset=[0, 2, 0, 1])


def _symbols(nb, nx, rng):
    """A fixed symbol-pass output: random X and energies, no silence,
    no error, the new postfilter values of PF_NEW."""
    return dict(
        X=rng.normal(0, 0.3, (B, nx)).astype(np.float32),
        energies=rng.normal(2, 1, (B, nb)).astype(np.float32),
        silence=np.zeros(B, np.int64), is_transient=np.zeros(B, np.int64),
        pf_pitch=np.asarray(PF_NEW["pf_pitch"], np.int64),
        pf_gain=np.asarray(PF_NEW["pf_gain"], np.float32),
        pf_tapset=np.asarray(PF_NEW["pf_tapset"], np.int64),
        error=np.zeros(B, np.int64),
        rng=rng.integers(0, 2 ** 32, B).astype(np.int64))


def _torch_carry(frame_size, sym):
    tabs = CK.dec_tabs(48000, frame_size)
    state = fused_celt_init_state(B, tabs)
    for k, v in {**PF_OLD, **PF_CUR}.items():
        state[k] = torch.tensor(v, dtype=state[k].dtype)

    def stub(*_args):
        return {k: torch.from_numpy(v) for k, v in sym.items()}

    buf = torch.zeros((B, 8), dtype=torch.uint8)
    lens = torch.full((B,), 8, dtype=torch.int64)
    _pcm, new, _err = CK.kernel_celt_decode_to_pcm(buf, lens, state, tabs,
                                                   frame_fn=stub)
    return {k: new[k].numpy() for k in PF_OLD}


def _jax_carry(frame_size, sym, monkeypatch):
    import jax.numpy as jnp

    from opus_tpu.models import celt_dec_fused as JF

    tabs = JF.DecTabs(48000, frame_size)
    state = JF.fused_celt_init_state(B, tabs)
    for k, v in {**PF_OLD, **PF_CUR}.items():
        state[k] = jnp.asarray(v, dtype=state[k].dtype)

    def stub(*_args, **_kw):
        out = dict(X=jnp.asarray(sym["X"]),
                   energies=[jnp.asarray(sym["energies"][:, i])
                             for i in range(tabs.nb)],
                   silence=jnp.asarray(sym["silence"], jnp.int32),
                   is_transient=jnp.asarray(sym["is_transient"], jnp.int32),
                   pf_pitch=jnp.asarray(sym["pf_pitch"], jnp.int32),
                   pf_gain=jnp.asarray(sym["pf_gain"]),
                   pf_tapset=jnp.asarray(sym["pf_tapset"], jnp.int32))
        d = dict(error=jnp.asarray(sym["error"], jnp.int32),
                 rng=jnp.asarray(sym["rng"].astype(np.uint32)))
        return out, dict(d=d)

    monkeypatch.setattr(JF, "fused_celt_decode_frame", stub)
    buf = jnp.zeros((B, 8), jnp.uint8)
    lens = jnp.full((B,), 8, jnp.int32)
    _pcm, new, _err = JF.fused_celt_decode_to_pcm(buf, lens, state, tabs)
    return {k: np.asarray(new[k]) for k in PF_OLD}


@pytest.mark.parametrize("frame_size", [120, 960])
def test_torch_celt_postfilter_carry_matches_jax_rule(frame_size,
                                                      monkeypatch):
    tabs = CK.dec_tabs(48000, frame_size)
    sym = _symbols(tabs.nb, tabs.nx, np.random.default_rng(frame_size))
    got = _torch_carry(frame_size, sym)
    ref = _jax_carry(frame_size, sym, monkeypatch)
    if tabs.lm != 0:
        want = dict(pf_period_old=PF_NEW["pf_pitch"],
                    pf_gain_old=PF_NEW["pf_gain"],
                    pf_tapset_old=PF_NEW["pf_tapset"])
    else:
        want = dict(pf_period_old=[max(p, 15) for p in PF_CUR["pf_period"]],
                    pf_gain_old=PF_CUR["pf_gain"],
                    pf_tapset_old=PF_CUR["pf_tapset"])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, got[k].dtype),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k], ref[k].astype(got[k].dtype),
                                      err_msg=k)
