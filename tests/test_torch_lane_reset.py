"""Per-lane reset and per-lane activity of the port's stateful decoders:
``OSCEEnhancer.reset(lanes)``, ``BBWE.reset(lanes)``,
``LPCNetPLC.reset(lanes)``, ``KernelCeltDecoder.reset(lanes)`` and
``decode_packed(..., active)``, on the CPU.

After a reset, a masked lane stands where a fresh JAX instance stands (its
state equal, leaf for leaf, to the JAX package's initial state) and goes
on as one; a lane outside the mask keeps its state bit for bit and goes on
as the continued instance.  Bounds: states exact; BBWE's int16 within
chip_smoke.bbwe_pcm_bound of the JAX fixture's (tests/data/torch_bbwe.npz:
a fresh JAX BBWE per stream); the CELT decoder's final range exact and its
PCM within 1e-4 (PCM_ABS_TOL) of the scalar ``OpusDecoder``.  OSCE's
enhanced output after the reset is held bit for bit to a fresh port
enhancer (tests/test_torch_osce*.py hold that one to JAX from its initial
state).
"""

import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu.dnn import bbwe as JB
from opus_tpu.dnn import fargan as JFG
from opus_tpu.dnn import osce as JO
from opus_tpu.dnn import pitchdnn as JP
from opus_tpu.dnn import plc as JPL
from opus_tpu.models import celt_dec_fused as JCF
from opus_tpu.models.opus_decoder import OpusDecoder
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import bbwe as PB
from opus_tpu_torch.dnn import osce as PO
from opus_tpu_torch.dnn import plc as PPL
from opus_tpu_torch.models import celt_dec_kernel as CK

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MASK = torch.tensor([True, False, True])


def _leaves(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if x is not None]


def _np_values(tree):
    """Every number of a JAX-side state (arrays, floats, ints)."""
    out = []
    for x in torch.utils._pytree.tree_leaves(tree):
        out.extend(np.asarray(x, np.float64).reshape(-1).tolist())
    return np.asarray(out)


def _check_reset(after, before, mask, fresh_values):
    """Lanes outside ``mask`` bit for bit ``before``; masked lanes hold
    exactly ``fresh_values`` (every leaf's value of a fresh JAX
    instance, here a single value)."""
    for a, z in zip(_leaves(after), _leaves(before)):
        assert torch.equal(a[~mask], z[~mask])
        assert set(np.unique(a[mask].double().numpy())) <= fresh_values


def _osce_args(rng, b):
    return dict(num_bits=torch.from_numpy(rng.integers(200, 600, b)),
                pred_coef_q12=torch.from_numpy(rng.integers(-900, 900,
                                                            (b, 2, 16))),
                pitch_lags=torch.from_numpy(rng.integers(40, 250, (b, 4))),
                ltp_coef_q14=torch.from_numpy(rng.integers(-2000, 4000,
                                                           (b, 20))),
                gains_q16=torch.from_numpy(rng.integers(1 << 14, 1 << 18,
                                                        (b, 4))),
                signal_type=torch.from_numpy(rng.integers(0, 3, b)),
                lpc_order=16, fs_khz=16, nb_subfr=4)


@pytest.mark.parametrize("method", [PO.OSCE_METHOD_LACE,
                                    PO.OSCE_METHOD_NOLACE])
def test_osce_reset_lanes(method):
    model = CS.osce_models("cpu")[method]
    jax_fresh = JO.OSCEEnhancer(method, None)
    rng = np.random.default_rng(method)
    b = len(MASK)
    frames = [(torch.from_numpy(rng.integers(-9000, 9000, (b, 320))),
               _osce_args(rng, b)) for _ in range(5)]
    enh = PO.OSCEEnhancer(method, model, b, device="cpu")
    for x, a in frames[:3]:
        enh.enhance_frame(x, **a)
    kept = copy.copy(enh)
    enh.reset(MASK)
    fresh = set(np.unique(_np_values((jax_fresh.features, jax_fresh.state))))
    assert fresh == {0.0}
    _check_reset((enh.features, enh.state), (kept.features, kept.state),
                 MASK, fresh)
    assert enh.reset_count.tolist() == [jax_fresh.reset_count,
                                        kept.reset_count[1].item(),
                                        jax_fresh.reset_count]
    new = PO.OSCEEnhancer(method, model, b, device="cpu")
    for x, a in frames[3:]:
        got = enh.enhance_frame(x, **a)
        assert torch.equal(got[MASK], new.enhance_frame(x, **a)[MASK])
        assert torch.equal(got[~MASK], kept.enhance_frame(x, **a)[~MASK])


def test_bbwe_reset_lanes_match_fresh_and_continued_jax():
    """Streams 0-2 of the BBWE fixture through 4 frames, reset on lanes 0
    and 2, then 2 frames: the masked lanes are fed their streams' frames 0
    and 1 again and give the fixture's (a fresh JAX BBWE's) frames 0 and
    1; lane 1 goes on with frames 4 and 5 as the continued JAX instance."""
    bfx = np.load(os.path.join(DATA, "torch_bbwe.npz"))
    x, ref, peak = bfx["bbwe_in"], bfx["bbwe_out"], bfx["bbwe_peak"]
    b = len(MASK)
    ext = PB.BBWE(CS.bbwe_model("cpu"), b, device="cpu")
    for f in range(4):
        ext.process(torch.from_numpy(x[:b, f].astype(np.int64)))
    kept = (ext.state, ext.feat_state)
    ext.reset(MASK)
    jax_fresh = JB.BBWE(None)
    fresh = set(np.unique(_np_values((jax_fresh.state,
                                      jax_fresh.feat_state))))
    assert fresh == {0.0}
    _check_reset((ext.state, ext.feat_state), kept, MASK, fresh)
    worst = 0.0
    for k in range(2):
        fr = np.where(MASK.numpy(), k, 4 + k)
        lanes = np.arange(b)
        got = ext.process(torch.from_numpy(
            x[lanes, fr].astype(np.int64))).numpy()
        env = np.maximum(peak[lanes, fr], np.where(
            fr > 0, peak[lanes, np.maximum(fr - 1, 0)], 0.0))
        bound = CS.bbwe_pcm_bound(env)
        d = np.abs(got - ref[lanes, fr].astype(np.int64))
        assert (d <= bound[:, None]).all(), (k, d.max(axis=1), bound)
        worst = max(worst, float((d.max(axis=1) / bound).max()))
    print(f"BBWE after reset(lanes): within {worst:.2f} of the bound")


def test_lpcnet_reset_lanes_match_fresh_jax_state():
    """A fresh JAX LPCNetPLC's state, converted, is what a masked lane
    holds after reset; the other lanes keep theirs (the fixture's mid-run
    resets are held against JAX in tests/test_torch_plc_lanes.py)."""
    models = CS.plc_models("cpu")
    b = len(MASK)
    lp = PPL.LPCNetPLC(*models, b, device="cpu")
    h = torch.from_numpy(CS.speech_history(b, 2, 6))
    for k in range(4):
        lp.update(h[:, k])
    lp.conceal(torch.tensor([True, True, False]))
    kept = copy.copy(lp)
    lp.reset(MASK)
    ref = convert.lpcnet_state_from_jax([JPL.LPCNetPLC(
        JPL.random_model(44), JP.random_model(45), JFG.random_model(46))])
    for a, z, r in zip(_leaves(lp._state()), _leaves(kept._state()),
                       _leaves(ref._state())):
        assert torch.equal(a[~MASK], z[~MASK])
        assert torch.equal(a[MASK], r.expand_as(a[MASK]))


def test_celt_decoder_reset_and_active_match_scalar_decoders():
    """3 lanes of the CELT fixture (streams 0-2): lane 1 inactive on frame
    2 (it keeps its state bit for bit, returns zeros, no error), lanes 0
    and 2 reset before frame 4.  Against scalar decoders: lane 1 one that
    never saw frame 2; lanes 0 and 2 fresh ones from frame 4; final ranges
    exact, PCM within 1e-4."""
    fx = np.load(os.path.join(DATA, "torch_celt20ms_64k.npz"))
    b, nf = len(MASK), 6
    pk = [[bytes(fx["frames"][i, f, :fx["lens"][i, f]]) for f in range(nf)]
          for i in range(b)]
    dec = CK.KernelCeltDecoder(b, max_payload=160, device="cpu")
    ref = [OpusDecoder(48000, 1) for _ in range(b)]
    act = torch.tensor([True, False, True])
    e = 0.0
    for f in range(nf):
        if f == 4:
            st = dec.state
            dec.reset(MASK)
            fresh = convert.state_from_jax(JCF.fused_celt_init_state(
                b, JCF.DecTabs(48000, 960)))
            for k in st:
                sub = (dec.state[k], st[k], fresh[k])
                if k != "dsp":
                    sub = ({0: s} for s in sub)
                for a, z, r in zip(*(s.values() for s in sub)):
                    assert torch.equal(a[~MASK], z[~MASK])
                    assert torch.equal(a[MASK], r.to(a.dtype)[MASK])
            for i in np.nonzero(MASK.numpy())[0]:
                ref[i] = OpusDecoder(48000, 1)
        a = act if f == 2 else None
        before = dec.state
        pcm, err = dec.decode_packed(*dec.pack([p[f] for p in pk]), a)
        assert not err.any()
        if f == 2:
            assert not pcm[1].any()
            for x, y in zip(_leaves(dec.state), _leaves(before)):
                assert torch.equal(x[1], y[1])
        for i in range(b):
            if f == 2 and i == 1:
                continue
            r = ref[i].decode(bytes([0xF8]) + pk[i][f])
            assert int(dec.state["seed"][i]) == ref[i].rangeFinal
            e = max(e, float(np.abs(pcm[i, 0].numpy() - r).max()))
    assert e <= CS.PCM_ABS_TOL
    print(f"KernelCeltDecoder reset(lanes) / active: ranges equal, PCM "
          f"within {e:.3g} of the scalar decoders")
