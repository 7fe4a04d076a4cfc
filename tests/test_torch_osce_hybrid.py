"""The port's SILK decoder at 48 kHz and its hybrid decoder with OSCE and
BBWE (``FusedSilkDecoder(fs_out=48000)``, ``set_osce``, ``set_osce_bwe``;
``FusedHybridDecoder.set_osce`` / ``set_osce_bwe``) against the scalar
decoders on the CPU: tests/data/torch_bbwe.npz, written by
tools/make_torch_bbwe_fixture.py from ``SilkDecoder(api_sample_rate=
48000)`` and ``OpusDecoder(48000, 1)`` on the SILK and hybrid fixtures'
packets, BBWE seed 70, LACE 50, NoLACE 60.

Bounds (``chip_smoke.py`` derives them):

- the un-enhanced 48 kHz int16 and every final range: exact;
- BBWE: ``bbwe_pcm_bound`` of the frame's peak (its inputs equal);
- NoLACE + BBWE: NoLACE's output within ``osce_pcm_bound`` of the scalar
  decoder's; the first half of the streams hand the scalar decoder's
  enhanced frames on to BBWE (``feed_enhanced``), which is held there
  within ``bbwe_pcm_bound`` of its inputs equal, the rest with the
  inputs' L1 difference so far (``cum_dev``), BBWE_GAIN LSB per LSB;
- hybrid with LACE / NoLACE: the final range and the SILK half's
  enhanced 16 kHz (within ``osce_pcm_bound``) on every frame (FB all 8,
  carrying the enhancer's and BBWE's state; SWB, whose SILK half is
  wired the same, the first 3 to stay cheap), the PCM
  of the fixture's first 3 within ``hybrid_pcm_bound`` of the SILK
  half's int16 bound, ``up48_bound`` without BBWE and ``bbwe_pcm_bound``
  with it, half the streams fed as above.  The CELT half is the plain
  hybrid decoder's (tests/test_torch_hybrid_decoder.py).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu_torch.dnn import osce as PO
from opus_tpu_torch.models import fused_silk_dec as PF
from opus_tpu_torch.models import hybrid_dec_fused as PH
from opus_tpu_torch.silk.resampler import upsample_to_48k, upsampler_init

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def fx():
    return {name: dict(np.load(os.path.join(DATA, f"torch_{name}.npz")))
            for name in ("bbwe", "silk16k_24k", "osce_wb20ms",
                         "hybrid_fb20ms", "hybrid_swb20ms")}


@pytest.fixture(scope="module")
def models():
    return dict(bbwe=CS.bbwe_model("cpu"), **{
        {1: "lace", 2: "nolace"}[m]: v
        for m, v in CS.osce_models("cpu").items()})


def _silk48(sfx, pre, bwe=None, nolace=None, frames=None, feed=None):
    """Decode the SILK fixture's set ``pre`` at 48 kHz, NoLACE's output fed
    as ``feed_enhanced(enhancer, *feed)``: (pcm [L, F, N], final ranges
    [L, F], BBWE peaks [L, F], NoLACE's own output and what BBWE got, or
    None)."""
    fr, ln = sfx[pre + "frames"], sfx[pre + "lens"]
    nb = 4 if pre == "" else 2
    dec = PF.FusedSilkDecoder(fr.shape[0], nb_subfr=nb, device="cpu",
                              max_payload=fr.shape[2], fs_out=48000)
    if bwe is not None:
        dec.set_osce_bwe(bwe)
    enh = None
    if nolace is not None:
        dec.set_osce(PO.OSCE_METHOD_NOLACE, nolace)
        enh = CS.feed_enhanced(dec.osce, *(feed or ()))
    pcm, rng, peak = [], [], []
    for f in range(fr.shape[1] if frames is None else frames):
        xq, err = dec.decode_packed(_t(fr[:, f]), _t(ln[:, f]))
        assert not err.any()
        pcm.append(xq.numpy())
        rng.append(dec.final_range.numpy())
        peak.append(dec.bwe.peak.numpy() if bwe is not None
                    else np.zeros(fr.shape[0]))
        assert dec.osce_in is None or nolace is not None
    if enh is not None:
        enh = tuple(np.stack([e.numpy() for e in x], 1) for x in enh)
    return (np.stack(pcm, 1), np.stack(rng, 1), np.stack(peak, 1), enh)


@pytest.mark.parametrize("pre", ["", "wb10_"])
def test_silk_48k_plain_is_bit_exact(fx, pre):
    sfx, bfx = fx["silk16k_24k"], fx["bbwe"]
    pcm, rng, _peak, _ = _silk48(sfx, pre)
    ref = bfx["silk48_xq" if pre == "" else "wb10_48_xq"]
    assert pcm.dtype == np.int16 and pcm.shape == ref.shape
    assert np.array_equal(pcm, ref)
    assert np.array_equal(rng, sfx[pre + "final_range"])


@pytest.mark.parametrize("pre", ["", "wb10_"])
def test_silk_48k_bbwe_matches_scalar(fx, models, pre):
    sfx, bfx = fx["silk16k_24k"], fx["bbwe"]
    pcm, rng, peak, _ = _silk48(sfx, pre, bwe=models["bbwe"],
                                frames=4 if pre == "" else None)
    key = "silk48_bwe" if pre == "" else "wb10_48_bwe"
    nf = pcm.shape[1]
    env = CS.peak_env(bfx[key + "_peak"])[:, :nf]
    lsb, share, _ = CS.within(pcm, bfx[key + "_xq"][:, :nf],
                           CS.bbwe_pcm_bound(env),
                           "BBWE at 48 kHz vs the scalar decoder")
    assert np.array_equal(rng, sfx[pre + "final_range"][:, :nf])
    rel = np.abs(peak - bfx[key + "_peak"][:, :nf]) \
        / np.maximum(bfx[key + "_peak"][:, :nf], 1e-3)
    assert rel.max() <= 1e-4, rel.max()
    print(f"{key}: within {lsb:.0f} LSB ({share:.2f} of the bound)")


def test_silk_48k_nolace_bbwe_matches_scalar(fx, models):
    sfx, bfx, ofx = fx["silk16k_24k"], fx["bbwe"], fx["osce_wb20ms"]
    nf = 4
    ref16 = ofx["xq"][1][:, :nf]
    fed = slice(0, ref16.shape[0] // 2)
    pcm, rng, _peak, (own, passed) = _silk48(
        sfx, "", bwe=models["bbwe"], nolace=models["nolace"], frames=nf,
        feed=(_t(ref16[fed].transpose(1, 0, 2)), fed))
    CS.osce_compare(own, ref16, CS.osce_env(ofx, 2)[:, :nf],
                    "NoLACE at 48 kHz")
    assert np.array_equal(passed[fed], ref16[fed])
    dev = CS.cum_dev(passed, ref16)
    env = CS.peak_env(bfx["silk48_nolace_bwe_peak"])[:, :nf]
    bnd = CS.bbwe_pcm_bound(env, dev)
    ref = bfx["silk48_nolace_bwe_xq"][:, :nf]
    e_fed = CS.within(pcm[fed], ref[fed], bnd[fed],
                      "NoLACE + BBWE vs the scalar decoder, fed streams")
    e_rest = CS.within(pcm[fed.stop:], ref[fed.stop:], bnd[fed.stop:],
                       "NoLACE + BBWE vs the scalar decoder")
    assert np.array_equal(rng, sfx["final_range"][:, :nf])
    print(f"NoLACE + BBWE: within {e_fed[0]:.0f} LSB ({e_fed[1]:.2f} of "
          f"the bound, largest {e_fed[2]:.1f}) with the scalar decoder's "
          f"NoLACE output, {e_rest[0]:.0f} ({e_rest[1]:.2f}, "
          f"{e_rest[2]:.1f}) with the port's; "
          f"{int((dev[fed.stop:] == 0).sum())} of {dev[fed.stop:].size} "
          f"of those lane-frames with BBWE's inputs equal so far")


@pytest.mark.parametrize("bw", ["fb", "swb"])
@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("with_bwe", [False, True])
def test_hybrid_osce_matches_scalar(fx, models, bw, method, with_bwe):
    hfx, bfx = fx[f"hybrid_{bw}20ms"], fx["bbwe"]
    frames, lens = hfx["frames"], hfx["lens"]
    ns = frames.shape[0]
    dec = PH.FusedHybridDecoder(ns, end=21 if bw == "fb" else 19,
                                max_payload=frames.shape[2], device="cpu")
    mname = "lace" if method == 1 else "nolace"
    dec.set_osce(method, models[mname])
    if with_bwe:
        dec.set_osce_bwe(models["bbwe"])
    ref16 = bfx[f"hyb_{bw}_{mname}_xq16"]
    fed = slice(0, ns // 2)
    own, passed = CS.feed_enhanced(
        dec.osce, _t(ref16[fed].transpose(1, 0, 2)), fed)
    name = f"hyb_{bw}_{mname}" + ("_bwe" if with_bwe else "")
    hf = CS.HYB_FRAMES
    nf = frames.shape[1] if bw == "fb" else hf
    pcm = []
    for f in range(nf):
        out, err = dec.decode_packed(_t(frames[:, f]), _t(lens[:, f]))
        assert not err.any()
        assert np.array_equal(dec.final_range.numpy(),
                              bfx[name + "_rng"][:, f])
        pcm.append(out.numpy())
    pcm = np.stack(pcm, 1)[:, :hf]
    own, passed = (np.stack([e.numpy() for e in x], 1)
                   for x in (own, passed))
    ref16 = ref16[:, :nf]
    assert own.shape == ref16.shape
    env_o = CS.peak_env(bfx[name + "_osce_peak"])[:, :nf]
    env_o[:, 0] = 0.0                     # the first frame passes through
    CS.within(own, ref16, CS.osce_pcm_bound(env_o), f"{name} SILK half")
    assert np.array_equal(passed[fed], ref16[fed])
    dev = CS.cum_dev(passed[:, :hf], ref16[:, :hf])
    if with_bwe:
        silk = CS.bbwe_pcm_bound(
            CS.peak_env(bfx[name + "_bwe_peak"])[:, :hf], dev)
    else:
        silk = CS.up48_bound(dev)
    ref = CS.hybrid_fixture_pcm(bfx, hfx, name)
    bnd = CS.hybrid_pcm_bound(silk)
    e_fed = CS.within(pcm[fed], ref[fed], bnd[fed], f"{name}, fed streams")
    e_rest = CS.within(pcm[fed.stop:], ref[fed.stop:], bnd[fed.stop:],
                       name)
    print(f"{name}: PCM within {e_fed[0]:.3g} ({e_fed[1]:.2f} of the "
          f"bound, largest {e_fed[2]:.3g}) with the scalar decoder's SILK "
          f"half, {e_rest[0]:.3g} ({e_rest[1]:.2f}, {e_rest[2]:.3g}) with "
          f"the port's; {int((dev[fed.stop:] == 0).sum())} of "
          f"{dev[fed.stop:].size} of those lane-frames with the SILK half's "
          f"inputs equal so far")


def test_upsampler_moves_at_most_ups_gain_per_input_lsb():
    """``up48_bound``'s gain: one 16 kHz input sample moved by 1 LSB moves
    the 48 kHz output by at most UPS_GAIN LSB (plus rounding), over 3
    frames of state."""
    rng = np.random.default_rng(11)
    b = 16
    x = rng.integers(-20000, 20000, (b, 3, 320))
    y = x.copy()
    lane = np.arange(b)
    y[lane, 0, rng.integers(0, 320, b)] += 1
    sa, sb = upsampler_init(b), upsampler_init(b)
    worst = 0
    for f in range(3):
        oa, sa = upsample_to_48k(_t(x[:, f]), sa)
        ob, sb = upsample_to_48k(_t(y[:, f]), sb)
        worst = max(worst, int((oa - ob).abs().max()))
    assert 0 < worst <= 1 + CS.UPS_GAIN, worst
    print(f"upsampler: one input LSB moves the output by up to {worst} LSB")


def test_fs_out_and_osce_inputs_options(models):
    with pytest.raises(ValueError):
        PF.FusedSilkDecoder(2, fs_khz=8, device="cpu", fs_out=48000)
    with pytest.raises(ValueError):
        PF.FusedSilkDecoder(2, fs_khz=16, device="cpu", fs_out=24000)
    dec = PF.FusedSilkDecoder(2, fs_khz=16, device="cpu")
    with pytest.raises(ValueError):
        dec.set_osce_bwe(models["bbwe"])
    buf = torch.zeros((2, 8), dtype=torch.uint8)
    ln = torch.full((2,), 8)
    dec.decode_packed(buf, ln)
    assert dec.osce_in is None
    dec.decode_packed(buf, ln, osce_inputs=True)
    assert set(dec.osce_in) >= {"num_bits", "pitch_lags", "gains_q16"}
