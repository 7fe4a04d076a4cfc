"""The port's hybrid decoder (opus_tpu_torch/models/hybrid_dec_fused.py,
FusedHybridDecoder on the CPU: SILK-WB, then the CELT half from the same
range decoder at start band 17, the 16 -> 48 kHz upsampler and the sum)
against the scalar OpusDecoder on the committed fixture
(tests/data/torch_hybrid_fb20ms.npz, written by
tools/make_torch_hybrid_fixture.py from the scalar codec).

Bounds as tests/test_hybrid_dec_fused.py states them: the final range
equals the scalar decoder's on every lane-frame; the PCM is within 1e-4 of
it (SILK and the resampler are integer-exact, the CELT half is float32
against float64) and the SNR above 80 dB; no fixture lane is flagged, and
garbage or truncated lanes do not raise.  Also: the special hybrid fold
copy changes the output (turned off, the PCM leaves the bound), the CELT
state carry resets the bands below start every frame, and the hybrid
state converts to and from the JAX layout."""

import os

import numpy as np
import pytest
import torch

from opus_tpu_torch import convert
from opus_tpu_torch.models import celt_dec_fused as PD
from opus_tpu_torch.models import celt_dec_kernel as CK
from opus_tpu_torch.models import hybrid_dec_fused as PH

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_hybrid_fb20ms.npz")
PCM_TOL = 1e-4
N_BAD = 6


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _lanes(fx, f, rng):
    """The fixture's 8 streams of frame f, then truncated and random-byte
    lanes."""
    frames, lens = fx["frames"], fx["lens"]
    ns, _nf, p = frames.shape
    buf = np.zeros((ns + N_BAD, p), np.uint8)
    ln = np.zeros(ns + N_BAD, np.int64)
    buf[:ns], ln[:ns] = frames[:, f], lens[:, f]
    for j in range(N_BAD):
        cut = int(rng.integers(0, lens[j, f] if j < N_BAD // 2 else p + 1))
        buf[ns + j, :cut] = (frames[j, f, :cut] if j < N_BAD // 2
                             else rng.integers(0, 256, cut))
        ln[ns + j] = cut
    return torch.from_numpy(buf), torch.from_numpy(ln)


def _decode(fx, with_bad=True):
    """All frames through one FusedHybridDecoder(device="cpu"); returns
    per-frame (pcm, err, final range, K1 outputs, celt state)."""
    ns, nf, p = fx["frames"].shape
    rng = np.random.default_rng(3)
    dec = PH.FusedHybridDecoder(ns + (N_BAD if with_bad else 0),
                                max_payload=p, device="cpu")
    outs = []
    orig = CK.decode_frame

    def spy(*args):
        out = orig(*args)
        outs.append(out)
        return out

    res = []
    CK.decode_frame = spy
    try:
        for f in range(nf):
            buf, ln = _lanes(fx, f, rng)
            if not with_bad:
                buf, ln = buf[:ns], ln[:ns]
            pcm, err = dec.decode_packed(buf, ln)
            res.append(dict(pcm=pcm.numpy(), err=err.numpy(),
                            rng=dec.final_range.numpy(), k1=outs[-1],
                            celt={k: v.clone() for k, v in
                                  dec.state["celt"].items() if k != "dsp"}))
    finally:
        CK.decode_frame = orig
    return res


@pytest.fixture(scope="module")
def decoded(fx):
    return _decode(fx)


def test_torch_hybrid_decoder_matches_scalar(fx, decoded):
    ns = fx["frames"].shape[0]
    ref, got = fx["pcm"], np.stack([r["pcm"][:ns] for r in decoded], axis=1)
    for f, r in enumerate(decoded):
        assert not r["err"][:ns].any(), f"frame {f}: fixture lane flagged"
        assert r["rng"][:ns].tolist() == fx["final_range"][:, f].tolist(), f
        assert np.isfinite(r["pcm"]).all()
    err = np.abs(got - ref)
    assert err.max() < PCM_TOL, err.max()
    snr = 10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                        / max(np.sum((got - ref).astype(np.float64) ** 2),
                              1e-30))
    assert snr > 80, snr
    # the fixture drives the CELT half's short blocks and anti-collapse
    k1 = [r["k1"] for r in decoded]
    assert sum(int(o["is_transient"][:ns].sum()) for o in k1) > 0
    assert sum(int(o["anti_collapse_on"][:ns].sum()) for o in k1) > 0


def test_torch_hybrid_fold_copy_is_exercised(fx, monkeypatch):
    """With special_hybrid_folding made a no-op the output moves outside
    the bound on some lane-frame: the copy is on the tested path."""
    monkeypatch.setattr(PD, "_hybrid_fold", lambda norm, tabs: norm)
    ns = fx["frames"].shape[0]
    res = _decode(fx, with_bad=False)
    err = max(float(np.abs(r["pcm"][:ns] - fx["pcm"][:, f]).max())
              for f, r in enumerate(res))
    assert err > PCM_TOL, err


def test_torch_hybrid_state_resets_bands_outside_range(decoded):
    """celt_decoder.c:1604-1612: after every frame the bands below start
    hold energy 0 and log energies -28, in the energy memory too."""
    for f, r in enumerate(decoded):
        st = r["celt"]
        assert (st["old_e"][:, :PH.HYBRID_START] == 0).all(), f
        assert (st["prev1"][:, :PH.HYBRID_START] == -28).all(), f
        assert (st["prev2"][:, :PH.HYBRID_START] == -28).all(), f
        assert (st["old_e"][:, PH.HYBRID_START:] != 0).any(), f


def test_torch_hybrid_state_convert(fx):
    """The JAX hybrid_init_state <-> the port's dict, both ways, and a
    decoded state survives the round trip."""
    from opus_tpu.models import celt_dec_fused as JD
    from opus_tpu.models import hybrid_dec_fused as JH

    jst = JH.hybrid_init_state(3, JD.DecTabs(48000, 960, start=17))
    port = convert.hybrid_state_from_jax(jst)
    ref = PH.hybrid_init_state(3, CK.dec_tabs(48000, 960, 17, 21))
    for part in ("rs",):
        for k in ref[part]:
            assert torch.equal(port[part][k], ref[part][k]), (part, k)
    assert torch.equal(port["smid"], ref["smid"])
    assert torch.equal(port["celt"]["prev1"], ref["celt"]["prev1"])
    assert torch.equal(port["silk"]["prev_gain_q16"],
                       ref["silk"]["prev_gain_q16"])
    ns, _nf, p = fx["frames"].shape
    dec = PH.FusedHybridDecoder(2, max_payload=p, device="cpu")
    dec.decode_packed(torch.from_numpy(fx["frames"][:2, 0].copy()),
                      torch.from_numpy(fx["lens"][:2, 0].astype(np.int64)))
    back = convert.hybrid_state_to_numpy(dec.state)
    again = convert.hybrid_state_from_jax(back)
    for k in ("s_iir", "s_fir", "delay"):
        assert torch.equal(again["rs"][k], dec.state["rs"][k]), k
    assert torch.equal(again["smid"], dec.state["smid"])
    assert torch.equal(again["celt"]["old_e"], dec.state["celt"]["old_e"])
    assert torch.equal(again["silk"]["synth"]["slpc"],
                       dec.state["silk"]["synth"]["slpc"])


def test_torch_hybrid_decoder_defaults_to_the_card():
    """FusedHybridDecoder's device defaults to CUDA and, with no card,
    raises instead of running on the CPU."""
    import inspect
    sig = inspect.signature(PH.FusedHybridDecoder)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PH.FusedHybridDecoder(4)
