"""Superwideband hybrid (SILK-WB + CELT bands 17-18, end band 19) through
the port's FusedHybridDecoder(end=19) on the CPU against the scalar
OpusDecoder, on the committed fixture tests/data/torch_hybrid_swb20ms.npz
(written by tools/make_torch_hybrid_swb_fixture.py from the scalar codec).

Gates as tests/test_torch_hybrid_decoder.py states them for fullband: the
final range equals the scalar decoder's on every lane-frame that is not
flagged, the PCM is within 1e-4 of it and the SNR above 80 dB.  The
reference contract lets the fused decoders flag a lane they cannot decode
(redundancy, a third SILK pulse escape: "decode this stream on the scalar
path"); on this fixture no lane-frame is flagged (measured: PCM within
9e-8 of the scalar decoder), so the test holds every lane-frame.  Also:
the fixture drives short blocks, anti-collapse and the special hybrid
fold copy at end = 19 (turned off, the PCM leaves the bound), the bands
outside [17, 19) are reset every frame, and garbage lanes do not raise."""

import os

import numpy as np
import pytest
import torch

from opus_tpu_torch.models import celt_dec_fused as PD
from opus_tpu_torch.models import celt_dec_kernel as CK
from opus_tpu_torch.models import hybrid_dec_fused as PH

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_hybrid_swb20ms.npz")
PCM_TOL = 1e-4
END = 19
N_BAD = 6


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _decode(fx, with_bad=True):
    """All frames through one FusedHybridDecoder(end=19, device="cpu"),
    the fixture's lanes then truncated and random-byte ones; per frame
    (pcm, err, final range, K1 outputs, celt state)."""
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    rng = np.random.default_rng(4)
    nb = N_BAD if with_bad else 0
    dec = PH.FusedHybridDecoder(ns + nb, end=END, max_payload=p,
                                device="cpu")
    outs = []
    orig = CK.decode_frame

    def spy(*args):
        outs.append(orig(*args))
        return outs[-1]

    res = []
    CK.decode_frame = spy
    try:
        for f in range(nf):
            buf = np.zeros((ns + nb, p), np.uint8)
            ln = np.zeros(ns + nb, np.int64)
            buf[:ns], ln[:ns] = frames[:, f], lens[:, f]
            for j in range(nb):
                cut = int(rng.integers(0, lens[j, f] if j < nb // 2
                                       else p + 1))
                buf[ns + j, :cut] = (frames[j, f, :cut] if j < nb // 2
                                     else rng.integers(0, 256, cut))
                ln[ns + j] = cut
            pcm, err = dec.decode_packed(torch.from_numpy(buf),
                                         torch.from_numpy(ln))
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


def test_torch_hybrid_swb_matches_scalar(fx, decoded):
    ns = fx["frames"].shape[0]
    ref = fx["pcm"]
    got = np.stack([r["pcm"][:ns] for r in decoded], axis=1)
    for f, r in enumerate(decoded):
        flagged = np.nonzero(r["err"][:ns])[0]
        assert not flagged.size, f"frame {f}: fixture lanes {flagged} flagged"
        assert r["rng"][:ns].tolist() == fx["final_range"][:, f].tolist(), f
        assert np.isfinite(r["pcm"]).all()
    err = np.abs(got - ref)
    assert err.max() < PCM_TOL, err.max()
    snr = 10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                        / max(np.sum((got - ref).astype(np.float64) ** 2),
                              1e-30))
    assert snr > 80, snr
    k1 = [r["k1"] for r in decoded]
    assert sum(int(o["is_transient"][:ns].sum()) for o in k1) > 0
    assert sum(int(o["anti_collapse_on"][:ns].sum()) for o in k1) > 0


def test_torch_hybrid_swb_fold_copy_is_exercised(fx, monkeypatch):
    """With special_hybrid_folding made a no-op the output leaves the
    bound on some lane-frame: the copy is on the SWB path too."""
    monkeypatch.setattr(PD, "_hybrid_fold", lambda norm, tabs: norm)
    ns = fx["frames"].shape[0]
    res = _decode(fx, with_bad=False)
    err = max(float(np.abs(r["pcm"][:ns] - fx["pcm"][:, f]).max())
              for f, r in enumerate(res))
    assert err > PCM_TOL, err


def test_torch_hybrid_swb_resets_bands_outside_range(decoded):
    """celt_decoder.c:1604-1612: after every frame the bands below start
    and from end up hold energy 0 and log energies -28."""
    for f, r in enumerate(decoded):
        st = r["celt"]
        for sl in (slice(0, PH.HYBRID_START), slice(END, None)):
            assert (st["old_e"][:, sl] == 0).all(), f
            assert (st["prev1"][:, sl] == -28).all(), f
            assert (st["prev2"][:, sl] == -28).all(), f
        assert (st["old_e"][:, PH.HYBRID_START:END] != 0).any(), f
