"""The port's plain symbol pass (the plain version of kernel K1,
opus_tpu_torch/models/celt_dec_fused.py via celt_dec_kernel.decode_frame
on CPU tensors) at 10 and 20 ms, on real CELT packets decoded from the
scalar decoder's captured pre-frame state:

- against the JAX package's fused_celt_decode_frame, run eagerly under
  tests/np_shim as the JAX package's own tests run it on the CPU (the
  Pallas kernel takes over an hour in interpret mode): integer outputs
  exact, X and energies within 1e-5 (f32 ops in another order: a band is
  unit-norm, so a few ULPs of 1 are ~1e-7);
- against the scalar decoder's taps: final range and collapse masks
  exact, X within 2e-3 and energies within 1e-4, the bounds of
  tests/test_celt_dec_fused_np.py (the scalar tier computes in float64).

The JAX fused pass feeds anti-collapse the energies from before the
finalise bits; the port, like libopus, the scalar decoder and the Pallas
kernel, uses the finalised ones.  The frames below exercise anti-collapse
where both agree.
"""

import numpy as np
import pytest
import torch

from tests import np_shim
from tests.test_celt_dec_fused import _encode_frames, _scalar_decode
from opus_tpu_torch.models import celt_dec_kernel as CK
from opus_tpu_torch.convert import tabs_from_jax


def _inputs(frames, taps, nb):
    bsz = len(frames)
    smax = max(len(f) for f in frames)
    bufb = np.zeros((bsz, smax), np.uint8)
    lens = np.zeros(bsz, np.int32)
    for i, f in enumerate(frames):
        a = np.frombuffer(f, np.uint8)
        bufb[i, :len(a)] = a
        lens[i] = len(a)
    band = lambda key: np.array([t[key][:nb] for t in taps], np.float32)
    seed = np.array([t["seed"] for t in taps], np.uint32)
    return bufb, lens, band("pre_e"), band("prev1"), band("prev2"), seed


@pytest.fixture(scope="module", params=[(480, 96000), (960, 64000)],
                ids=["10ms", "20ms"])
def decoded(request):
    frame_size, bitrate = request.param
    frames = _encode_frames(frame_size, nframes=6, bitrate=bitrate)
    taps = _scalar_decode(frames, frame_size)
    saved = np_shim.install()
    try:
        from opus_tpu.models.celt_dec_fused import (DecTabs,
                                                    fused_celt_decode_frame)
        from opus_tpu.ops import rc_kernel as K
        jtabs = DecTabs(48000, frame_size)
        nb = jtabs.nb
        bufb, lens, old_e, prev1, prev2, seed = _inputs(frames, taps, nb)
        jout, jst = fused_celt_decode_frame(
            K.pack_words(bufb.astype(np.uint32), bufb.shape[1]), lens,
            list(old_e.T), list(prev1.T), list(prev2.T), seed, None, jtabs,
            np.ones(len(frames), bool))
    finally:
        np_shim.uninstall(saved)
    tabs = tabs_from_jax(jtabs)
    out = CK.decode_frame(
        torch.from_numpy(bufb), torch.from_numpy(lens),
        torch.from_numpy(old_e), torch.from_numpy(np.minimum(prev1, prev2)),
        torch.from_numpy(seed.astype(np.int64)), tabs)
    return dict(frames=frames, taps=taps, jout=jout, jst=jst, out=out,
                tabs=tabs)


def test_torch_symbols_match_jax_fused(decoded):
    jout, jst, out = decoded["jout"], decoded["jst"], decoded["out"]
    for key in ("silence", "is_transient", "intra", "anti_collapse_on",
                "pf_pitch", "pf_tapset"):
        assert out[key].tolist() == np.asarray(jout[key]).astype(
            np.int64).tolist(), key
    assert out["rng"].tolist() == np.asarray(jst["d"]["rng"]).astype(
        np.int64).tolist()
    assert out["error"].tolist() == np.asarray(jst["d"]["error"]).tolist()
    jtell = np.asarray(jst["d"]["nbits_total"]) \
        - np.floor(np.log2(np.asarray(jst["d"]["rng"]).astype(np.float64))
                   + 1).astype(np.int64)
    assert out["tell"].tolist() == jtell.tolist()
    assert np.array_equal(out["pf_gain"].numpy(), np.asarray(jout["pf_gain"]))
    x_err = np.abs(out["X"].numpy() - np.asarray(jout["X"])).max()
    assert x_err <= 1e-5, x_err
    e_j = np.stack([np.asarray(e) for e in jout["energies"]], axis=1)
    assert np.abs(out["energies"].numpy() - e_j).max() <= 1e-5


def test_torch_symbols_match_scalar_taps(decoded):
    taps, out, tabs = decoded["taps"], decoded["out"], decoded["tabs"]
    from opus_tpu_torch.models import celt_dec_fused as F
    X = out["X"].numpy()
    for i, t in enumerate(taps):
        assert int(out["error"][i]) == 0
        assert int(out["rng"][i]) == t["final_range"], f"frame {i}"
        ref_x = t["X"][:X.shape[1]]
        assert np.abs(X[i] - ref_x).max() <= 2e-3, f"frame {i}"
        assert np.all(t["X"][X.shape[1]:] == 0.0)
        assert np.abs(out["energies"][i].numpy()
                      - t["energies"][:tabs.nb]).max() <= 1e-4
    # collapse masks: the band tree's output before anti-collapse
    bufb, lens, old_e, prev1, prev2, seed = _inputs(decoded["frames"], taps,
                                                    tabs.nb)
    f_out, _d = F.fused_celt_decode_frame(
        torch.from_numpy(bufb), torch.from_numpy(lens.astype(np.int64)),
        list(torch.from_numpy(old_e).T),
        list(torch.from_numpy(np.minimum(prev1, prev2)).T),
        torch.from_numpy(seed.astype(np.int64)), tabs,
        torch.ones(len(taps), dtype=torch.bool))
    coll = torch.stack(f_out["collapse"], dim=1).numpy()
    for i, t in enumerate(taps):
        assert list(coll[i]) == list(t["collapse"]), f"frame {i}"
