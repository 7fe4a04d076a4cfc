"""The port's classic CELT packet-loss concealment (opus_tpu_torch/celt/
plc.py through ``KernelCeltDecoder.conceal``) against the JAX package's
scalar decoder (opus_tpu/celt/decoder.py ``_decode_lost``, driven by
``OpusDecoder.decode(None, ...)``) on the CPU.

tests/data/torch_celt_plc.npz (tools/make_torch_celt_plc_fixture.py)
holds the scalar decoder's state before and after six concealments of
opus_demo's plain loop (a first and a repeated periodic frame, noise after
periodic frames, that is the fold, noise after noise, noise after one good
frame, which ``skip_plc`` forces) and 10 ms (LM 2) schedules on 8 streams
of tests/data/torch_celt10ms_64k.npz: periodic runs, noise after ten
periodic frames, resumes after each, lanes lost before their first packet
and intra frames after a loss.  Bounds (chip_smoke.py): branches, pitch
periods, zeroing decisions and final ranges equal; decoded PCM after a
loss within PCM_ABS_TOL; concealed int16 within CLASSIC_LSB.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu_torch import convert
from opus_tpu_torch.models import celt_dec_kernel as CK
from opus_tpu_torch.tools.sim_loss import to_int16

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def cfx():
    return dict(np.load(os.path.join(DATA, "torch_celt_plc.npz")))


def _snap(cfx, when):
    keys = [k[len(f"snap_{when}_"):] for k in cfx
            if k.startswith(f"snap_{when}_")]
    n = len(cfx["snaps"])
    return [{k: cfx[f"snap_{when}_{k}"][j] for k in keys} for j in range(n)]


def _conc_of(cfx, lane, frame):
    """The plain loop's int16 of a classic concealment slot."""
    conc = (cfx["plain_kind"] == 1) | (cfx["plain_kind"] == 2)
    order = np.argwhere(conc).tolist()
    return cfx["plain_conc"][order.index([lane, frame])]


def test_conceal_from_scalar_states(cfx):
    """Port lanes started from the scalar decoder's states
    (``celt_state_from_scalar``) conceal one 20 ms frame as the scalar
    decoder did: branch, period, LCG state and counters equal, int16
    within CLASSIC_LSB, energies, LPC and de-emphasis memory within float
    rounding."""
    before, after = _snap(cfx, "before"), _snap(cfx, "after")
    dec = CK.KernelCeltDecoder(len(before), device="cpu")
    dec.state = convert.celt_state_from_scalar(before, "cpu")
    pcm = to_int16(dec.conceal()[:, 0]).numpy()
    got = convert.celt_state_to_numpy(dec.state)
    worst = 0
    for j, (lane, frame) in enumerate(cfx["snaps"]):
        ref = after[j]
        assert int(dec.plc_trace["branch"][j]) \
            == int(cfx["plain_branch"][lane, frame]) \
            == int(ref["last_frame_type"])
        for k in ("loss_duration", "plc_duration", "skip_plc",
                  "last_frame_type", "prefilter_and_fold",
                  "last_pitch_index", "postfilter_period",
                  "postfilter_period_old", "postfilter_tapset",
                  "postfilter_tapset_old", "rng"):
            assert got[j][k] == int(ref[k]), (j, k)
        for k in ("postfilter_gain", "postfilter_gain_old"):
            assert got[j][k] == np.float32(ref[k]), (j, k)
        for k, tol in (("oldEBands", 1e-5), ("oldLogE", 1e-5),
                       ("oldLogE2", 1e-5), ("backgroundLogE", 1e-5),
                       ("plc_lpc", 1e-5), ("preemph_memD", 1e-2)):
            scale = max(1.0, float(np.abs(ref[k]).max()))
            assert np.abs(got[j][k] - ref[k]).max() <= tol * scale, (j, k)
        d = np.abs(pcm[j].astype(np.int64) - _conc_of(cfx, lane, frame))
        assert d.max() <= CS.CLASSIC_LSB, (j, d.max())
        worst = max(worst, int(d.max()))
    print(f"from scalar states: concealed int16 within {worst} LSB")


def test_scalar_state_round_trip(cfx):
    """celt_state_to_numpy(celt_state_from_scalar(s)) gives back s (the
    history and the de-emphasis memory as the port's float32)."""
    before = _snap(cfx, "before")
    back = convert.celt_state_to_numpy(
        convert.celt_state_from_scalar(before, "cpu"))
    for s, b in zip(before, back):
        for k in convert.SCALAR_KEYS:
            if k == "decode_mem":
                n = 2048 + (60 if not s["prefilter_and_fold"] else 120)
                assert np.array_equal(b[k][0, :n], s[k][0, :n])
            elif k == "preemph_memD":
                assert abs(b[k][0] - s[k][0]) <= 1e-6 * max(1, abs(s[k][0]))
            elif k in ("postfilter_gain", "postfilter_gain_old"):
                assert b[k] == float(s[k])
            else:
                assert np.allclose(b[k], s[k], rtol=0, atol=1e-5), k


def _schedule10(cfx):
    fx = np.load(os.path.join(DATA, "torch_celt10ms_64k.npz"))
    sched = [str(s) for s in cfx["m10_sched"]]
    b = len(sched)
    dec = CK.KernelCeltDecoder(b, frame_size=480, max_payload=80,
                               device="cpu")
    t = len(sched[0])
    rec = dict(kind=np.zeros((b, t), np.int8),
               rng=np.zeros((b, t), np.uint32),
               branch=np.zeros((b, t), np.int8),
               pitch=np.zeros((b, t), np.int64),
               zeroed=np.zeros((b, t), bool),
               pcm=np.zeros((b, t, 480), np.float32),
               intra=np.zeros((b, t), bool))
    nxt = np.zeros(b, int)
    for e in range(t):
        ev = np.array([s[e] for s in sched])
        lost = ev == "L"
        frames = []
        for i in range(b):
            s_, f = ((i + 1) % b, 0) if ev[i] == "q" else (i, nxt[i])
            frames.append(b"" if lost[i] else
                          bytes(fx["frames"][s_, f, :fx["lens"][s_, f]]))
            nxt[i] += ev[i] == "p"
        buf, lens = dec.pack(frames)
        if (ev == "q").any():
            sym = CK.decode_frame_plain(buf, lens, dec.state["old_e"],
                                        dec.state["prev1"],
                                        dec.state["seed"], dec.tabs)
            rec["intra"][:, e] = sym["intra"].numpy() != 0
        pcm, err = dec.decode_packed(buf, lens, torch.from_numpy(~lost))
        assert not err.any()
        c = dec.conceal(torch.from_numpy(lost))
        pcm = torch.where(torch.from_numpy(lost)[:, None, None], c, pcm)
        rec["pcm"][:, e] = pcm[:, 0].numpy()
        tr = dec.plc_trace
        br = tr["branch"].numpy()
        rec["kind"][:, e] = np.where(lost, np.where(br > 0, 1, 3), 0)
        rec["branch"][:, e] = br
        rec["pitch"][:, e] = tr["pitch"].numpy()
        rec["zeroed"][:, e] = tr["zeroed"].numpy()
        rec["rng"][:, e] = np.where(lost, 0, dec.final_range().numpy())
    return sched, rec


def test_conceal_10ms_schedules_match_scalar(cfx):
    """10 ms (LM 2): periodic runs, noise after ten periodic frames, the
    resumes after each, lanes lost before their first packet (zeros) and
    intra frames after a loss, on 8 lanes in lockstep."""
    sched, got = _schedule10(cfx)
    for k in ("kind", "branch", "pitch", "zeroed"):
        assert np.array_equal(got[k], cfx[f"m10_{k}"]), k
    dec_ = got["kind"] == 0
    assert np.array_equal(got["rng"][dec_], cfx["m10_range"][dec_])
    conc = got["kind"] == 1
    d = np.abs(to_int16(torch.from_numpy(got["pcm"][conc])).numpy()
               .astype(np.int64) - cfx["m10_conc"])
    assert d.max() <= CS.CLASSIC_LSB
    assert not got["pcm"][got["kind"] == 3].any()
    after = CS.classic_after_mask(got["kind"])
    e = np.abs(got["pcm"][after] - cfx["m10_after_pcm"]).max()
    assert e <= CS.PCM_ABS_TOL
    # the intra frames after a loss (the decay before K1 is weighed by 0)
    q = np.array([[c == "q" for c in s] for s in sched])
    assert got["intra"][q].all() and q.sum() >= 3
    br = got["branch"]
    assert (br == 1).sum() > 0 and (br == 2).sum() > 0
    print(f"10 ms: {int((br == 1).sum())} periodic, {int((br == 2).sum())} "
          f"noise; concealed within {int(d.max())} LSB, decoded after a "
          f"loss within {e:.3g}")


def test_masked_conceal_keeps_other_lanes_bit_for_bit():
    """conceal(lanes): the other lanes keep every tensor of their state bit
    for bit and return zeros; the concealing lanes equal an unmasked call's;
    a lane that has decoded nothing returns zeros and keeps its state."""
    fx = np.load(os.path.join(DATA, "torch_celt20ms_64k.npz"))
    b = 4
    dec = CK.KernelCeltDecoder(b, device="cpu")
    for f in range(2):
        act = torch.tensor([True, True, True, f == 1])
        dec.decode_packed(*dec.pack([bytes(fx["frames"][i, f, :fx["lens"][
            i, f]]) if act[i] else b"" for i in range(b)]), act)
    dec.reset(torch.tensor([False, False, False, True]))
    st = dec.state
    full = CK.KernelCeltDecoder(b, device="cpu")
    full.state = st
    ref = full.conceal()
    mask = torch.tensor([True, False, True, True])
    pcm = dec.conceal(mask)
    leaves = convert.celt_state_to_numpy(dec.state)
    old = convert.celt_state_to_numpy(st)
    for k in old[1]:
        assert np.array_equal(np.asarray(leaves[1][k]), np.asarray(old[1][k]))
        assert np.array_equal(np.asarray(leaves[3][k]), np.asarray(old[3][k]))
    for k, v in dec.state.items():
        for a, z in ((v, st[k]),) if k != "dsp" else zip(
                v.values(), st[k].values()):
            assert torch.equal(a[1], z[1]) and torch.equal(a[3], z[3]), k
    assert not pcm[1].any() and not pcm[3].any()
    assert torch.equal(pcm[0], ref[0]) and torch.equal(pcm[2], ref[2])
    assert dec.plc_trace["branch"].tolist() == [1, 0, 1, 0]


def test_lossless_decode_keeps_loss_state_clear():
    """Without a loss the new state stays at rest: counters 0, the second
    energy copy equal to old_e, the fold flag off; final ranges and PCM as
    the scalar decoder's fixture."""
    fx = np.load(os.path.join(DATA, "torch_celt20ms_64k.npz"))
    b = fx["lens"].shape[0]
    dec = CK.KernelCeltDecoder(b, device="cpu")
    for f in range(3):
        pcm, err = dec.decode([bytes(fx["frames"][i, f, :fx["lens"][i, f]])
                               for i in range(b)])
        st = dec.state
        assert not err.any()
        assert np.array_equal(dec.final_range().numpy().astype(np.uint32),
                              fx["final_range"][:, f])
        assert np.abs(pcm[:, 0].numpy() - fx["pcm"][:, f]).max() \
            <= CS.PCM_ABS_TOL
        assert torch.equal(st["e_copy"], st["old_e"])
        for k in ("loss_duration", "plc_duration", "prefilter_and_fold",
                  "skip_plc", "last_frame_type"):
            assert not st[k].any(), k
        assert st["decoded_any"].all()


def test_periodic_zeroing_matches_scalar():
    """The periodic branch's energy check on histories that trip it (random
    walks, noise that stops before the frame's end) and on histories that
    do not: the scalar CeltDecoder's ``_decode_lost`` from the same
    float32 history against the port's, lane by lane; branch, period and
    zeroing equal, PCM within PCM_ABS_TOL."""
    from opus_tpu.celt.decoder import CeltDecoder

    rng = np.random.default_rng(0)
    t = np.arange(2168)
    decs = []
    for k in range(24):
        d = CeltDecoder.create(48000, 1)
        d.skip_plc = 0
        x = np.cumsum(rng.standard_normal(2168)) if k % 2 else \
            rng.standard_normal(2168) * (t < rng.integers(1800, 2040))
        d.decode_mem[0] = (x / np.abs(x).max() * 10000).astype(np.float32)
        d.decode_mem[0, 2048:] = 0.0
        decs.append(d)
    dec = CK.KernelCeltDecoder(len(decs), device="cpu")
    dec.state = convert.celt_state_from_scalar(decs, "cpu")
    pcm = dec.conceal()[:, 0].numpy()
    zeroed = []
    for j, d in enumerate(decs):
        ref = np.zeros(960)
        d.decode_with_ec(None, ref, 960, None)
        z = not d.decode_mem[0, 2048 - 960:].any()
        zeroed.append(z)
        assert int(dec.plc_trace["branch"][j]) == d.last_frame_type == 1
        assert int(dec.plc_trace["pitch"][j]) == d.last_pitch_index
        assert bool(dec.plc_trace["zeroed"][j]) == z
        assert np.abs(pcm[j] - ref).max() <= CS.PCM_ABS_TOL
    assert 0 < sum(zeroed) < len(decs)
