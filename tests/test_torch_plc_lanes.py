"""Per-lane deep-PLC state (opus_tpu_torch/dnn/plc.py ``LPCNetPLC``,
``dnn/dred_dec.feed_dred_fec``) against independent JAX ``LPCNetPLC``
instances (opus_tpu/dnn/plc.py, dred_dec.py) on the CPU.

tests/data/torch_sim_loss.npz (tools/make_torch_sim_loss_fixture.py) holds
8 JAX instances (PLC 44, pitch DNN 45, FARGAN 46), each driven through 16
ticks of 10 ms by its own loss pattern (``update`` on a good tick,
``conceal`` on a lost one) with ``reset`` on lanes 0, 3 and 6 before tick
8; the port runs them as one 8-lane instance, one masked ``update`` and
one masked ``conceal`` a tick.  Bounds: the counters, loss counts and
FARGAN periods exact; the concealed int16 within 1 LSB (FARGAN's f32
output differs from XLA's by the order of the GEMM sums); the features
within chip_smoke.PLC_FEAT_TOL (concealed PCM with 1-LSB differences
re-enters the catch-up analysis).
"""

import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu.dnn import dred_dec as JDD
from opus_tpu.dnn import fargan as JFG
from opus_tpu.dnn import pitchdnn as JP
from opus_tpu.dnn import plc as JPL
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import dred_dec as PDD
from opus_tpu_torch.dnn import plc as PPL

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
COUNTERS = ("loss_count", "analysis_pos", "predict_pos", "blend",
            "analysis_gap")


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(DATA, "torch_sim_loss.npz"))


def _port(b):
    return PPL.LPCNetPLC(*CS.plc_models("cpu"), b, device="cpu")


def _leaves(st):
    return torch.utils._pytree.tree_leaves(st)


def test_plc_lanes_match_independent_jax_instances(fx):
    lost, hist = fx["plc_lost"], torch.from_numpy(fx["plc_hist"])
    b, ticks = lost.shape
    lp = _port(b)
    reset = np.zeros(b, bool)
    reset[list(CS.PLC_RESET_LANES)] = True
    e_pcm = e_feat = 0.0
    n_int = 0
    for t in range(ticks):
        if t == CS.PLC_RESET_TICK:
            lp.reset(torch.from_numpy(reset))
        lt = torch.from_numpy(lost[:, t])
        lp.update(hist[:, t], ~lt)
        out = lp.conceal(lt).numpy()
        for k in COUNTERS:
            assert np.array_equal(getattr(lp, k).numpy(),
                                  fx[f"plc_{k}"][:, t]), (k, t)
        assert np.array_equal(lp.fargan.last_period.numpy(),
                              fx["plc_period"][:, t]), t
        n_int += b * (len(COUNTERS) + 1)
        e_pcm = max(e_pcm, float(np.abs(out.astype(np.int64)
                                        - fx["plc_pcm"][:, t]).max()))
        e_feat = max(e_feat, float(np.abs(lp.features.numpy()
                                          - fx["plc_feats"][:, t]).max()))
    print(f"per-lane LPCNetPLC: {n_int} integers equal over {ticks} ticks "
          f"({int(lost.sum())} concealed lane-ticks, resets on lanes "
          f"{CS.PLC_RESET_LANES}); PCM {e_pcm:.0f} LSB, features "
          f"{e_feat:.3g}")
    assert e_pcm <= CS.PLC_LSB_16K and e_feat <= CS.PLC_FEAT_TOL


@pytest.mark.parametrize("op", ["update", "conceal", "reset", "fec_add",
                                "fec_clear"])
def test_plc_lanes_outside_the_mask_keep_their_state(fx, op):
    """After 6 ticks of the fixture's pattern (mid catch-up, mid loss run),
    one call on lanes 1, 4 and 6: every tensor of the other lanes' state is
    unchanged bit for bit, and the masked lanes moved."""
    lost, hist = fx["plc_lost"], torch.from_numpy(fx["plc_hist"])
    b = lost.shape[0]
    lp = _port(b)
    for t in range(6):
        lt = torch.from_numpy(lost[:, t])
        lp.update(hist[:, t], ~lt)
        lp.conceal(lt)
    lp.fec_add(torch.ones(b, 20))
    before = copy.copy(lp)
    m = torch.zeros(b, dtype=torch.bool)
    m[[1, 4, 6]] = True
    if op == "update":
        lp.update(hist[:, 6], m)
    elif op == "conceal":
        lp.conceal(m)
    elif op == "reset":
        lp.reset(m)
    elif op == "fec_add":
        lp.fec_add(2 * torch.ones(b, 20), lanes=m)
    else:
        lp.fec_clear(m)
    moved = False
    for a, z in zip(_leaves(lp._state()), _leaves(before._state())):
        assert torch.equal(a[~m], z[~m])
        moved |= not torch.equal(a[m], z[m])
    assert moved


def test_plc_converter_takes_per_lane_counters(fx):
    """JAX instances at different points of their own sequences (one
    fresh, one after 3 good frames, one after 16) convert to one port
    instance with each lane's own counters and buffers."""
    hist = fx["plc_hist"]
    jax_models = (JPL.random_model(44), JP.random_model(45),
                  JFG.random_model(46))
    js = [JPL.LPCNetPLC(*jax_models) for _ in range(3)]
    for i, n in enumerate((0, 3, 16)):
        for k in range(n):
            js[i].update(hist[i, k])
    lp = convert.lpcnet_state_from_jax(js)
    for k in COUNTERS + ("fec_read_pos", "fec_fill_pos", "fec_skip"):
        assert getattr(lp, k).tolist() == [int(getattr(j, k)) for j in js]
    assert np.array_equal(lp.pcm.numpy(), np.stack([j.pcm for j in js]))


def test_feed_dred_fec_per_lane_blend_frame_size_and_mask():
    """Lanes with their own blend (2 initial rows or none), frame size and
    offset, one lane outside the mask: the queues equal JAX feed_dred_fec
    per instance, and the masked-out lane's queue is untouched."""
    rng = np.random.default_rng(11)
    b, rows = 4, 16
    feats = rng.standard_normal((b, rows, 20)).astype(np.float32)
    nb = np.array([4, 3, 4, 2])
    d_off = np.array([8, -4, 0, 12])
    offs = np.array([2 * 480 + 7, 5 * 480, 0, 480])
    fsz = np.array([960, 2880, 480, 1920])
    blend = np.array([0, 1, 0, 1])
    mask = np.array([True, True, False, True])
    lp = _port(b)
    lp.blend = torch.from_numpy(blend)
    lp.fec_add(torch.ones(b, 20))
    lp.fec_add(None)
    before = copy.copy(lp)
    batch = PDD.DREDBatch(torch.from_numpy(feats), nb, d_off)
    PDD.feed_dred_fec(lp, batch, offs, 48000, fsz, torch.from_numpy(mask))
    for i in range(b):
        if not mask[i]:
            for k in ("fec", "fec_fill_pos", "fec_skip", "fec_read_pos"):
                assert torch.equal(getattr(lp, k)[i],
                                   getattr(before, k)[i])
            continue
        j = _bare_jax_plc(int(blend[i]))
        d = JDD.OpusDRED(2, int(d_off[i]), int(nb[i]), None, None,
                         feats[i])
        JDD.feed_dred_fec(j, d, int(offs[i]), 48000, int(fsz[i]))
        assert lp.fec_fill_pos[i].item() == j.fec_fill_pos
        assert lp.fec_skip[i].item() == j.fec_skip
        assert lp.fec_read_pos[i].item() == 0
        assert np.array_equal(lp.fec[i, :j.fec_fill_pos].numpy(),
                              j.fec[:j.fec_fill_pos])


def _bare_jax_plc(blend: int):
    """A JAX LPCNetPLC's FEC queue and blend without its models (the queue
    logic reads no model)."""
    j = JPL.LPCNetPLC.__new__(JPL.LPCNetPLC)
    j.fec = np.zeros((JPL.PLC_MAX_FEC, JPL.NB_FEATURES), np.float32)
    j.fec_read_pos = j.fec_fill_pos = j.fec_skip = 0
    j.blend = blend
    return j
