"""The SILK classic concealment, comfort noise and in-band FEC of the port
(opus_tpu_torch/models/silk_plc.py, ``fused_silk_conceal``,
``fused_silk_decode(..., lbrr=)``) against the scalar SILK decoder
(opus_tpu/silk/decoder.py, macros.py), module by module, exactly.

tests/data/torch_silk_plc.npz (tools/make_torch_silk_plc_fixture.py) holds
snapshots of the scalar ``ChannelState`` before and after chosen slots of
opus_demo's loops on SILK-WB streams: each test loads the "before" states
into one batch of port lanes, runs the port's step once over all of them
and holds every state field and the 16 kHz frame to the "after" snapshot.
Also the fixed-point helpers against silk/macros.py, and the decoders'
lane masks: a lane outside ``active`` / ``lanes`` keeps every state field
bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from opus_tpu.silk import macros as M
from opus_tpu.silk.decoder import silk_bwexpander
from opus_tpu_torch import convert
from opus_tpu_torch.models import fused_silk_dec as PF
from opus_tpu_torch.models import hybrid_dec_fused as PH
from opus_tpu_torch.models import silk_plc as PLC
from opus_tpu_torch.ops import silk_fixed as F

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(os.path.join(DATA, "torch_silk_plc.npz")))


def test_silk_rand_closed_form_matches_ten_thousand_steps():
    """silk_rand_seq's closed form (a**k seed + c (a**k - 1) / (a - 1) mod
    2**32) against 10**4 steps of silk_RAND from extreme and random
    seeds; silk_rand against one step."""
    seeds = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 3176576, 123456789]
    got = F.silk_rand_seq(torch.tensor(seeds), 10 ** 4).numpy()
    for i, s in enumerate(seeds):
        x, ref = s, []
        for _ in range(10 ** 4):
            x = M.silk_RAND(x)
            ref.append(x)
        assert got[i].tolist() == ref, s
    one = F.silk_rand(torch.tensor(seeds)).tolist()
    assert one == [M.silk_RAND(s) for s in seeds]


@pytest.mark.parametrize("n", [80, 320, 81])
def test_sum_sqr_shift_sqrt_approx_bwexpander_match_macros(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-32768, 32768, (256, n)) >> rng.integers(0, 16, (256, 1))
    x[0], x[1], x[2], x[3, ::2] = 32767, -32768, 0, -32768
    e, sh = F.sum_sqr_shift(torch.from_numpy(x))
    assert [(int(a), int(b)) for a, b in zip(e, sh)] \
        == [M.sum_sqr_shift(r.tolist()) for r in x]
    v = np.concatenate([rng.integers(-10, 2 ** 31, 3000),
                        rng.integers(0, 4096, 1000),
                        [0, 1, 2, 3, 2 ** 24, 2 ** 31 - 1, -5]])
    assert F.sqrt_approx(torch.from_numpy(v)).tolist() \
        == [M.SQRT_APPROX(int(a)) for a in v]
    a = rng.integers(-32768, 32768, (32, 16))
    for chirp in (PLC.BWE_COEF_Q16, PLC.BWE_AFTER_LOSS_Q16, 65536, 1000):
        got = F.bwexpander(torch.from_numpy(a), chirp).numpy()
        for i in range(len(a)):
            ref = a[i].tolist()
            silk_bwexpander(ref, 16, chirp)
            assert got[i].tolist() == ref, chirp


def _group(fx, kinds):
    """Snapshot rows whose slot kind is in ``kinds`` (0 decoded, 1
    concealed, 4 LBRR, 5 DTX)."""
    rows = []
    for s, (loop, lane, slot) in enumerate(fx["snap_where"]):
        k = fx["silk_plain_kind" if loop == 0 else "silk_fec_kind"]
        if k[lane, slot] in kinds:
            rows.append(s)
    return np.asarray(rows)


def _state(fx, tag, rows):
    return {k: fx[f"snap_{tag}_{k}"][rows] for k in convert.SILK_SCALAR_KEYS}


def _check(fx, rows, xq, new):
    """Every field of the port's state and the frame against the "after"
    snapshots; returns the number of lanes checked."""
    got = convert.silk_state_to_scalar(new)
    ref = _state(fx, "after", rows)
    for k in convert.SILK_SCALAR_KEYS:
        bad = np.nonzero((got[k].reshape(len(rows), -1)
                          != ref[k].reshape(len(rows), -1)).any(axis=1))[0]
        assert not len(bad), (k, fx["snap_where"][rows[bad]].tolist())
    assert np.array_equal(xq.numpy(), fx["snap_xq"][rows].astype(np.int64))
    return len(rows)


def _packets(fx, rows, offset):
    """The SILK frames (TOC stripped) of each row's slot + offset."""
    frames, lens = [], []
    for _loop, lane, slot in fx["snap_where"][rows]:
        f = slot + offset
        n = fx["silk_lens"][lane, f]
        frames.append(fx["silk_packets"][lane, f, 1:n])
        lens.append(n - 1)
    buf = np.zeros((len(rows), max(lens)), np.uint8)
    for i, x in enumerate(frames):
        buf[i, :len(x)] = x
    return torch.from_numpy(buf), torch.tensor(lens)


def test_plc_conceal_cng_and_glue_energy_match_scalar(fx):
    """Lost and DTX slots (runs of 1-4, a DTX run, the noise of the
    first loss on unvoiced and voiced history): ``plc_conceal`` (noise
    pick, attenuation, bandwidth expansion, random scale, rewhitening, LTP
    and LPC synthesis), the comfort noise added on top (``cng_add``) and
    the glue's energy, every field and the frame exact."""
    rows = _group(fx, (1, 5))
    st = convert.silk_state_from_scalar(_state(fx, "before", rows))
    xq, new = PF.fused_silk_conceal(st)
    n = _check(fx, rows, xq, new)
    first = int((st["loss_cnt"] == 0).sum())
    print(f"{n} concealed slots ({first} first losses, "
          f"{int((st['prev_signal_type'] == 2).sum())} after voiced, "
          f"{int((st['cng_smth_gain_q16'] > 0).sum())} with comfort noise)")
    assert first and n > first


def test_plc_update_cng_update_and_glue_fade_match_scalar(fx):
    """Decoded frames: the first after each loss run (the bandwidth
    expansion and LTP override after a loss, the glue's fade-in) and every
    frame of a DTX lane (inactive ones update the comfort noise), through
    ``plc_update``, the CNG update and the glue, every field and the frame
    exact."""
    rows = _group(fx, (0,))
    st = convert.silk_state_from_scalar(_state(fx, "before", rows))
    buf, lens = _packets(fx, rows, 0)
    xq, new, err = PF.fused_silk_decode(buf, lens, st)
    assert not err.any()
    n = _check(fx, rows, xq, new)
    after = _state(fx, "after", rows)
    inactive = int((after["prevSignalType"] == 0).sum())
    faded = int((st["plc_last_frame_lost"] != 0).sum())
    print(f"{n} decoded slots: {int((st['loss_cnt'] > 0).sum())} after a "
          f"loss, {faded} after a lost or DTX frame (glue), {inactive} "
          f"inactive (CNG update), "
          f"{int((after['prevSignalType'] == 2).sum())} voiced")
    assert inactive and faded


def test_lbrr_frames_match_scalar(fx):
    """In-band FEC: the resuming packet's LBRR frame decoded in place of
    the last lost slot (``silk_symbols(..., lbrr=)``: the VAD type table,
    independent coding; then the frame pipeline), a stream's first frame
    among them, every field and the frame exact."""
    rows = _group(fx, (4,))
    st = convert.silk_state_from_scalar(_state(fx, "before", rows))
    buf, lens = _packets(fx, rows, 1)
    lb = torch.ones(len(rows), dtype=torch.bool)
    xq, new, err, d = PF.fused_silk_decode(buf, lens, st, lbrr=lb,
                                           return_rc=True)
    assert not err.any()
    print(f"{_check(fx, rows, xq, new)} LBRR slots")


def _fields(state):
    """Every tensor leaf of a state tree, by path."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}.{i}")
        else:
            out[path] = x.clone()
    walk(state, "")
    return out


def _same_lanes(a, b, lanes):
    for k, v in a.items():
        assert torch.equal(v[lanes], b[k][lanes]), k


@pytest.mark.parametrize("mode", ["silk", "hybrid"])
def test_masked_lanes_keep_every_field(fx, mode):
    """``decode_packed(..., active=)``, ``fec=``, ``conceal(lanes)`` and
    ``reset(lanes)`` on the SILK (48 kHz) and hybrid decoders: lanes
    outside the mask keep every state field and their final range bit for
    bit and return zeros with no error flag; the masked lanes decode as a
    decoder of their own would; a lane that has decoded nothing conceals
    zeros and keeps its state."""
    key = "silk" if mode == "silk" else "hyb"
    pk, ln = fx[f"{key}_packets"], fx[f"{key}_lens"]

    def make():
        if mode == "silk":
            return PF.FusedSilkDecoder(4, fs_out=48000, device="cpu")
        return PH.FusedHybridDecoder(4, device="cpu")

    def state_of(dec):
        return _fields(dict(s=dec.state, r=dec.final_range)
                       | ({"rs": dec.rs, "m": dec.smid}
                          if mode == "silk" else {}))
    dec, ref = make(), make()
    frames = [bytes(pk[i, 2, 1:ln[i, 2]]) for i in range(4)]
    buf, lens = dec.pack(frames)
    act = torch.tensor([True, False, True, False])
    before = state_of(dec)
    pcm, err = dec.decode_packed(buf, lens, active=act)
    pcm_all, _err = ref.decode_packed(buf, lens)
    assert not pcm[~act].any() and not err[~act].any()
    assert torch.equal(pcm[act], pcm_all[act])
    _same_lanes(before, state_of(dec), ~act)
    got, full = state_of(dec), state_of(ref)
    _same_lanes(got, full, act)
    # lane 1 has decoded nothing: conceal leaves it as it is
    before = state_of(dec)
    conc = dec.conceal(torch.tensor([False, True, True, False]))
    assert not conc[[0, 1, 3]].any() and conc[2].any()
    _same_lanes(before, state_of(dec), torch.tensor([True, True, False,
                                                     True]))
    assert dec.final_range[2] == 0
    # an FEC frame on lane 0 only
    before = state_of(dec)
    f3 = [bytes(pk[i, 3, 1:ln[i, 3]]) for i in range(4)]
    one = torch.tensor([True, False, False, False])
    dec.decode_packed(*dec.pack(f3), active=one, fec=one)
    _same_lanes(before, state_of(dec), ~one)
    # reset(lanes): lane 2 back to the initial state, the rest untouched
    before = state_of(dec)
    dec.reset(torch.tensor([False, False, True, False]))
    fresh = state_of(make())
    _same_lanes(fresh, state_of(dec), torch.tensor([False, False, True,
                                                    False]))
    _same_lanes(before, state_of(dec), torch.tensor([True, True, False,
                                                     True]))
