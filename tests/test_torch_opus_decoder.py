"""The port's top-level decoder (opus_tpu_torch/models/opus_decoder.py
``BatchedOpusDecoder``) on the CPU, against the JAX package's scalar
``OpusDecoder`` (bit-exact with libopus):

- over the whole fixture tests/data/torch_opus_api.npz (8 mixed streams,
  every mono TOC configuration of frames up to 20 ms, codes 0-3,
  transitions with and without redundancy, the hybrid -> SILK fade,
  NB <-> MB <-> WB, frame-size switches, DTX, loss; written by
  tools/make_torch_opus_api_fixture.py): final range equal on every
  packet, int16 equal on every packet the scalar CELT decoder took no part
  in (SILK alone), float PCM within 1e-4 on the others, concealed packets
  within CLASSIC_LSB (4) LSB;
- from the JAX decoders' state taken mid-stream just before a transition
  (``convert.opus_decoder_state``), and from its own state
  (``get_state`` / ``set_state``) bit for bit;
- per-lane errors: an FEC size off the 2.5 ms grid refused before any
  lane changes, an invalid packet flags its lane only and leaves its
  state alone, a flagged lane stays flagged; SILK 40/60 ms and stereo
  packets decode (tests/test_torch_opus_stereo.py holds them to the
  scalar decoder over a whole fixture); OPUS_SET_GAIN; the batched soft
  clip bit for bit;
- against ``tools/sim_loss.BatchedLossDecoder`` on the single-mode loss
  traffic of tests/data/torch_sim_loss.npz and torch_silk_plc.npz;
- in-band FEC (``decode_fec=``, ``frame_size=``) on torch_silk_plc.npz's
  SILK-WB and FB hybrid streams (which carry LBRR frames): per-lane
  scripts against the scalar decoder, and opus_demo's ``-inbandfec``
  loop against ``BatchedLossDecoder(inbandfec=True)``.
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.models import opus_decoder as OD
from opus_tpu_torch.models.opus_decoder import BatchedOpusDecoder
from opus_tpu_torch.utils.soft_clip import (float2int16_lanes,
                                            soft_clip_lanes)

FIXTURE = "tests/data/torch_opus_api.npz"
PCM_TOL = 1e-4
CLASSIC_LSB = int(32768 * PCM_TOL) + 1


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _packets(fx, s):
    plen, buf = fx["plen"], fx["packets"]
    return [None if plen[s, t] == -1 else bytes(buf[s, t, :plen[s, t]])
            for t in range(plen.shape[1]) if plen[s, t] != -2]


def _ref(fx, s, t):
    n = int(fx["nsamp"][s, t])
    o = int(fx["pcm_off"][s, t])
    return fx["pcm"][o:o + n]


def _jax_int16(x, mem):
    from opus_tpu.utils.soft_clip import float2int16, pcm_soft_clip
    x = np.asarray(x, np.float32).copy()
    pcm_soft_clip(x, 1, mem)
    return float2int16(x)


def test_torch_opus_api_fixture_matches_scalar(fx):
    """The whole fixture, 8 lanes at once: ranges, PCM, int16."""
    s_n = fx["plen"].shape[0]
    streams = [_packets(fx, s) for s in range(s_n)]
    ticks = max(len(r) for r in streams)
    dec = BatchedOpusDecoder(s_n, device="cpu")
    mem = np.zeros((s_n, 1), np.float32)
    worst = dict(pcm=0.0, conceal=0, checked=0, silk_exact=0)
    for t in range(ticks):
        pk = [r[t] if t < len(r) else None for r in streams]
        pcm, n = dec.decode(pk)
        clipped, dec.softclip_mem = soft_clip_lanes(pcm, dec.softclip_mem,
                                                    n=n)
        pcm16 = float2int16_lanes(clipped).numpy()
        rng = dec.final_range.numpy()
        assert not dec.flagged.any() and not dec.status.any()
        for s in range(s_n):
            if t >= len(streams[s]):
                continue
            ref = _ref(fx, s, t)
            assert n[s] == len(ref), (s, t)
            assert rng[s] == fx["rng"][s, t], (s, t)
            want16 = _jax_int16(ref, mem[s])
            got16 = pcm16[s, :n[s]].astype(np.int64)
            if pk[s] is None:
                d = int(np.abs(got16 - want16).max(initial=0))
                assert d <= CLASSIC_LSB, (s, t, d)
                worst["conceal"] = max(worst["conceal"], d)
            elif fx["celt_calls"][s, t] == 0:
                assert np.array_equal(got16, want16), (s, t)
                worst["silk_exact"] += 1
            else:
                e = float(np.abs(pcm[s, :n[s]].numpy() - ref).max(initial=0))
                assert e <= PCM_TOL, (s, t, e)
                worst["pcm"] = max(worst["pcm"], e)
            worst["checked"] += 1
    ev = dec.events
    for k in ("transition", "redundancy_celt_to_silk",
              "redundancy_silk_to_celt", "fade_hybrid_to_silk", "dtx",
              "concealed", "celt_lm0_start0", "celt_lm1_start0",
              "celt_lm2_start17", "silk_8k_10ms", "silk_12k_10ms"):
        assert ev.get(k, 0) > 0, k
    print(f"\nfixture: {worst}; events {ev}")


def _transitions(pk):
    """Indices t where the mode of packet t differs from that of the last
    packet before it (lost packets skipped)."""
    from opus_tpu_torch.bitstream.packet import packet_get_mode
    out, last = [], None
    for t, p in enumerate(pk):
        if p is None or len(p) <= 2:
            continue
        m = packet_get_mode(p)
        if last is not None and m != last:
            out.append(t)
        last = m
    return out


# handoff points: (stream, which transition); the JAX decoder's state is
# taken one packet before it
HANDOFFS = [(0, 0), (3, 1), (4, 0), (6, 2), (7, 1)]


@pytest.mark.parametrize("stream,which", HANDOFFS)
def test_torch_opus_api_continues_from_jax_state(fx, stream, which):
    """The JAX scalar decoder run to the packet before a mode transition,
    its state converted (``convert.opus_decoder_state``): the port
    continues over the next 4 packets with the scalar's final ranges and
    PCM within 1e-4; and a second port decoder from the first's
    ``get_state`` continues bit for bit."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu_torch.convert import opus_decoder_state

    pk = _packets(fx, stream)
    at = _transitions(pk)[which] - 1
    ref = OpusDecoder(48000, 1)
    for p in pk[:at]:
        ref.decode(p)
    dec = BatchedOpusDecoder(1, device="cpu")
    dec.set_state(opus_decoder_state([ref]))
    twin = BatchedOpusDecoder(1, device="cpu")
    twin.set_state(dec.get_state())
    for p in pk[at:at + 4]:
        want = ref.decode(p)
        got, n = dec.decode([p])
        got2, n2 = twin.decode([p])
        assert n[0] == len(want)
        assert int(dec.final_range[0]) == ref.rangeFinal
        assert np.abs(got[0, :n[0]].numpy() - want).max(initial=0) <= PCM_TOL
        assert torch.equal(got, got2) and np.array_equal(n, n2)
        assert torch.equal(dec.final_range, twin.final_range)
    ev = dec.events
    assert ev.get("transition", 0) + ev.get("redundancy_celt_to_silk", 0) \
        + ev.get("redundancy_silk_to_celt", 0) \
        + ev.get("fade_hybrid_to_silk", 0) + ev.get("celt_reset", 0) > 0, ev


def test_torch_opus_api_refusal_changes_no_lane(fx):
    """A call that raises (lane 1's FEC request of 7 ms, or of 2.5 ms
    plus one sample) leaves every lane's state and host fields as they
    were, lane 0's valid packet included."""
    pk = _packets(fx, 1)
    dec = BatchedOpusDecoder(2, device="cpu")
    dec.decode([pk[0], pk[0]])
    before = dec.get_state()
    for size in (336, 121):
        with pytest.raises(ValueError, match="2.5 ms"):
            dec.decode([pk[1], pk[2]], decode_fec=[False, True],
                       frame_size=[0, size])
        assert _same(before, dec.get_state())


def _long_silk_packet(config: int):
    """A SILK-only packet of TOC configuration ``config`` (40 or 60 ms;
    NB, MB or WB) from the scalar encoder, and the scalar decoder's
    (pcm, final range) of it."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.models.opus_encoder import OpusEncoder

    bw = (pkt.Bandwidth.NARROWBAND, pkt.Bandwidth.MEDIUMBAND,
          pkt.Bandwidth.WIDEBAND)[config // 4]
    n = 1920 if config % 4 == 2 else 2880
    enc = OpusEncoder(48000, 1, application="voip")
    enc.set_jax_nsq(False)
    enc.set_force_mode(pkt.Mode.SILK_ONLY)
    enc.set_bandwidth(bw)
    enc.set_bitrate(12000)
    t = np.arange(n) / 48000
    p = bytes(enc.encode(0.3 * np.sin(2 * np.pi * 180 * t)
                         * (1 + 0.5 * np.sin(2 * np.pi * 5 * t)), n))
    assert p[0] >> 3 == config, (config, p[0] >> 3)
    ref = OpusDecoder(48000, 1)
    return p, np.asarray(ref.decode(p)), ref.rangeFinal


@pytest.mark.parametrize("config", [2, 3, 6, 7, 10, 11])
def test_torch_opus_api_refuses_silk_40_60_ms(config):
    """No longer refused: a SILK-only packet of each 40/60 ms TOC
    configuration decodes to the scalar decoder's final range and PCM
    (SILK alone: exact), next to a lost lane (20 ms of zeros: it has
    decoded nothing yet)."""
    p, want, rng = _long_silk_packet(config)
    dec = BatchedOpusDecoder(2, device="cpu")
    pcm, n = dec.decode([p, None])
    assert n.tolist() == [len(want), 960]
    assert not pcm[1].any()
    assert int(dec.final_range[0]) == rng
    assert np.array_equal(pcm[0, :n[0]].numpy().astype(np.float64), want)


def test_torch_opus_api_refuses_stereo_and_missing_card():
    """A stereo packet (CELT FB 20 ms) decodes on a one-channel decoder,
    to the scalar decoder's final range and within 1e-4 of its PCM; with
    no card the default device is refused."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.models.opus_encoder import OpusEncoder

    enc = OpusEncoder(48000, 2)
    enc.set_force_mode(pkt.Mode.CELT_ONLY)
    enc.set_bitrate(96000)
    t = np.arange(960) / 48000
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                  0.2 * np.sin(2 * np.pi * 660 * t)], 1)
    p = bytes(enc.encode(x.reshape(-1), 960))
    assert p[0] & 4, "a stereo packet"
    ref = OpusDecoder(48000, 1)
    want = np.asarray(ref.decode(p))
    dec = BatchedOpusDecoder(1, device="cpu")
    pcm, n = dec.decode([p])
    assert n[0] == len(want) and int(dec.final_range[0]) == ref.rangeFinal
    assert np.abs(pcm[0, :n[0]].numpy() - want).max() <= PCM_TOL
    assert dec.events.get("celt_lm3_start0_stereo", 0) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedOpusDecoder(1)


def _state_of_lane(dec, i):
    st = dec.get_state()

    def lane(t):
        if isinstance(t, dict):
            return {k: lane(v) for k, v in t.items()}
        return t[i].clone() if torch.is_tensor(t) else t[i].copy()
    return lane(st)


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b) if torch.is_tensor(a) else np.array_equal(a, b)


def test_torch_opus_api_invalid_packet_flags_its_lane_only(fx):
    """Lane 1's packet is invalid (a code 3 packet claiming 0 frames, then
    one whose frames would exceed 120 ms): its status is
    OPUS_INVALID_PACKET for that call, it returns nothing and its state
    is untouched; lane 0 decodes as it does alone."""
    pk = _packets(fx, 1)
    dec = BatchedOpusDecoder(2, device="cpu")
    solo = BatchedOpusDecoder(1, device="cpu")
    dec.decode([pk[0], pk[0]])
    solo.decode([pk[0]])
    for bad in (bytes([(31 << 3) | 3, 0]),
                bytes([(31 << 3) | 3, 49]) + bytes(49 * 3)):
        before = _state_of_lane(dec, 1)
        pcm, n = dec.decode([pk[1], bad])
        want, wn = solo.decode([pk[1]])
        pk_ok = pk[2]
        assert dec.status.tolist() == [0, -4]
        assert n[1] == 0 and n[0] == wn[0]
        # the same frames in a batch of 1 and of 2: the synthesis' f32
        # products may round apart in the last bit
        assert (pcm[0, :n[0]] - want[0, :wn[0]]).abs().max() <= 1e-6
        assert int(dec.final_range[0]) == int(solo.final_range[0])
        assert _same(before, _state_of_lane(dec, 1))
        assert not dec.flagged.any()
    dec.decode([pk_ok, pk_ok])
    assert dec.status.tolist() == [0, 0]


def test_torch_opus_api_flag_stays(fx, monkeypatch):
    """A lane K1 flags once stays flagged for later frames; the other lane
    is never flagged."""
    pk = _packets(fx, 1)
    dec = BatchedOpusDecoder(2, device="cpu")
    real = OD.kernel_celt_decode_to_pcm
    calls = []

    def flag_lane_1_once(buf, lens, state, tabs, frame_fn=None, d0=None):
        pcm, st, err = real(buf, lens, state, tabs, frame_fn, d0)
        if not calls and buf.shape[0] == 2:
            err = torch.tensor([False, True])
        calls.append(1)
        return pcm, st, err
    monkeypatch.setattr(OD, "kernel_celt_decode_to_pcm", flag_lane_1_once)
    dec.decode([pk[0], pk[0]])
    assert dec.flagged.tolist() == [False, True]
    for p in pk[1:4]:
        dec.decode([p, p])
        assert dec.flagged.tolist() == [False, True]


def test_torch_opus_api_gain_and_int16(fx):
    """OPUS_SET_GAIN on one lane (-6 dB in Q8) as the scalar decoder's
    ``decode_gain``; ``decode_int16`` as the scalar's."""
    from opus_tpu.models.opus_decoder import OpusDecoder

    pk = _packets(fx, 6)[:4]
    dec = BatchedOpusDecoder(2, device="cpu")
    dec.set_gain(-6 * 256, lanes=[False, True])
    refs = [OpusDecoder(48000, 1), OpusDecoder(48000, 1)]
    refs[1].decode_gain = -6 * 256
    for p in pk:
        got, n = dec.decode_int16([p, p])
        for i, r in enumerate(refs):
            want = r.decode_int16(p)
            d = np.abs(got[i, :n[i]].numpy().astype(np.int64) - want).max()
            assert d <= 1, (i, d)
            assert int(dec.final_range[i]) == r.rangeFinal


def test_torch_soft_clip_lanes_matches_scalar():
    """``soft_clip_lanes`` over lanes that overshoot, with the memory
    carried over 3 calls, bit for bit with the JAX package's
    ``pcm_soft_clip`` lane by lane; lanes of n = 0 keep their memory."""
    from opus_tpu.utils.soft_clip import pcm_soft_clip

    rng = np.random.default_rng(5)
    b, w = 6, 240
    mem = torch.zeros(b, dtype=torch.float32)
    ref_mem = np.zeros((b, 1), np.float32)
    for call in range(3):
        x = (rng.standard_normal((b, w)) * np.array(
            [0.2, 0.9, 1.6, 2.5, 1.2, 0.5])[:, None]).astype(np.float32)
        n = np.array([w, w, w, 200, 0, w])
        got, mem = soft_clip_lanes(torch.from_numpy(x), mem, n=n)
        for i in range(b):
            if n[i] == 0:
                continue
            y = x[i, :n[i]].copy()
            pcm_soft_clip(y, 1, ref_mem[i])
            assert np.array_equal(got[i, :n[i]].numpy(), y), (call, i)
        assert np.array_equal(mem.numpy(), ref_mem[:, 0])


def test_torch_soft_clip_lanes_segments_match_scalar():
    """``soft_clip_lanes`` on 96 lanes of ``chip_smoke.soft_clip_inputs``
    over 4 calls, lane lengths 0-W, the memory carried: every sample and
    every memory bit for bit with the JAX package's ``pcm_soft_clip``
    lane by lane; a call of no samples keeps every memory."""
    import chip_smoke as CS
    from opus_tpu.utils.soft_clip import pcm_soft_clip

    rng = np.random.default_rng(16)
    b, w = 96, 480
    mem = torch.zeros(b, dtype=torch.float32)
    ref_mem = np.zeros((b, 1), np.float32)
    for call in range(4):
        x = CS.soft_clip_inputs(rng, b, w)
        n = rng.choice([0, 1, 2, 120, 479, w], b, p=[.05, .05, .05, .1,
                                                      .1, .65])
        got, mem = soft_clip_lanes(torch.from_numpy(x), mem, n=n)
        for i in range(b):
            if n[i] == 0:
                continue
            y = x[i, :n[i]].copy()
            pcm_soft_clip(y, 1, ref_mem[i])
            assert np.array_equal(got[i, :n[i]].numpy(), y), (call, i)
        assert np.array_equal(mem.numpy(), ref_mem[:, 0]), call
    # a call where no lane has a sample (every packet invalid)
    empty, same = soft_clip_lanes(torch.zeros((b, 0)), mem)
    assert empty.shape == (b, 0) and torch.equal(same, mem)


def _demo_loop(dec_call, packets, lost, b):
    """opus_demo's plain loop with a BatchedOpusDecoder: each tick a lost
    lane conceals 20 ms, the others decode their packet; int16 as opus_demo
    writes it."""
    from opus_tpu_torch.tools.sim_loss import to_int16
    outs, rngs = [], []
    for t in range(lost.shape[1]):
        pk = [None if lost[i, t] else packets[i][t] for i in range(b)]
        pcm, n = dec_call.decode(pk)
        assert (n == 960).all()
        outs.append(to_int16(pcm).numpy())
        rngs.append(dec_call.final_range.numpy().copy())
    return np.stack(outs, 1), np.stack(rngs, 1)


@pytest.mark.parametrize("mode", ["celt", "silk", "hybrid"])
def test_torch_opus_api_matches_batched_loss_decoder(mode):
    """opus_demo's plain loss loop on one mode's traffic (CELT: the
    sim_loss fixture's streams, their DRED in the padding unread, under
    its flags; SILK-WB and
    FB hybrid: the silk_plc fixture's under its plain-loop flags), 8 lanes
    over 8 ticks: ``BatchedOpusDecoder`` and ``BatchedLossDecoder`` give
    equal final ranges, equal SILK int16, and CELT / hybrid int16 within
    1 LSB (see below)."""
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder
    ticks = 8
    if mode == "celt":
        sfx = np.load("tests/data/torch_sim_loss.npz")
        lens, buf = sfx["packet_lens"], sfx["packets"]
        packets = [[bytes(buf[i, t, :lens[i, t]]) for t in range(ticks)]
                   for i in range(buf.shape[0])]
        lost = sfx["loop_lost"][:, :ticks].astype(bool)
    else:
        sfx = np.load("tests/data/torch_silk_plc.npz")
        key = "silk" if mode == "silk" else "hyb"
        lens, buf = sfx[f"{key}_lens"], sfx[f"{key}_packets"]
        packets = [[bytes(buf[i, t, :lens[i, t]]) for t in range(ticks)]
                   for i in range(buf.shape[0])]
        lost = sfx[f"{key}_lost"][:, :ticks].astype(bool)
    b = len(packets)
    got16, got_rng = _demo_loop(BatchedOpusDecoder(b, device="cpu"),
                                packets, lost, b)
    ref = BatchedLossDecoder(b, device="cpu", dred=False, mode=mode)
    ref16, ref_rng = [], []
    for t in range(ticks):
        pcm, n = ref.tick([packets[i][t] for i in range(b)], lost[:, t])
        assert (n == 960).all()
        ref16.append(pcm.numpy())
        ref_rng.append(ref.final_range().numpy().copy())
    assert np.array_equal(got_rng, np.stack(ref_rng, 1))
    ref16 = np.stack(ref16, 1)
    if mode == "silk":
        assert np.array_equal(got16, ref16)
        return
    # a CELT call runs over the lanes that need it here and over every
    # lane under a mask there: the f32 IMDCT products of another batch
    # size may round apart in the last bit, an int16 step now and then
    d = np.abs(got16.astype(np.int64) - ref16)
    assert d.max() <= 1
    print(f"\n{mode}: int16 equal on {100 * (d == 0).mean():.3f}% of "
          f"samples, 1 LSB apart elsewhere")


def test_torch_opus_demo_decode_matches_jax_opus_demo(fx, tmp_path):
    """``python -m opus_tpu_torch.tools.opus_demo decode --device cpu`` on
    3 of the fixture's streams written as opus_demo .bit files (a lost
    packet as length 0; each packet's final range stored): exit code 0
    (every final range checked), and the same PCM files as the JAX
    package's ``opus_demo.decode``: equal for the SILK-only stream, within
    CLASSIC_LSB for the others (float32 against float64 PCM)."""
    import struct

    from opus_tpu.tools import opus_demo as jax_demo
    from opus_tpu_torch.tools import opus_demo

    args = []
    for s in (2, 0, 5):
        bit = tmp_path / f"s{s}.bit"
        with open(bit, "wb") as fh:
            for t, p in enumerate(_packets(fx, s)):
                p = p or b""
                fh.write(struct.pack(">iI", len(p), int(fx["rng"][s, t])
                                     if p else 0) + p)
        args += [str(bit), str(tmp_path / f"s{s}.pcm")]
    assert opus_demo.main(["decode", "--device", "cpu"] + args) == 0
    for s, (bit, pcm) in zip((2, 0, 5), zip(args[0::2], args[1::2])):
        ref = str(tmp_path / f"ref{s}.pcm")
        assert jax_demo.decode(48000, 1, bit, ref) == 0
        got = np.fromfile(pcm, "<i2").astype(np.int64)
        want = np.fromfile(ref, "<i2").astype(np.int64)
        assert len(got) == len(want)
        d = np.abs(got - want).max()
        assert d == 0 if s == 2 else d <= CLASSIC_LSB, (s, d)


# ---- in-band FEC -------------------------------------------------------

def _silk_plc_packets(mode):
    import chip_smoke as CS
    sfx = np.load("tests/data/torch_silk_plc.npz")
    return CS.silk_plc_packets(sfx, mode)


def _fec_scripts(n_lanes, calls, n_pk, seed):
    """Per-lane call scripts [(packet index or None, decode_fec,
    frame_size or None)]: plain decodes, lost packets concealed, and runs
    of 1-2 packets skipped then recovered from the next packet's LBRR
    frame (``decode_fec``, asking for 10, 20, 40 or 60 ms, or the default)
    before that packet is decoded; lane 0 starts with an FEC call."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_lanes):
        t, s = 0, []
        if i == 0:
            s, t = [(0, True, 960), (0, False, None)], 1
        while len(s) < calls:
            u = rng.random()
            if t >= n_pk or u < 0.15:
                s.append((None, False, None))
                t += 1
            elif u < 0.55 and t + 1 < n_pk and len(s) + 2 <= calls:
                t = min(t + int(rng.integers(1, 3)), n_pk - 1)
                size = [None, 480, 960, 1920, 2880][int(rng.integers(0, 5))]
                s += [(t, True, size), (t, False, None)]
                t += 1
            else:
                s.append((t, False, None))
                t += 1
        out.append(s)
    return out


@pytest.mark.parametrize("mode", ["silk", "hybrid"])
def test_torch_opus_api_inband_fec_matches_scalar(mode):
    """8 lanes over 12 calls of per-lane scripts (``_fec_scripts``) that
    mix, in one call, plain decodes, concealments and FEC calls asking for
    less than, as much as and more than the packet's 20 ms (the split
    between the concealed part and the LBRR frame): each call's sample
    count and final range equal the scalar ``OpusDecoder.decode(p,
    frame_size, decode_fec)``'s (a hybrid FEC call's range is the CELT
    concealment's seed); SILK PCM equal; hybrid PCM within 1e-4 on a
    decoded packet and within CLASSIC_LSB on an FEC call or a
    concealment."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu_torch.tools.sim_loss import lbrr_flag, mode_frame

    pk = _silk_plc_packets(mode)
    b, calls = 8, 12
    sc = _fec_scripts(b, calls, len(pk[0]), 7)
    dec = BatchedOpusDecoder(b, device="cpu")
    got = []
    for c in range(calls):
        row = [sc[i][c] for i in range(b)]
        pcm, n = dec.decode(
            [None if p is None else pk[i][p] for i, (p, _f, _s) in
             enumerate(row)], decode_fec=[f for _p, f, _s in row],
            frame_size=[s or 0 for _p, _f, s in row])
        got.append((pcm.numpy(), n, dec.final_range.numpy().copy()))
    seen = dict(less=0, equal=0, more=0, lbrr=0)
    worst = 0.0
    for i in range(b):
        ref = OpusDecoder(48000, 1)
        for c, (p, fec, size) in enumerate(sc[i]):
            data = None if p is None else pk[i][p]
            want = ref.decode(data, size, decode_fec=fec)
            pcm, n, rng = got[c]
            assert n[i] == len(want), (i, c)
            assert rng[i] == ref.rangeFinal, (i, c)
            d = np.abs(pcm[i, :n[i]].astype(np.float64) - want).max(
                initial=0)
            if mode == "silk":
                assert d == 0, (i, c, d)
            elif fec or data is None:
                assert d * 32768 <= CLASSIC_LSB, (i, c, d)
            else:
                assert d <= PCM_TOL, (i, c, d)
            worst = max(worst, d)
            if fec:
                need = size or 960
                seen["less" if need < 960 else
                     "more" if need > 960 else "equal"] += 1
                seen["lbrr"] += lbrr_flag(mode_frame(data, mode))
    print(f"\n{mode}: FEC calls {seen}, PCM within {worst:.3g}")
    assert all(seen.values()), seen
    assert dec.events.get("concealed", 0) > 0


@pytest.mark.parametrize("mode", ["silk", "hybrid"])
def test_torch_opus_api_inbandfec_loop_matches_batched_loss_decoder(mode):
    """opus_demo's ``-inbandfec`` loop on 8 lanes over 14 packets, losses
    at 2, 5-6, 9-11 and 13 on every lane: a lost packet is deferred, the
    next one is first decoded with ``decode_fec`` over the pending span
    (concealing all but its last 20 ms, then its LBRR frame), then
    decoded; the run open at the end is concealed.  Against
    ``BatchedLossDecoder(inbandfec=True)`` tick by tick: final ranges and
    int16 equal on SILK, int16 within 1 LSB on hybrid (see
    ``test_torch_opus_api_matches_batched_loss_decoder``)."""
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder, to_int16

    pk = _silk_plc_packets(mode)
    b, ticks = 8, 14
    lost = np.zeros((b, ticks), bool)
    lost[:, [2, 5, 6, 9, 10, 11, 13]] = True
    dec = BatchedOpusDecoder(b, device="cpu")
    ref = BatchedLossDecoder(b, device="cpu", dred=False, mode=mode,
                             inbandfec=True)
    got16 = [[] for _ in range(b)]
    ref16 = [[] for _ in range(b)]

    def add(dst, pcm16, n):
        for i in range(b):
            dst[i].append(pcm16[i, :n[i]])
    pending = 0
    for t in range(ticks):
        pcm, n = ref.tick([pk[i][t] for i in range(b)], lost[:, t])
        add(ref16, pcm.numpy(), n)
        if lost[0, t]:
            pending += 960
        else:
            row = [pk[i][t] for i in range(b)]
            if pending:
                pcm, n = dec.decode(row, decode_fec=[True] * b,
                                    frame_size=[pending] * b)
                add(got16, to_int16(pcm).numpy(), n)
                pending = 0
            pcm, n = dec.decode(row)
            add(got16, to_int16(pcm).numpy(), n)
        assert np.array_equal(dec.final_range.numpy(),
                              ref.final_range().numpy()), t
    pcm, n = dec.decode([None] * b, frame_size=[pending] * b)
    add(got16, to_int16(pcm).numpy(), n)
    pcm, n = ref.flush()
    add(ref16, pcm.numpy(), n)
    assert np.array_equal(dec.final_range.numpy(),
                          ref.final_range().numpy())
    assert ref.events and any(ev["call"] == "fec" for ev in ref.events)
    worst = 0
    for i in range(b):
        g = np.concatenate(got16[i]).astype(np.int64)
        r = np.concatenate(ref16[i]).astype(np.int64)
        assert len(g) == len(r) == ticks * 960
        worst = max(worst, int(np.abs(g - r).max()))
    print(f"\n{mode}: int16 within {worst} LSB of BatchedLossDecoder")
    assert worst <= (0 if mode == "silk" else 1)
