"""Writes tests/data/torch_silk_plc.npz: the JAX package's SILK classic
concealment, comfort noise and in-band FEC under opus_demo's loss loops,
the reference of the port's SILK / hybrid loss path
(opus_tpu_torch/models/silk_plc.py, ``FusedSilkDecoder`` and
``FusedHybridDecoder``'s ``conceal`` / ``fec`` / ``active``,
``tools/sim_loss.BatchedLossDecoder(mode=...)``; tests/
test_torch_silk_plc.py, tests/test_torch_silk_loss.py, chip_smoke.py's
silk_plc phase).  It reads opus_tpu and never edits it.

Packets, from the scalar ``OpusEncoder`` with in-band FEC on at 10%
expected loss (``set_jax_nsq(False)``: the numpy NSQ, bit-exact with the
JAX one), 16 frames of 20 ms each, one stream a process:

- ``silk``: 8 SILK-only wideband streams (TOC configuration 9) at 24
  kb/s from ``OpusEncoder(16000, 1, "voip")``; lanes 6 and 7 have DTX on
  over a signal with digital-silence stretches, so TOC-only packets
  occur;
- ``hyb``: 8 hybrid fullband streams (configuration 15) at 32 kb/s from
  ``OpusEncoder(48000, 1, "voip")`` with the mode forced to hybrid.

Then, per mode and loop (plain and ``-inbandfec``), each lane under its
own pattern (``lost_flags``: runs of 1-4 losses, a loss before the first
packet, a loss on the last frame): ``opus_demo.decode`` itself at 48 kHz
mono (a .bit file and a lossfile a stream) and a replica of its loop that
records each 20 ms slot.  opus_demo's int16 output is kept as each slot's
BLAKE2b-128 digest in the SILK loops (``silk_<loop>_digest`` [8, 16, 16]:
they are held exactly) and as first differences in the hybrid loops
(``hyb_plain_d16`` [8, 16 * 960]: ``cumsum`` gives the int16, held
within a bound; ``hyb_fec_d16`` the same of -inbandfec's output less the
plain loop's), which keeps the file small.  Per slot the replica
records:
``kind`` (0 decoded, 1 concealed, 3 the zeros of a lane that has decoded
nothing, 4 the LBRR frame decoded in its place, 5 a DTX frame concealed),
``range`` (the decoder's ``rangeFinal`` after the slot: 0 after a
concealment) and ``loss_cnt`` (the SILK channel's ``lossCnt`` after it).
The tool stops unless the replica's int16 equals opus_demo's.  The SILK
mode's ``-dred`` loop (opus_demo's random models; these packets carry no
DRED, so every loss is concealed classically when its run ends) is
checked equal to the plain loop's output.

Snapshots of the scalar SILK channel state (``SNAP_FIELDS``) before and
after chosen slots of the SILK loops (``snap_where`` [S, 3]: loop (0
plain, 1 -inbandfec), lane, slot) hold the module tests: every concealed
and DTX slot of the lanes ``SNAP_LANES`` and the first decoded frame
after each of their runs and every slot of DTX lane 6 (plain loop), the
LBRR slots of
``FEC_SNAP_LANES`` (-inbandfec), and
the 16 kHz frame each returned (``snap_xq`` [S, 320], after the comfort
noise and the glue).

``celt_dtx_*``: the DTX repair's reference on CELT lanes: two streams of
tests/data/torch_sim_loss.npz (DRED stripped) with a TOC-only packet put
in at frames ``CELT_DTX_AT``, through opus_demo's plain loop (its int16
``celt_dtx_out16``, flags ``celt_dtx_lost``).

Run from the repository root (~3 min, 8 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_silk_plc_fixture.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import struct
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_silk_plc.npz")
SIM_FIXTURE = os.path.join(REPO, "tests", "data", "torch_sim_loss.npz")
STREAMS, FRAMES, FRAME = 8, 16, 960
SILK_CONFIG, HYB_CONFIG = 9, 15
DTX_LANES = (6, 7)
SNAP_LANES = (2, 3, 6)
FEC_SNAP_LANES = (0, 1, 2, 3)
CELT_DTX_LANES = (1, 4)
CELT_DTX_AT = ((5, 9), (2, 3))
CELT_DTX_FRAMES = 12
SNAP_FIELDS = (
    "exc_Q14", "sLPC_Q14_buf", "outBuf", "lagPrev", "lossCnt",
    "prevSignalType", "first_frame_after_reset", "prev_gain_Q16",
    "LastGainIndex", "prevNLSF_Q15", "plc_pitchL_Q8", "plc_LTPCoef_Q14",
    "plc_prevLPC_Q12", "plc_prevLTP_scale_Q14", "plc_prevGain_Q16",
    "plc_randScale_Q14", "plc_rand_seed", "plc_conc_energy",
    "plc_conc_energy_shift", "plc_last_frame_lost", "plc_nb_subfr",
    "plc_subfr_length", "cng_exc_buf_Q14", "cng_smth_NLSF_Q15",
    "cng_synth_state", "cng_smth_Gain_Q16", "cng_rand_seed")


def lost_flags(mode: str):
    """[8, 16] bool per mode: lane 0 lost before its first packet (frames
    0-1) and at 9; 1 single losses; 2 a run of 4; 3 runs of 2 and 3; 4 a
    single loss and the last frame; 5 two runs of 2, the second to the
    end; 6 and 7 (DTX lanes in ``silk``) losses around the silent
    stretches."""
    f = np.zeros((STREAMS, FRAMES), bool)
    f[0, [0, 1, 9]] = True
    f[1, [3, 7, 12]] = True
    f[2, [4, 5, 6, 7, 13]] = True
    f[3, [2, 3, 9, 10, 11]] = True
    f[4, [5, 15]] = True
    f[5, [8, 9, 14, 15]] = True
    f[6, [2, 11, 12]] = True
    f[7, [3, 4, 5, 13]] = True
    if mode == "hyb":
        f = np.roll(f, 1, axis=0)
    return f


def _speech(n: int, fs: int, seed: int) -> np.ndarray:
    """A speech-like signal (tools/make_torch_silk_fixture.py's shape,
    with content above 8 kHz at 48 kHz for the hybrid CELT half)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = (95.0 + 17.0 * seed) * (1 + 0.1 * np.sin(
        2 * np.pi * (0.7 + 0.2 * seed) * t))
    ph = np.cumsum(f0) / fs
    amp = 0.25 + 0.05 * (seed % 4)
    sig = amp * np.sin(2 * np.pi * ph) + 0.5 * amp * np.sin(4 * np.pi * ph)
    sig *= 0.3 + 0.7 * (np.sin(2 * np.pi * 4.0 * t + seed) > -0.3)
    if fs == 48000:
        sig += 0.05 * np.sin(2 * np.pi * (9000 + 150 * seed) * t)
    sig += 0.02 * rng.standard_normal(n)
    return np.clip(sig, -1, 1)


def _signal(mode: str, lane: int, n: int, fs: int) -> np.ndarray:
    sig = _speech(n, fs, 40 + lane + (8 if mode == "hyb" else 0))
    if mode == "silk" and lane in DTX_LANES:
        # digital silence over frames 3-9 (lane 6) / 6-12 (lane 7): DTX
        # after 40 ms of inactivity
        fl = n // FRAMES
        a, b = (3, 10) if lane == 6 else (6, 13)
        sig[a * fl:b * fl] = 0.0
    return sig


def encode_stream(job):
    """One stream's 16 packets (TOC included)."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_encoder import OpusEncoder

    mode, lane = job
    t0 = time.time()
    fs = 16000 if mode == "silk" else 48000
    n = fs // 50
    enc = OpusEncoder(fs, 1, application="voip")
    enc.set_jax_nsq(False)
    enc.set_bitrate(24000 if mode == "silk" else 32000)
    enc.set_inband_fec(True)
    enc.set_packet_loss_perc(10)
    if mode == "silk":
        enc.set_bandwidth(pkt.Bandwidth.WIDEBAND)
        enc.use_dtx = lane in DTX_LANES
    else:
        enc.set_force_mode(pkt.Mode.HYBRID)
        enc.set_bandwidth(pkt.Bandwidth.FULLBAND)
    sig = _signal(mode, lane, n * FRAMES, fs)
    want = SILK_CONFIG if mode == "silk" else HYB_CONFIG
    packets = []
    for f in range(FRAMES):
        p = enc.encode(sig[f * n:(f + 1) * n], n)
        if p[0] >> 3 != want or p[0] & 7:
            raise SystemExit(f"{job} frame {f}: TOC {p[0]:#x}, expected "
                             f"configuration {want}, mono, code 0")
        packets.append(p)
    return dict(job=job, packets=packets, seconds=time.time() - t0)


def demo_loop(packets, lost, inbandfec=False, dred=False):
    """opus_demo.decode itself on each stream -> int16 [8, 16 * 960]."""
    from opus_tpu.tools import opus_demo
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, row in enumerate(packets):
            bit = os.path.join(tmp, f"s{i}.bit")
            with open(bit, "wb") as fh:
                for p in row:
                    fh.write(struct.pack(">iI", len(p), 0) + p)
            lf = os.path.join(tmp, f"s{i}.loss")
            with open(lf, "w") as fh:
                fh.write("".join(f"{int(v)}\n" for v in lost[i]))
            pcm = os.path.join(tmp, f"s{i}.pcm")
            rc = opus_demo.decode(48000, 1, bit, pcm, lossfile=lf,
                                  inbandfec=inbandfec, use_dred=dred)
            if rc != 0:
                raise SystemExit(f"opus_demo.decode stream {i}: rc {rc}")
            outs.append(np.fromfile(pcm, "<i2"))
    return np.stack(outs)


class _Spy:
    """Wraps the scalar ``ChannelState.decode_frame``: records each call's
    lost flag and whether it decoded an LBRR frame, and, when ``want`` is
    set, snapshots of the channel state before and after and the frame it
    returned."""

    def __init__(self):
        from opus_tpu.silk import decoder as sdec
        self.cls = sdec.ChannelState
        self.orig = self.cls.decode_frame
        self.calls = []
        self.want = False
        spy = self

        def hook(cs, dec, xq_out, lost_flag, cond):
            lbrr = lost_flag == 2 and cs.LBRR_flags[cs.nFramesDecoded] == 1
            before = snapshot(cs) if spy.want else None
            r = spy.orig(cs, dec, xq_out, lost_flag, cond)
            spy.calls.append(dict(flag=lost_flag, lbrr=lbrr, before=before,
                                  after=snapshot(cs) if spy.want else None,
                                  xq=np.asarray(xq_out, np.int64).copy()))
            return r
        self.cls.decode_frame = hook

    def close(self):
        self.cls.decode_frame = self.orig


def snapshot(cs) -> dict:
    out = {}
    for k in SNAP_FIELDS:
        v = getattr(cs, k)
        if k == "outBuf":
            v = v[:320]
        out[k] = np.array(v, np.int64)
    return out


def replica_loop(packets, lost, inbandfec, snaps=()):
    """opus_demo.decode's loop, one 20 ms slot a call, recording kind,
    range and lossCnt per slot; ``snaps``: (lane, slot) pairs to
    snapshot.  Returns (rec, snapshots [(lane, slot, before, after, xq)],
    int16 [8, 16 * 960])."""
    from opus_tpu.models.opus_decoder import OpusDecoder

    n, nf = lost.shape
    rec = dict(kind=np.zeros((n, nf), np.int8),
               range=np.zeros((n, nf), np.uint32),
               loss_cnt=np.zeros((n, nf), np.int16))
    pcm = np.zeros((n, nf, FRAME))
    shots = []
    spy = _Spy()
    try:
        for i in range(n):
            dec = OpusDecoder(48000, 1)

            def slot(f, fn):
                spy.want = (i, f) in snaps
                m0 = len(spy.calls)
                pcm[i, f] = fn()
                spy.want = False
                rec["range"][i, f] = dec.rangeFinal
                rec["loss_cnt"][i, f] = dec.silk.channel_state[0].lossCnt
                calls = spy.calls[m0:]
                if (i, f) in snaps and calls:
                    c = calls[-1]
                    shots.append((i, f, c["before"], c["after"], c["xq"]))
                return calls

            def conceal(f):
                calls = slot(f, lambda: dec.decode(None, FRAME))
                rec["kind"][i, f] = 1 if calls else 3
            pend = []
            for f in range(nf):
                p = packets[i][f]
                if lost[i, f]:
                    if inbandfec:
                        pend.append(f)
                    else:
                        conceal(f)
                    continue
                dtx = len(p) <= 2
                if pend:
                    for g in pend[:-1]:
                        conceal(g)
                    g = pend[-1]
                    calls = slot(g, lambda: dec.decode(p, FRAME,
                                                       decode_fec=True))
                    if not calls:
                        rec["kind"][i, g] = 3
                    elif dtx:
                        rec["kind"][i, g] = 5
                    else:
                        rec["kind"][i, g] = 4 if calls[-1]["lbrr"] else 1
                    pend = []
                calls = slot(f, lambda: dec.decode(p))
                rec["kind"][i, f] = (3 if not calls else 5) if dtx else 0
            for g in pend:
                conceal(g)
    finally:
        spy.close()
    pcm16 = np.clip(np.floor(pcm * 32768 + 0.5), -32768, 32767).astype(
        np.int16)
    return rec, shots, pcm16.reshape(n, -1)


def slot_digests(out16):
    """[8, 16, 16] uint8: each 20 ms slot's BLAKE2b-128 digest of its
    int16 samples (little-endian), the SILK loops' exact reference."""
    import hashlib
    n = out16.shape[0]
    slots = out16.astype("<i2").reshape(n, -1, FRAME)
    return np.asarray([[np.frombuffer(hashlib.blake2b(
        s.tobytes(), digest_size=16).digest(), np.uint8) for s in row]
        for row in slots])


def snap_slots(lost, packets):
    """The plain loop's snapshot slots: on SNAP_LANES every lost or DTX
    slot and the first decoded slot after each run, and every slot of
    DTX lane 6 (its inactive frames update the comfort noise)."""
    out = {(DTX_LANES[0], f) for f in range(FRAMES)}
    for i in SNAP_LANES:
        conc = [lost[i, f] or len(packets[i][f]) <= 2 for f in range(FRAMES)]
        for f in range(FRAMES):
            if conc[f] or (f > 0 and conc[f - 1]):
                out.add((i, f))
    return out


def loops(mode: str, packets):
    """One mode's plain and -inbandfec loops (and the SILK -dred check)."""
    t0 = time.time()
    lost = lost_flags(mode)
    out = {f"{mode}_lost": lost}
    snaps = snap_slots(lost, packets) if mode == "silk" else set()
    allshots = []
    for li, (name, fec) in enumerate((("plain", False), ("fec", True))):
        want = snaps if not fec else {
            (i, f) for i in range(STREAMS) for f in range(FRAMES)} \
            if mode == "silk" else set()
        rec, shots, r16 = replica_loop(packets, lost, fec, want)
        ref = demo_loop(packets, lost, inbandfec=fec)
        if not np.array_equal(r16, ref):
            bad = np.argwhere(r16 != ref)[:4].tolist()
            raise SystemExit(f"{mode} {name}: replica != opus_demo at {bad}")
        if fec:
            # the -inbandfec loop's snapshots: its LBRR slots only
            shots = [s for s in shots if rec["kind"][s[0], s[1]] == 4
                     and s[0] in FEC_SNAP_LANES]
        allshots += [(li,) + s for s in shots]
        if mode == "silk":
            out[f"{mode}_{name}_digest"] = slot_digests(ref)
        elif not fec:
            out["hyb_plain_d16"] = np.diff(ref, axis=1, prepend=0)
            plain16 = ref.astype(np.int64)
        else:
            # the CELT half conceals alike in both loops: keep the change
            # from the plain loop, small where only the SILK half differs
            out["hyb_fec_d16"] = np.diff(ref - plain16, axis=1,
                                         prepend=0).astype(np.int16)
        for k, v in rec.items():
            out[f"{mode}_{name}_{k}"] = v
        kind = rec["kind"]
        print(f"{mode} {name}: kinds "
              f"{ {k: int((kind == k).sum()) for k in range(6)} }",
              flush=True)
    if mode == "silk":
        dred = demo_loop(packets, lost, dred=True)
        if not np.array_equal(slot_digests(dred), out["silk_plain_digest"]):
            raise SystemExit("silk -dred (no DRED in the packets) != plain")
        out["snap_where"] = np.asarray([s[:3] for s in allshots], np.int16)
        out["snap_xq"] = np.stack([s[5] for s in allshots]).astype(np.int16)
        for k in SNAP_FIELDS:
            for j, tag in ((3, "before"), (4, "after")):
                out[f"snap_{tag}_{k}"] = np.stack(
                    [s[j][k] for s in allshots]).astype(np.int32)
    print(f"{mode} loops: {time.time() - t0:.1f} s", flush=True)
    return out


def celt_dtx():
    """The CELT DTX reference: two sim_loss streams, DRED stripped, a
    TOC-only packet at CELT_DTX_AT, through opus_demo's plain loop."""
    from opus_tpu.bitstream import packet as pkt
    sfx = np.load(SIM_FIXTURE)
    rows, lost = [], np.zeros((len(CELT_DTX_LANES), CELT_DTX_FRAMES), bool)
    for j, i in enumerate(CELT_DTX_LANES):
        row = []
        for f in range(CELT_DTX_FRAMES):
            p = bytes(sfx["packets"][i, f, :sfx["packet_lens"][i, f]])
            p = bytes([p[0] & 0xFC]) + bytes(pkt.packet_parse(p).frames[0])
            row.append(p[:1] if f in CELT_DTX_AT[j] else p)
        rows.append(row)
    lost[0, [2, 7]] = True
    lost[1, [6]] = True
    width = max(len(p) for r in rows for p in r)
    buf = np.zeros((len(rows), CELT_DTX_FRAMES, width), np.uint8)
    lens = np.zeros((len(rows), CELT_DTX_FRAMES), np.int32)
    for j, r in enumerate(rows):
        for f, p in enumerate(r):
            buf[j, f, :len(p)] = np.frombuffer(p, np.uint8)
            lens[j, f] = len(p)
    return dict(celt_dtx_packets=buf, celt_dtx_lens=lens,
                celt_dtx_lost=lost,
                celt_dtx_out16=demo_loop(rows, lost))


def _job(job):
    if job[0] == "enc":
        return encode_stream(job[1:])
    if job[0] == "celt_dtx":
        return celt_dtx()
    return loops(job[1], job[2])


def pack(mode, rows):
    width = max(len(p) for r in rows for p in r)
    buf = np.zeros((STREAMS, FRAMES, width), np.uint8)
    lens = np.zeros((STREAMS, FRAMES), np.int32)
    for i, r in enumerate(rows):
        for f, p in enumerate(r):
            buf[i, f, :len(p)] = np.frombuffer(p, np.uint8)
            lens[i, f] = len(p)
    return {f"{mode}_packets": buf, f"{mode}_lens": lens}


def main():
    t0 = time.time()
    arrays = {}
    with mp.get_context("spawn").Pool(8) as pool:
        enc = pool.map(_job, [("enc", m, i) for m in ("silk", "hyb")
                              for i in range(STREAMS)], chunksize=1)
        print(f"encoded in {time.time() - t0:.1f} s (longest stream "
              f"{max(r['seconds'] for r in enc):.1f} s)", flush=True)
        rows = {m: [r["packets"] for r in enc if r["job"][0] == m]
                for m in ("silk", "hyb")}
        for m in ("silk", "hyb"):
            ps = rows[m]
            lbrr = sum(1 for r in ps for p in r if len(p) > 2 and p[1] & 0x40)
            dtx = sum(1 for r in ps for p in r if len(p) <= 2)
            print(f"{m}: {lbrr} packets with LBRR, {dtx} DTX packets, "
                  f"lengths {min(len(p) for r in ps for p in r)}-"
                  f"{max(len(p) for r in ps for p in r)}", flush=True)
            arrays.update(pack(m, ps))
        parts = pool.map(_job, [("loops", "silk", rows["silk"]),
                                ("loops", "hyb", rows["hyb"]),
                                ("celt_dtx",)], chunksize=1)
    for p in parts:
        arrays.update(p)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes, "
          f"{len(arrays['snap_where'])} snapshots, in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
