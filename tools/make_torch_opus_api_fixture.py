"""Writes tests/data/torch_opus_api.npz: the JAX package's scalar
``OpusDecoder`` over mixed mono streams, the reference of the port's
top-level decoder (opus_tpu_torch/models/opus_decoder.py
``BatchedOpusDecoder``; tests/test_torch_opus_decoder.py, chip_smoke.py's
opus_api phase).  It reads opus_tpu and never edits it.

Eight streams of 48 kHz mono audio (speech-like or music-like, seeded)
are encoded with the scalar ``OpusEncoder`` (``set_jax_nsq(False)``: the
numpy NSQ) while each stream's schedule (``SCHEDULES``) switches the
forced mode, the bandwidth, the bitrate and the frame size mid-stream.
The encoder's own mode-transition logic puts in the redundancy frames
(CELT -> SILK/hybrid and SILK/hybrid -> CELT at 10/20 ms) and leaves
them out when it switches to CELT at 2.5/5 ms.  Stream 5 has DTX on
over a stretch of digital silence.  Runs of one-frame packets of one
TOC configuration are then merged (``MERGES``) by the JAX
``Repacketizer`` into code 1, 2 and 3 packets, some padded.  Then about
one packet in ten (``LOSS_RATE``, a seeded draw, never a stream's first)
is set to None, and each stream is decoded by ``OpusDecoder(48000, 1)``.

Stored per stream and packet (``P`` packets a stream, ragged):
``packets`` (uint8 [S, P, MAXLEN]) and ``plen`` [S, P] (-1: lost),
``rng`` [S, P] (``rangeFinal`` after the packet), ``nsamp`` [S, P]
(samples it returned), ``celt_calls`` [S, P] (the scalar CELT decoder's
calls during it: 0 means its output is SILK's int16 / 32768, exactly)
and ``pcm`` (float32, the packets' outputs in a row, ``pcm_off`` [S, P]
their offsets).  ``kinds`` [S, P] codes what the packet exercised (bit
flags, ``KIND_*``); the report printed at the end counts each one and
stops unless every in-scope TOC configuration, codes 0-3, padding, both
redundancy directions, a transition without redundancy, the hybrid ->
SILK fade, an NB <-> MB <-> WB switch, a frame-size switch on one
stream, DTX and loss occur.

Run from the repository root (~10 s, 8 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_opus_api_fixture.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_opus_api.npz")
FS = 48000
STREAMS = 8
LOSS_RATE = 0.1
LOSS_SEED = 16
DTX_STREAM = 5

# what a packet exercised (bit flags of ``kinds``)
KIND_LOST = 1
KIND_DTX = 2
KIND_RED_C2S = 4          # a CELT -> SILK redundant frame decoded
KIND_RED_S2C = 8          # a SILK -> CELT redundant frame decoded
KIND_TRANSITION = 16      # a transition concealment (no redundancy)
KIND_FADE = 32            # the hybrid -> SILK 2.5 ms silence frame
KIND_MULTI = 64           # a packet of 2 or more frames

# one schedule a stream: segments (packets, mode, bandwidth, frame ms,
# bitrate); mode c/s/h: CELT-only, SILK-only, hybrid; bandwidth n/m/w/s/f
SCHEDULES = {
    # frame sizes on one stream, CELT FB: 20 -> 10 -> 5 -> 2.5 -> 20 ms,
    # then into hybrid and back
    0: [(3, "c", "f", 20, 64000), (3, "c", "f", 10, 64000),
        (3, "c", "f", 5, 64000), (4, "c", "f", 2.5, 64000),
        (3, "c", "f", 20, 48000), (4, "h", "f", 20, 32000),
        (4, "c", "f", 20, 64000), (3, "c", "f", 10, 64000)],
    # CELT NB / WB / SWB at every frame size
    1: [(2, "c", "n", 2.5, 32000), (2, "c", "n", 5, 32000),
        (2, "c", "n", 10, 32000), (2, "c", "n", 20, 32000),
        (2, "c", "w", 2.5, 48000), (2, "c", "w", 5, 48000),
        (2, "c", "w", 10, 48000), (2, "c", "w", 20, 48000),
        (2, "c", "s", 2.5, 48000), (2, "c", "s", 5, 48000),
        (2, "c", "s", 10, 48000), (2, "c", "s", 20, 48000)],
    # SILK NB <-> MB <-> WB at 20 and 10 ms
    2: [(3, "s", "n", 20, 12000), (3, "s", "m", 20, 16000),
        (3, "s", "w", 20, 20000), (3, "s", "n", 10, 12000),
        (3, "s", "m", 10, 16000), (3, "s", "w", 10, 20000),
        (3, "s", "m", 20, 16000), (3, "s", "w", 20, 24000)],
    # hybrid SWB / FB at 20 and 10 ms, hybrid -> SILK (the fade), back
    3: [(3, "h", "s", 20, 24000), (3, "h", "s", 10, 24000),
        (3, "h", "f", 10, 32000), (3, "h", "f", 20, 32000),
        (4, "s", "w", 20, 20000), (4, "h", "f", 20, 32000),
        (3, "s", "w", 10, 20000)],
    # SILK -> CELT at 5 and 2.5 ms (no redundancy), CELT -> SILK
    4: [(4, "s", "w", 20, 20000), (3, "c", "f", 5, 64000),
        (4, "s", "w", 20, 20000), (3, "c", "f", 2.5, 64000),
        (4, "s", "n", 10, 12000), (3, "c", "w", 20, 48000),
        (3, "s", "m", 20, 16000)],
    # SILK-WB with DTX over digital silence, then hybrid and CELT
    5: [(10, "s", "w", 20, 20000), (4, "h", "s", 20, 24000),
        (4, "c", "s", 10, 48000), (4, "h", "f", 20, 32000)],
    # music: CELT and hybrid, hybrid -> CELT at 10 ms, CELT at 2.5 ms
    6: [(3, "c", "f", 20, 96000), (3, "h", "f", 20, 40000),
        (3, "c", "f", 10, 96000), (3, "h", "s", 10, 32000),
        (4, "c", "s", 2.5, 64000), (3, "h", "f", 20, 40000),
        (3, "s", "w", 20, 24000), (3, "h", "f", 10, 40000)],
    # speech: SILK / hybrid / CELT turns, 10 ms hybrid to 5 ms CELT
    7: [(3, "s", "w", 20, 24000), (3, "h", "f", 20, 32000),
        (3, "h", "f", 10, 32000), (3, "c", "f", 5, 64000),
        (3, "s", "n", 20, 12000), (3, "h", "s", 20, 24000),
        (3, "c", "n", 20, 32000), (3, "s", "w", 10, 20000)],
}
MUSIC = (1, 6)
# merges: (stream, first packet, frames, pad bytes) -- consecutive
# one-frame packets of one TOC configuration into one code 1/2/3 packet
MERGES = [(0, 0, 3, 0), (0, 4, 2, 0), (0, 7, 2, 0), (0, 10, 3, 9),
          (0, 13, 2, 0), (0, 17, 2, 0), (0, 21, 3, 0), (0, 24, 2, 0),
          (1, 0, 2, 0), (1, 2, 2, 0), (1, 8, 2, 4), (1, 16, 2, 0),
          (1, 22, 2, 0), (2, 1, 2, 0), (2, 9, 3, 0), (2, 13, 2, 0),
          (3, 1, 2, 0), (3, 3, 3, 5), (3, 9, 3, 0), (3, 13, 2, 0),
          (4, 4, 2, 0), (4, 11, 3, 0), (4, 19, 2, 0), (5, 4, 2, 0),
          (5, 10, 2, 0), (5, 15, 3, 0), (6, 3, 3, 0), (6, 7, 2, 0),
          (6, 12, 4, 0), (6, 19, 2, 0), (7, 3, 2, 0), (7, 6, 3, 0),
          (7, 16, 2, 0), (7, 19, 2, 0)]
MODES = dict(c="CELT_ONLY", s="SILK_ONLY", h="HYBRID")
BWS = dict(n="NARROWBAND", m="MEDIUMBAND", w="WIDEBAND",
           s="SUPERWIDEBAND", f="FULLBAND")


def _signal(stream: int, n: int) -> np.ndarray:
    """Seeded speech-like (a gliding two-harmonic tone with syllable
    gating and high-band content) or music-like (chords and noise)
    audio at 48 kHz; stream DTX_STREAM has digital silence over packets
    3-8."""
    rng = np.random.default_rng(100 + stream)
    t = np.arange(n) / FS
    if stream in MUSIC:
        sig = sum(0.12 * np.sin(2 * np.pi * f * t + k)
                  for k, f in enumerate((220.0, 277.2, 329.6, 440.0,
                                         1318.5, 5274.0)))
        sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 1.3 * t))
        sig = sig + 0.03 * rng.standard_normal(n)
    else:
        f0 = (100.0 + 13.0 * stream) * (1 + 0.1 * np.sin(
            2 * np.pi * (0.7 + 0.1 * stream) * t))
        ph = np.cumsum(f0) / FS
        sig = 0.3 * np.sin(2 * np.pi * ph) + 0.15 * np.sin(4 * np.pi * ph)
        sig = sig * (0.3 + 0.7 * (np.sin(2 * np.pi * 4.0 * t + stream)
                                  > -0.3))
        sig = sig + 0.04 * np.sin(2 * np.pi * (9000 + 300 * stream) * t) \
            + 0.02 * rng.standard_normal(n)
    sig = np.clip(sig, -1, 1)
    if stream == DTX_STREAM:
        sig[3 * 960:9 * 960] = 0.0
    return sig


def encode_stream(stream: int):
    """One stream's one-frame packets (TOC included) by its schedule."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_encoder import OpusEncoder

    sched = SCHEDULES[stream]
    n_tot = sum(int(c * ms * FS / 1000) for c, _m, _b, ms, _r in sched)
    sig = _signal(stream, n_tot)
    app = "audio" if stream in MUSIC else "voip"
    enc = OpusEncoder(FS, 1, application=app)
    enc.set_jax_nsq(False)
    enc.use_dtx = stream == DTX_STREAM
    pos = 0
    packets = []
    for count, mode, bw, ms, rate in sched:
        enc.set_force_mode(getattr(pkt.Mode, MODES[mode]))
        enc.set_bandwidth(getattr(pkt.Bandwidth, BWS[bw]))
        enc.set_bitrate(rate)
        n = int(ms * FS / 1000)
        for _ in range(count):
            p = enc.encode(sig[pos:pos + n], n)
            pos += n
            packets.append(bytes(p))
    return packets


def merge(packets, merges):
    """Applies ``merges`` of one stream (first packet, frames, pad) with
    the JAX repacketizer; returns the new packet list."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.bitstream.repacketizer import Repacketizer

    out = []
    plan = {a: (k, pad) for a, k, pad in merges}
    i = 0
    while i < len(packets):
        if i not in plan:
            out.append(packets[i])
            i += 1
            continue
        k, pad = plan[i]
        group = packets[i:i + k]
        if len({p[0] >> 2 for p in group}) != 1 or min(map(len, group)) < 3:
            raise SystemExit(f"merge at {i}: packets of several TOC "
                             f"configurations or DTX: "
                             f"{[hex(p[0]) for p in group]}")
        rp = Repacketizer()
        for p in group:
            if rp.cat(p) < 0:
                raise SystemExit(f"merge at {i}: repacketizer refused")
        m = bytes(rp.out_range(0, k))
        if pad:
            m = bytes(pkt.packet_pad(m, len(m) + pad))
        out.append(m)
        i += k
    return out


def decode_stream(job):
    """The scalar decoder over one stream's packets (None: lost), with
    the CELT decoder's and the SILK decoder's calls spied on."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.silk.tables import FLAG_PACKET_LOST

    stream, packets = job
    t0 = time.time()
    dec = OpusDecoder(FS, 1)
    log = []
    celt_dec, celt_reset = dec.celt.decode_with_ec, dec.celt.reset
    silk_dec = dec.silk.decode

    def spy_celt(data, pcm, n, rd, accum=False, qext_payload=None):
        log.append(("celt", data, n, dec.celt.start))
        return celt_dec(data, pcm, n, rd, accum=accum,
                        qext_payload=qext_payload)

    def spy_reset():
        log.append(("reset",))
        return celt_reset()

    def spy_silk(rd, **kw):
        log.append(("silk", kw["lost_flag"] == FLAG_PACKET_LOST))
        return silk_dec(rd, **kw)

    dec.celt.decode_with_ec = spy_celt
    dec.celt.reset = spy_reset
    # OpusDecoder.decode's silk reset rebuilds the object: re-spy it
    silk_reset = dec.silk.reset

    def spy_silk_reset():
        silk_reset()
        dec.silk.decode = spy_silk
    dec.silk.reset = spy_silk_reset
    dec.silk.decode = spy_silk

    pcm, rng, nsamp, calls, kinds = [], [], [], [], []
    for p in packets:
        log.clear()
        out = np.asarray(dec.decode(p), np.float32).reshape(-1)
        pcm.append(out)
        rng.append(dec.rangeFinal)
        nsamp.append(len(out))
        calls.append(sum(1 for e in log if e[0] == "celt"))
        k = 0
        if p is None:
            k |= KIND_LOST
        else:
            from opus_tpu.bitstream import packet as pkt
            parsed = pkt.packet_parse(p)
            if parsed.count > 1:
                k |= KIND_MULTI
            if len(p) <= 2:
                k |= KIND_DTX
            for j, e in enumerate(log):
                if e[0] == "celt" and e[1] is None:
                    k |= KIND_TRANSITION if not k & KIND_DTX else 0
                if e[0] == "silk" and e[1]:
                    k |= KIND_TRANSITION if not k & KIND_DTX else 0
                if e[0] == "celt" and e[1] == b"\xff\xff" and e[2] == 120:
                    k |= KIND_FADE
                elif e[0] == "celt" and e[1] is not None and e[2] == 240 \
                        and e[3] == 0 and pkt.packet_get_mode(p) != \
                        pkt.Mode.CELT_ONLY:
                    after_reset = j > 0 and log[j - 1][0] == "reset"
                    k |= KIND_RED_S2C if after_reset else KIND_RED_C2S
        kinds.append(k)
    return dict(stream=stream, pcm=pcm, rng=rng, nsamp=nsamp, calls=calls,
                kinds=kinds, seconds=time.time() - t0)


def report(packets, res) -> list:
    """Counts of what the fixture exercises; returns what is missing."""
    from opus_tpu.bitstream import packet as pkt

    configs = set()
    codes = set()
    padded = 0
    silk_rates = {}
    size_switch = False
    for s, row in enumerate(packets):
        sizes = []
        rates = []
        for p in row:
            if p is None or len(p) <= 1:
                continue
            configs.add(p[0] >> 3)
            codes.add(p[0] & 3)
            parsed = pkt.packet_parse(p)
            padded += bool(parsed.padding) if hasattr(parsed, "padding") \
                else 0
            n = pkt.packet_get_samples_per_frame(p, FS)
            if not sizes or sizes[-1] != n:
                sizes.append(n)
            if pkt.packet_get_mode(p) == pkt.Mode.SILK_ONLY:
                bw = pkt.packet_get_bandwidth(p)
                if not rates or rates[-1] != bw:
                    rates.append(bw)
        silk_rates[s] = rates
        size_switch |= len(set(sizes)) >= 4
    kinds = np.concatenate([np.asarray(r["kinds"]) for r in res])
    counts = {name: int(((kinds & flag) != 0).sum()) for name, flag in (
        ("lost", KIND_LOST), ("dtx", KIND_DTX), ("red_c2s", KIND_RED_C2S),
        ("red_s2c", KIND_RED_S2C), ("transition", KIND_TRANSITION),
        ("fade", KIND_FADE), ("multi", KIND_MULTI))}
    in_scope = set(range(32)) - {2, 3, 6, 7, 10, 11}
    print(f"TOC configurations: {sorted(configs)}")
    print(f"codes: {sorted(codes)}, padded packets: {padded}")
    print(f"SILK bandwidth sequences: "
          f"{ {s: [int(b) for b in r] for s, r in silk_rates.items() if r} }")
    print(f"a stream with >= 4 frame sizes: {size_switch}")
    print(f"kinds: {counts}")
    missing = [f"config {c}" for c in sorted(in_scope - configs)]
    missing += [f"code {c}" for c in range(4) if c not in codes]
    missing += ["padding"] if not padded else []
    missing += ["frame-size switch"] if not size_switch else []
    nmw = any(len({int(b) for b in r}) == 3 for r in silk_rates.values())
    missing += ["NB/MB/WB switch"] if not nmw else []
    missing += [k for k, v in counts.items() if v == 0]
    bad = configs - in_scope
    missing += [f"out-of-scope config {c}" for c in sorted(bad)]
    return missing


def main() -> int:
    t0 = time.time()
    with mp.get_context("spawn").Pool(STREAMS) as pool:
        raw = pool.map(encode_stream, range(STREAMS))
    print(f"encoded in {time.time() - t0:.1f} s; packets a stream: "
          f"{[len(r) for r in raw]}")
    for s, row in enumerate(raw):
        print(f"stream {s}: " + " ".join(
            f"{p[0] >> 3}:{p[0] & 3}:{len(p)}" for p in row))
    merged = [merge(raw[s], [(a, k, pad) for ss, a, k, pad in MERGES
                             if ss == s]) for s in range(STREAMS)]
    rng = np.random.default_rng(LOSS_SEED)
    lost = [rng.random(len(row)) < LOSS_RATE for row in merged]
    for row in lost:
        row[0] = False
    packets = [[None if lost[s][i] else p for i, p in enumerate(row)]
               for s, row in enumerate(merged)]
    t1 = time.time()
    with mp.get_context("spawn").Pool(STREAMS) as pool:
        res = pool.map(decode_stream, list(enumerate(packets)))
    print(f"decoded in {time.time() - t1:.1f} s")
    missing = report(packets, res)
    if missing:
        print(f"missing: {missing}")
        return 1
    s_n = len(packets)
    p_n = max(len(r) for r in packets)
    maxlen = max(len(p) for r in packets for p in r if p is not None)
    buf = np.zeros((s_n, p_n, maxlen), np.uint8)
    plen = np.full((s_n, p_n), -2, np.int64)     # -2: past the stream
    rngs = np.zeros((s_n, p_n), np.int64)
    nsamp = np.zeros((s_n, p_n), np.int64)
    calls = np.zeros((s_n, p_n), np.int64)
    kinds = np.zeros((s_n, p_n), np.int64)
    off = np.zeros((s_n, p_n), np.int64)
    pcm = []
    pos = 0
    for s, row in enumerate(packets):
        r = res[s]
        for i, p in enumerate(row):
            if p is None:
                plen[s, i] = -1
            else:
                plen[s, i] = len(p)
                buf[s, i, :len(p)] = np.frombuffer(p, np.uint8)
            rngs[s, i] = r["rng"][i]
            nsamp[s, i] = r["nsamp"][i]
            calls[s, i] = r["calls"][i]
            kinds[s, i] = r["kinds"][i]
            off[s, i] = pos
            pcm.append(r["pcm"][i])
            pos += len(r["pcm"][i])
    np.savez_compressed(OUT, packets=buf, plen=plen, rng=rngs, nsamp=nsamp,
                        celt_calls=calls, kinds=kinds, pcm_off=off,
                        pcm=np.concatenate(pcm).astype(np.float32))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes, {pos} samples) in "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
