"""Writes tests/data/torch_opus_stereo.npz: the JAX package's scalar
``OpusDecoder`` at one and at two output channels over stereo, mixed
mono/stereo and 40/60 ms SILK streams, the reference of the port's
``BatchedOpusDecoder(channels=1|2)`` (tests/test_torch_opus_stereo.py,
chip_smoke.py's opus_stereo phase).  It reads opus_tpu and never edits
it.

Eight streams of seeded 48 kHz audio are encoded with the scalar
``OpusEncoder`` (``set_jax_nsq(False)``: the numpy NSQ), each by its
schedule (``SCHEDULES``): the forced mode, bandwidth, bitrate, frame size
and the encoder's ``force_channels`` (its OPUS_SET_FORCE_CHANNELS field;
there is no setter), with in-band FEC on where a segment asks for it
(``set_inband_fec``, ``set_packet_loss_perc``).  The streams cover:

- 0-2: mono SILK NB, MB and WB at 40 and 60 ms (TOC configurations 2, 3,
  6, 7, 10, 11) with LBRR frames inside the packets;
- 3: stereo CELT FB at 2.5, 5, 10 and 20 ms at a high rate (dual stereo);
- 4: stereo CELT at a low rate (intensity stereo) at the same sizes;
- 5: stereo SILK WB at 20, 40 and 60 ms, the right channel a copy of the
  left over stretches (mid-only frames), with LBRR frames;
- 6: stereo hybrid SWB and FB at 10 and 20 ms;
- 7: one stream that switches between stereo and mono packets across
  CELT, SILK and hybrid.

About one packet in seven (``LOSS_RATE``, a seeded draw, never a
stream's first) is lost.  The decode loop is opus_demo's ``-inbandfec``
one: a lost packet whose successor exists is covered by the successor's
in-band FEC (``decode_fec`` with the lost duration), else concealed;
then the successor decodes as usual.  Each step (``ops``) is decoded by
``OpusDecoder(48000, 1)`` and ``OpusDecoder(48000, 2)``.

Stored per stream s and step t (ragged, padded): ``packets`` uint8 [S,
T, MAXLEN] and ``plen`` [S, T] (-1: lost, -2: past the stream's end),
``fec`` [S, T] (decode the packet's FEC), ``fsize`` [S, T] (the
frame_size argument, 0: the default); per channel count c in (1, 2):
``rng{c}`` [S, T], ``nsamp{c}`` [S, T] (samples per channel),
``celt{c}`` [S, T] (the scalar CELT decoder's calls during the step: 0
means the output is SILK's int16 / 32768 exactly), ``pcm{c}`` (float32,
the steps' interleaved outputs in a row) and ``off{c}`` [S, T].  The
report printed at the end counts what the fixture exercises and stops
unless each of the above occurs.

Run from the repository root (~1 min, 8 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_opus_stereo_fixture.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_opus_stereo.npz")
FS = 48000
LOSS_RATE = 1 / 7
LOSS_SEED = 17

# one schedule a stream: segments (packets, mode, bandwidth, frame ms,
# bitrate, force_channels, in-band FEC); mode c/s/h, bandwidth n/m/w/s/f
SCHEDULES = {
    0: [(4, "s", "n", 40, 10000, 1, 1), (3, "s", "n", 60, 10000, 1, 1),
        (2, "s", "n", 20, 10000, 1, 1)],
    1: [(3, "s", "m", 60, 12000, 1, 1), (4, "s", "m", 40, 12000, 1, 1)],
    2: [(3, "s", "w", 40, 14000, 1, 1), (3, "s", "w", 60, 14000, 1, 1),
        (2, "s", "w", 20, 14000, 1, 1), (2, "s", "w", 40, 14000, 1, 1)],
    3: [(3, "c", "f", 20, 160000, 2, 0), (2, "c", "f", 10, 160000, 2, 0),
        (2, "c", "f", 5, 160000, 2, 0), (3, "c", "f", 2.5, 160000, 2, 0)],
    4: [(3, "c", "f", 20, 32000, 2, 0), (2, "c", "f", 10, 32000, 2, 0),
        (3, "c", "s", 5, 40000, 2, 0), (3, "c", "f", 2.5, 48000, 2, 0)],
    5: [(4, "s", "w", 20, 32000, 2, 1), (3, "s", "w", 40, 32000, 2, 1),
        (3, "s", "w", 60, 32000, 2, 1), (3, "s", "w", 20, 32000, 2, 1)],
    6: [(3, "h", "s", 20, 40000, 2, 1), (3, "h", "f", 20, 48000, 2, 1),
        (3, "h", "f", 10, 48000, 2, 0), (2, "h", "s", 10, 40000, 2, 0)],
    # the encoder picks mono under its stereo rate threshold even with
    # force_channels=1 asked, so the mono segments run at low rates
    7: [(3, "c", "f", 20, 64000, 2, 0), (3, "c", "f", 20, 16000, 1, 0),
        (3, "s", "w", 20, 28000, 2, 1), (3, "s", "w", 20, 12000, 1, 1),
        (3, "h", "f", 20, 48000, 2, 0), (3, "h", "f", 20, 20000, 1, 0),
        (3, "c", "f", 10, 64000, 2, 0)],
}
MODES = dict(c="CELT_ONLY", s="SILK_ONLY", h="HYBRID")
BWS = dict(n="NARROWBAND", m="MEDIUMBAND", w="WIDEBAND",
           s="SUPERWIDEBAND", f="FULLBAND")
MID_ONLY_STREAM = 5


def _signal(stream: int, n: int) -> np.ndarray:
    """Seeded two-channel audio [n, 2]: a gliding two-harmonic voice with
    syllable gating on the left, the same voice delayed and filtered plus
    another tone on the right (a copy of the left over alternate 200 ms
    stretches on MID_ONLY_STREAM), and high-band content on both."""
    rng = np.random.default_rng(300 + stream)
    t = np.arange(n) / FS
    f0 = (110.0 + 11.0 * stream) * (1 + 0.1 * np.sin(
        2 * np.pi * (0.6 + 0.1 * stream) * t))
    ph = np.cumsum(f0) / FS
    voice = 0.3 * np.sin(2 * np.pi * ph) + 0.12 * np.sin(4 * np.pi * ph)
    voice = voice * (0.3 + 0.7 * (np.sin(2 * np.pi * 3.0 * t + stream)
                                  > -0.4))
    left = voice + 0.04 * np.sin(2 * np.pi * (7000 + 200 * stream) * t) \
        + 0.02 * rng.standard_normal(n)
    right = 0.6 * np.roll(voice, 37) \
        + 0.15 * np.sin(2 * np.pi * (330 + 20 * stream) * t + 1.0) \
        + 0.03 * np.sin(2 * np.pi * (9500 - 150 * stream) * t) \
        + 0.02 * rng.standard_normal(n)
    if stream == MID_ONLY_STREAM:
        copy = (np.floor(t / 0.2) % 2) == 1
        right = np.where(copy, left, right)
    return np.clip(np.stack([left, right], 1), -1, 1)


def encode_stream(stream: int):
    """One stream's packets (TOC included) by its schedule."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_encoder import OpusEncoder

    sched = SCHEDULES[stream]
    n_tot = sum(int(seg[0] * seg[3] * FS / 1000) for seg in sched)
    sig = _signal(stream, n_tot)
    enc = OpusEncoder(FS, 2, application="audio" if stream in (3, 4)
                      else "voip")
    enc.set_jax_nsq(False)
    pos = 0
    packets = []
    for count, mode, bw, ms, rate, chans, fec in sched:
        enc.set_force_mode(getattr(pkt.Mode, MODES[mode]))
        enc.set_bandwidth(getattr(pkt.Bandwidth, BWS[bw]))
        enc.set_bitrate(rate)
        enc.force_channels = chans
        enc.set_inband_fec(fec)
        enc.set_packet_loss_perc(20 if fec else 0)
        n = int(ms * FS / 1000)
        for _ in range(count):
            p = enc.encode(sig[pos:pos + n].reshape(-1), n)
            pos += n
            packets.append(bytes(p))
    return packets


def plan(stream: int, packets):
    """opus_demo's -inbandfec loop over the packets with seeded loss:
    steps (packet or None, fec, frame_size)."""
    rng = np.random.default_rng(LOSS_SEED + stream)
    lost = rng.random(len(packets)) < LOSS_RATE
    lost[0] = False
    from opus_tpu.bitstream import packet as pkt
    ops = []
    last = 0
    for t, p in enumerate(packets):
        if not lost[t]:
            ops.append((p, False, 0))
            last = pkt.packet_get_samples_per_frame(p, FS) \
                * pkt.packet_parse(p).count
            continue
        nxt = t + 1 < len(packets) and not lost[t + 1]
        if nxt:
            ops.append((packets[t + 1], True, last))
        else:
            ops.append((None, False, last))
    return ops


def decode_stream(job):
    """The scalar decoder at channels c over one stream's steps, its CELT
    calls counted; the mid-only flags it reads counted too."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.silk import api as silk_api

    stream, ops, c = job
    t0 = time.time()
    dec = OpusDecoder(FS, c)
    calls = [0]
    mid_only = [0]
    celt_dec = dec.celt.decode_with_ec

    def spy_celt(*a, **kw):
        calls[0] += 1
        return celt_dec(*a, **kw)
    dec.celt.decode_with_ec = spy_celt
    real_mo = silk_api.stereo_decode_mid_only

    def spy_mo(rd):
        v = real_mo(rd)
        mid_only[0] += v
        return v
    silk_api.stereo_decode_mid_only = spy_mo
    pcm, rng, nsamp, celt = [], [], [], []
    try:
        for p, fec, fsz in ops:
            calls[0] = 0
            out = np.asarray(dec.decode(p, fsz or None, decode_fec=fec),
                             np.float32).reshape(-1)
            pcm.append(out)
            rng.append(dec.rangeFinal)
            nsamp.append(len(out) // c)
            celt.append(calls[0])
    finally:
        silk_api.stereo_decode_mid_only = real_mo
    return dict(stream=stream, c=c, pcm=pcm, rng=rng, nsamp=nsamp,
                celt=celt, mid_only=mid_only[0], seconds=time.time() - t0)


def _silk_header_lbrr(p) -> int:
    """The LBRR flags in a SILK or hybrid packet's frames' headers."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.bitstream.range_coder import make_range_decoder

    if pkt.packet_get_mode(p) == pkt.Mode.CELT_ONLY:
        return 0
    nch = pkt.packet_get_nb_channels(p)
    ms = pkt.packet_get_samples_per_frame(p, FS) * 1000 // FS
    nfr = max(1, ms // 20)
    got = 0
    for f in pkt.packet_parse(p).frames:
        if len(f) <= 1:
            continue
        rd = make_range_decoder(f)
        for _n in range(nch):
            for _i in range(nfr):
                rd.dec_bit_logp(1)
            got += rd.dec_bit_logp(1)
    return got


def report(streams, ops, res) -> list:
    from opus_tpu.bitstream import packet as pkt

    configs, stereo_cfg, mono_cfg = set(), set(), set()
    lbrr_long = lbrr_stereo = 0
    switch = False
    for s, row in enumerate(streams):
        chans = []
        for p in row:
            cfg = p[0] >> 3
            configs.add(cfg)
            ch = pkt.packet_get_nb_channels(p)
            (stereo_cfg if ch == 2 else mono_cfg).add(cfg)
            if not chans or chans[-1] != ch:
                chans.append(ch)
            lb = _silk_header_lbrr(p)
            if cfg in (2, 3, 6, 7, 10, 11):
                lbrr_long += lb
            if ch == 2:
                lbrr_stereo += lb
        switch |= len(chans) >= 3
    fec = sum(o[1] for row in ops for o in row)
    lost = sum(o[0] is None for row in ops for o in row)
    mid_only = sum(r["mid_only"] for r in res if r["c"] == 2)
    print(f"TOC configurations: {sorted(configs)}")
    print(f"stereo: {sorted(stereo_cfg)}; mono: {sorted(mono_cfg)}")
    print(f"LBRR flags in 40/60 ms packets: {lbrr_long}, in stereo "
          f"packets: {lbrr_stereo}; FEC steps {fec}, concealed {lost}; "
          f"mid-only frames {mid_only}; a stereo <-> mono switch: {switch}")
    missing = [f"config {c}" for c in (2, 3, 6, 7, 10, 11)
               if c not in configs]
    missing += [f"stereo config {c}" for c in (9, 10, 11, 12, 13, 14, 15,
                                               28, 29, 30, 31)
                if c not in stereo_cfg]
    missing += ["LBRR in 40/60 ms"] if not lbrr_long else []
    missing += ["LBRR in stereo"] if not lbrr_stereo else []
    missing += ["FEC steps"] if not fec else []
    missing += ["concealment"] if not lost else []
    missing += ["mid-only frames"] if not mid_only else []
    missing += ["stereo <-> mono switch"] if not switch else []
    return missing


def main():
    t0 = time.time()
    n = len(SCHEDULES)
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(8, n)) as pool:
        streams = pool.map(encode_stream, range(n))
        ops = [plan(s, streams[s]) for s in range(n)]
        res = pool.map(decode_stream, [(s, ops[s], c) for c in (1, 2)
                                       for s in range(n)])
    missing = report(streams, ops, res)
    t_n = max(len(o) for o in ops)
    maxlen = max(len(p) for row in streams for p in row)
    packets = np.zeros((n, t_n, maxlen), np.uint8)
    plen = np.full((n, t_n), -2, np.int64)
    fec = np.zeros((n, t_n), bool)
    fsize = np.zeros((n, t_n), np.int64)
    for s, row in enumerate(ops):
        for t, (p, f, fsz) in enumerate(row):
            if p is None:
                plen[s, t] = -1
            else:
                plen[s, t] = len(p)
                packets[s, t, :len(p)] = np.frombuffer(p, np.uint8)
            fec[s, t], fsize[s, t] = f, fsz
    out = dict(packets=packets, plen=plen, fec=fec, fsize=fsize)
    for c in (1, 2):
        rng = np.zeros((n, t_n), np.int64)
        ns = np.zeros((n, t_n), np.int64)
        celt = np.zeros((n, t_n), np.int64)
        off = np.zeros((n, t_n), np.int64)
        pcm = []
        pos = 0
        for r in res:
            if r["c"] != c:
                continue
            s = r["stream"]
            for t in range(len(r["pcm"])):
                rng[s, t], ns[s, t], celt[s, t] = (r["rng"][t],
                                                   r["nsamp"][t],
                                                   r["celt"][t])
                off[s, t] = pos
                pcm.append(r["pcm"][t])
                pos += len(r["pcm"][t])
        out.update({f"rng{c}": rng, f"nsamp{c}": ns, f"celt{c}": celt,
                    f"off{c}": off, f"pcm{c}": np.concatenate(pcm)})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.time() - t0:.1f} s; decode seconds "
          f"{[round(r['seconds'], 1) for r in res]}")
    if missing:
        raise SystemExit(f"missing: {missing}")


if __name__ == "__main__":
    main()
