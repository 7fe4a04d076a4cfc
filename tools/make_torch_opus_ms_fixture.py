"""Writes tests/data/torch_opus_ms.npz: the JAX package's multistream and
projection encoders and decoders (``opus_tpu/models/multistream.py``,
``projection.py``) on seeded audio, the reference of the port's
``BatchedOpusMSDecoder`` and ``BatchedOpusProjectionDecoder``
(tests/test_torch_opus_ms.py, chip_smoke.py's opus_ms phase).  It reads
opus_tpu and never edits it.

The cases (``CASES``), each over ``LANES`` streams of seeded audio (a
voice-like tone with syllable gating, a chord, noise and an LFE rumble,
different on every channel):

- ``hi``: ``OpusMSEncoder.create_surround(48000, 6)`` (5.1: 2 coupled +
  2 mono streams, the Vorbis mapping) at 256 kb/s, application "audio",
  20 ms frames;
- ``lo``: the same layout at 64 kb/s, application "voip";
- ``long``: 5.1 at 256 kb/s with 40 ms frames, so that the elementary
  packets the decoder rebuilds include code 1-3 ones;
- ``gap``: a stereo + mono layout whose mapping puts 255 (silence) on an
  output channel: 4 channels, streams 2, coupled 1, mapping (0, 1, 2,
  255);
- ``foa``: ``OpusProjectionEncoder(48000, 4)`` (first-order ambisonics:
  2 coupled streams) at 256 kb/s, with its demixing matrix.

Stored per case (``{case}_`` prefix): ``packets`` uint8 [L, F, MAXLEN]
and ``plen`` [L, F] (the multistream packets), ``elem`` uint8 [L, F,
streams, MAXE] and ``elen`` [L, F, streams] (the elementary packets the
JAX decoder rebuilt and handed to its elementary decoders, recorded by a
spy on them), ``modes`` [L, F, streams] (each elementary packet's mode:
1 SILK, 2 hybrid, 3 CELT), ``rng`` [L, F, streams] (each elementary
decoder's final range), ``pcm24`` int32 [L, F, N, C] (``decode24``,
computed from one ``decode`` call a frame as it computes it: the float
output to 2^-24, and ``decode_int16``'s output, FLOAT2INT16 with no soft
clip, where the float is SILK's int16 / 32768); for ``foa`` also
``internal16`` int16 [L, F, N, 4] (the internal channels quantised as
``decode_int16`` does), ``pcm16`` int16 [L, F, N, 4] (``decode_int16``'s
integer demix of them) and ``matrix`` (the demixing matrix's bytes); the
layout as ``layout`` [channels, streams, coupled] and ``mapping``.  The report printed at the
end lists the modes the JAX encoder chose and stops unless a stream's
packet of code 1-3 and a 255 mapping occur.

Run from the repository root (~1 min, 8 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_opus_ms_fixture.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_opus_ms.npz")
FS = 48000
LANES = 2
FRAMES = 6
# case: (kind, channels, bitrate, application, frame ms, frames)
CASES = {
    "hi": ("surround", 6, 256000, "audio", 20, FRAMES),
    "lo": ("surround", 6, 64000, "voip", 20, 4),
    "long": ("surround", 6, 256000, "audio", 40, 3),
    "gap": ("gap", 4, 96000, "audio", 20, 4),
    "foa": ("projection", 4, 256000, "audio", 20, FRAMES),
}
GAP_LAYOUT = (2, 1, (0, 1, 2, 255))


def signal(case: str, lane: int, channels: int, n: int) -> np.ndarray:
    """Seeded audio [n, channels]: each channel a gliding voice-like tone
    with syllable gating, a chord, noise and (the last) a low rumble."""
    seed = 500 + 10 * lane + sorted(CASES).index(case)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    out = []
    for c in range(channels):
        f0 = (120.0 + 17.0 * c + 5.0 * lane) * (1 + 0.08 * np.sin(
            2 * np.pi * (0.5 + 0.1 * c) * t))
        ph = np.cumsum(f0) / FS
        x = 0.25 * np.sin(2 * np.pi * ph) + 0.1 * np.sin(4 * np.pi * ph)
        x = x * (0.3 + 0.7 * (np.sin(2 * np.pi * 3.0 * t + c + lane) > -0.3))
        x = x + 0.05 * np.sin(2 * np.pi * (440.0 * (1 + c % 3) + 3 * lane)
                              * t) + 0.02 * rng.standard_normal(n)
        if c == channels - 1:
            x = x + 0.3 * np.sin(2 * np.pi * 45.0 * t)
        out.append(x)
    return np.clip(np.stack(out, 1), -1, 1)


def run_case(job):
    """One case on one lane: encode, then decode with the spied JAX
    decoder."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models import multistream as MS
    from opus_tpu.models import projection as PJ
    from opus_tpu.utils.soft_clip import float2int16

    case, lane = job
    kind, ch, rate, app, ms, nf = CASES[case]
    n = FS * ms // 1000
    x = signal(case, lane, ch, n * nf)
    matrix = b""
    if kind == "surround":
        enc = MS.OpusMSEncoder.create_surround(FS, ch, app)
        streams, coupled, mapping = MS.default_surround_layout(ch)
    elif kind == "gap":
        streams, coupled, mapping = GAP_LAYOUT
        enc = MS.OpusMSEncoder(FS, ch, streams, coupled, mapping, app)
    else:
        enc = PJ.OpusProjectionEncoder(FS, ch, app)
        streams, coupled = enc.streams, enc.coupled_streams
        mapping = list(range(enc.internal))
        matrix = enc.get_demixing_matrix()
    enc.set_bitrate(rate)
    packets = [bytes(enc.encode(x[f * n:(f + 1) * n].reshape(-1), n))
               for f in range(nf)]
    if kind == "projection":
        dec = PJ.OpusProjectionDecoder(FS, ch, streams, coupled, matrix)
        ms_dec = dec.ms
    else:
        dec = MS.OpusMSDecoder(FS, ch, streams, coupled, mapping)
        ms_dec = dec
    elem = []
    for s, d in enumerate(ms_dec.decoders):
        real = d.decode

        def spy(sub, *a, real=real, **kw):
            elem.append(bytes(sub))
            return real(sub, *a, **kw)
        d.decode = spy
    res = dict(elem=[], rng=[], modes=[], pcm16=[], pcm24=[], internal16=[],
               codes=[])
    for p in packets:
        elem.clear()
        if kind == "projection":
            internal = ms_dec.decode(p)
            # OpusProjectionDecoder.decode / decode_int16 on this output
            y = (internal.reshape(-1, dec.internal) @ dec.demixing.T)
            xi = float2int16(internal).astype(np.int32).reshape(
                -1, dec.internal)
            y16 = (((xi[:, None, :] * dec.demixing_int[None, :, :]
                     + 16384) >> 15).sum(axis=2).astype(np.int16))
            res["internal16"].append(xi.astype(np.int16))
        else:
            y = np.asarray(dec.decode(p)).reshape(-1, ch)
            y16 = float2int16(y)
        res["pcm16"].append(np.asarray(y16).reshape(-1, ch))
        res["pcm24"].append(np.clip(np.rint(np.asarray(y, np.float64)
                                            * 8388608.0), -(1 << 31),
                                    (1 << 31) - 1).astype(np.int32)
                            .reshape(-1, ch))
        res["elem"].append(list(elem))
        res["rng"].append([d.rangeFinal for d in ms_dec.decoders])
        res["modes"].append([int(pkt.packet_get_mode(e)) for e in elem])
        pos = 0
        for k in range(streams):
            parsed = pkt.packet_parse(p[pos:], self_delimited=k < streams - 1)
            res["codes"].append(parsed.toc & 3)
            pos += parsed.packet_offset
    return job, dict(res, packets=packets, layout=(ch, streams, coupled),
                     mapping=list(mapping), matrix=matrix)


def main() -> int:
    t0 = time.time()
    jobs = [(c, lane) for c in CASES for lane in range(LANES)]
    with mp.get_context("spawn").Pool(8) as pool:
        got = dict(pool.map(run_case, jobs))
    out = {}
    codes = set()
    gap = False
    for case in CASES:
        rows = [got[(case, lane)] for lane in range(LANES)]
        nf = CASES[case][5]
        ch, streams, coupled = rows[0]["layout"]
        maxlen = max(len(p) for r in rows for p in r["packets"])
        maxe = max(len(e) for r in rows for f in r["elem"] for e in f)
        packets = np.zeros((LANES, nf, maxlen), np.uint8)
        plen = np.zeros((LANES, nf), np.int64)
        elem = np.zeros((LANES, nf, streams, maxe), np.uint8)
        elen = np.zeros((LANES, nf, streams), np.int64)
        for i, r in enumerate(rows):
            for f in range(nf):
                p = r["packets"][f]
                packets[i, f, :len(p)] = np.frombuffer(p, np.uint8)
                plen[i, f] = len(p)
                for s, e in enumerate(r["elem"][f]):
                    elem[i, f, s, :len(e)] = np.frombuffer(e, np.uint8)
                    elen[i, f, s] = len(e)
            codes |= set(r["codes"])
        gap |= 255 in rows[0]["mapping"]
        pre = f"{case}_"
        out.update({
            pre + "packets": packets, pre + "plen": plen,
            pre + "elem": elem, pre + "elen": elen,
            pre + "modes": np.array([r["modes"] for r in rows], np.int64),
            pre + "rng": np.array([r["rng"] for r in rows], np.int64),
            pre + "pcm24": np.array([r["pcm24"] for r in rows], np.int32),
            pre + "layout": np.array(rows[0]["layout"], np.int64),
            pre + "mapping": np.array(rows[0]["mapping"], np.int64)})
        if rows[0]["matrix"]:
            out[pre + "matrix"] = np.frombuffer(rows[0]["matrix"], np.uint8)
            out[pre + "internal16"] = np.array(
                [r["internal16"] for r in rows], np.int16)
            out[pre + "pcm16"] = np.array([r["pcm16"] for r in rows],
                                          np.int16)
        modes = np.array([r["modes"] for r in rows])
        names = {1000: "SILK", 1001: "hybrid", 1002: "CELT"}
        print(f"{case}: layout {rows[0]['layout']} mapping "
              f"{rows[0]['mapping']}; modes by stream: "
              + ", ".join(f"{s}: " + "/".join(sorted(
                  {names.get(int(m), str(m)) for m in modes[:, :, s].ravel()}))
                  for s in range(streams))
              + f"; packet bytes {int(plen.min())}-{int(plen.max())}")
    missing = [] if codes - {0} else ["a code 1-3 stream packet"]
    missing += [] if gap else ["a 255 mapping"]
    print(f"the streams' packet codes in the multistream packets: "
          f"{sorted(codes)}")
    if missing:
        print(f"missing: {missing}")
        return 1
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
