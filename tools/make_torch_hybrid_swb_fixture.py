"""Writes tests/data/torch_hybrid_swb20ms.npz: real superwideband hybrid
(SILK + CELT bands 17-18, end band 19) packets and the scalar decoder's
outputs for them, the packet source and oracle of the port's SWB hybrid
test and of chip_smoke.py's SWB phase.

The same as tools/make_torch_hybrid_fixture.py (whose signals it uses),
except that the bandwidth is forced to superwideband: 8 streams x 8
frames from the scalar ``OpusEncoder(48000, 1, application="voip")``
with the mode forced to hybrid:

- streams 0-3: speech-like signals with content above 8 kHz, 32 kb/s;
- stream 4: speech below 7 kHz under clicks confined to 8.1-9.4 kHz,
  24 kb/s: band 18 (10-12 kHz) is skipped and filled by folding from
  band 17, through the special hybrid fold copy;
- stream 5: the speech-like shape at 48 kb/s;
- stream 6: low speech under hard clicks above 9 kHz, 32 kb/s, so the
  CELT half codes short blocks;
- stream 7: digital silence, then noise fading in, 32 kb/s.

Per lane-frame it stores the frame's payload without the TOC byte
(``frames`` [8, 8, P] uint8, ``lens``), the scalar ``OpusDecoder``'s float
PCM (``pcm`` [8, 8, 960] float32) and its ``rangeFinal``
(``final_range``).  Every packet is checked to be superwideband hybrid,
and every lane-frame to carry no redundancy.

The encoder takes seconds a frame; the streams are encoded in 4 worker
processes.  Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_torch_hybrid_swb_fixture.py
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_hybrid_fixture import FRAME, FS, JOBS, NFRAMES, _signal  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "torch_hybrid_swb20ms.npz")


def _run(job):
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models import opus_decoder as od
    from opus_tpu.models.opus_encoder import OpusEncoder

    stream, rate, kind, seed = job
    t0 = time.time()
    enc = OpusEncoder(FS, 1, application="voip")
    enc.set_bitrate(rate)
    enc.set_force_mode(pkt.Mode.HYBRID)
    enc.set_bandwidth(pkt.Bandwidth.SUPERWIDEBAND)
    sig = _signal(kind, seed, FRAME * NFRAMES)
    packets = []
    for f in range(NFRAMES):
        p = enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME)
        assert pkt.packet_get_mode(p) == pkt.Mode.HYBRID, (job, f)
        assert pkt.packet_get_bandwidth(p) == pkt.Bandwidth.SUPERWIDEBAND, \
            (job, f)
        packets.append(p)

    coders = []
    orig = od.make_range_decoder

    def spy(frame):
        d = orig(frame)
        coders.append((d, len(frame)))
        return d

    od.make_range_decoder = spy
    try:
        dec = od.OpusDecoder(FS, 1)
        pcm, rngs, payloads = [], [], []
        for f, p in enumerate(packets):
            n0 = len(coders)
            pcm.append(np.asarray(dec.decode(p, FRAME), np.float64))
            rngs.append(dec.rangeFinal)
            # one coder for the frame; a redundancy frame would have cut
            # its storage (src/opus_decoder.c:539)
            assert len(coders) == n0 + 1, (job, f)
            d, n = coders[-1]
            assert d.storage == n, (job, f, "redundancy")
            frames = pkt.packet_parse(p).frames
            assert len(frames) == 1 and len(frames[0]) == n
            payloads.append(bytes(frames[0]))
    finally:
        od.make_range_decoder = orig
    return dict(job=job, payloads=payloads, pcm=np.stack(pcm),
                rng=np.asarray(rngs, np.uint32), seconds=time.time() - t0)


def main():
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        results = pool.map(_run, JOBS, chunksize=1)
    results.sort(key=lambda r: r["job"][0])
    p = max(len(x) for r in results for x in r["payloads"])
    frames = np.zeros((len(results), NFRAMES, p), np.uint8)
    lens = np.zeros((len(results), NFRAMES), np.int32)
    for s, r in enumerate(results):
        for f, x in enumerate(r["payloads"]):
            frames[s, f, :len(x)] = np.frombuffer(x, np.uint8)
            lens[s, f] = len(x)
    out = dict(frames=frames, lens=lens,
               pcm=np.stack([r["pcm"] for r in results]).astype(np.float32),
               final_range=np.stack([r["rng"] for r in results]),
               rates=np.asarray([j[1] for j in JOBS], np.int32))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    for r in results:
        print(f"{r['job']}: {r['seconds']:.1f} s, lens "
              f"{[len(x) for x in r['payloads']]}")
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
