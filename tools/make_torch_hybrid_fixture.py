"""Writes tests/data/torch_hybrid_fb20ms.npz: real hybrid (SILK + CELT)
packets and the scalar decoder's outputs for them, the packet source and
oracle of the port's hybrid decoder tests and of chip_smoke.py.

Hybrid, fullband, 48 kHz, 20 ms, mono: 8 streams x 8 frames from the
scalar ``OpusEncoder(48000, 1, application="voip")`` with the mode forced
to hybrid and the bandwidth to fullband (as tests/test_hybrid_dec_fused.py
encodes them):

- streams 0-3: speech-like signals with content above 8 kHz (the
  ``_speechlike`` shape of tests/test_hybrid_dec_fused.py) from their own
  seeds, 32 kb/s;
- stream 4: speech below 7 kHz under clicks confined to 8.1-9.4 kHz,
  24 kb/s: nothing above band 17 (the encoder's signal bandwidth), so
  bands 18-20 are skipped and filled by folding from band 17, through the
  special hybrid fold copy;
- stream 5: the speech-like shape at 48 kb/s;
- stream 6: low speech under hard clicks above 9 kHz (decaying high-passed
  noise bursts), 32 kb/s, so the CELT half codes short blocks;
- stream 7: digital silence, then noise fading in, 32 kb/s.

Per lane-frame it stores the frame's payload without the TOC byte
(``frames`` [8, 8, P] uint8, ``lens``), the scalar ``OpusDecoder``'s float
PCM (``pcm`` [8, 8, 960] float32) and its ``rangeFinal``
(``final_range``).  Every packet is checked to be hybrid, and every
lane-frame to carry no redundancy (the decoder's range coder keeps its
whole storage).

The encoder takes seconds a frame; the streams are encoded in 4 worker
processes.  Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_torch_hybrid_fixture.py
"""

from __future__ import annotations

import os
import sys
import time
import multiprocessing

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_hybrid_fb20ms.npz")
FS = 48000
FRAME = 960
NFRAMES = 8

# (stream, bitrate, signal kind, seed)
JOBS = [(s, 32000, "speech", 7 + s) for s in range(4)] + [
    (4, 24000, "bandclicks", 21),
    (5, 48000, "speech", 12),
    (6, 32000, "clicks", 13),
    (7, 32000, "noise", 14),
]


def _speechlike(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    f0 = (100 + 7 * seed) * (1 + 0.2 * np.sin(2 * np.pi * 1.1 * t + seed))
    sig = 0.35 * np.sin(2 * np.pi * np.cumsum(f0) / FS)
    sig += 0.15 * np.sin(2 * np.pi * 3 * np.cumsum(f0) / FS + 0.4)
    # content above the 8 kHz hybrid crossover, so the CELT half codes
    # pulses and not only noise fill
    sig += 0.06 * np.sin(2 * np.pi * (9000 + 150 * seed) * t)
    sig += 0.03 * np.sin(2 * np.pi * 13700 * t)
    sig *= 1 + 0.3 * np.sin(2 * np.pi * 2.3 * t)
    sig += 0.01 * rng.standard_normal(n)
    return np.clip(sig, -1, 1)


def _band(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """x with every frequency outside [lo, hi] Hz removed."""
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / FS)
    spec[(f < lo) | (f > hi)] = 0
    return np.fft.irfft(spec, len(x))


def _clicks(n: int) -> np.ndarray:
    """Decaying envelopes, one every 700 samples from a third of a frame."""
    env = np.zeros(n)
    for p0 in range(FRAME // 3, n - 480, 700):
        env[p0:p0 + 480] = np.exp(-np.arange(480) / 60)
    return env


def _signal(kind: str, seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "speech":
        return _speechlike(n, seed)
    if kind == "bandclicks":
        t = np.arange(n) / FS
        f0 = 120 * (1 + 0.2 * np.sin(2 * np.pi * 1.1 * t))
        low = 0.35 * np.sin(2 * np.pi * np.cumsum(f0) / FS) \
            + 0.15 * np.sin(2 * np.pi * 3 * np.cumsum(f0) / FS)
        low += _band(0.02 * rng.standard_normal(n), 0, 7000)
        hf = _band(rng.standard_normal(n), 8100, 9400)
        hf /= np.abs(hf).max()
        return np.clip(0.5 * low + 0.6 * _clicks(n) * hf, -1, 1)
    if kind == "clicks":
        # hard onsets above 9 kHz (decaying high-passed noise bursts): the
        # CELT half sees transients, the SILK half little of them (a loud
        # full-band burst drives SILK's pulse coder past the two escape
        # rounds the fused decoders handle)
        sig = 0.3 * _speechlike(n, seed)
        hf = _band(rng.standard_normal(n), 9000, FS / 2)
        hf /= np.abs(hf).max()
        return np.clip(sig + 0.6 * _clicks(n) * hf, -1, 1)
    # silence, then noise fading in over 4 frames (a faster onset needs a
    # third pulse escape in the first active SILK frame)
    sig = np.zeros(n)
    start = n // 4
    ramp = np.minimum(1.0, np.arange(n - start) / (n // 2))
    sig[start:] = 0.02 * ramp * rng.standard_normal(n - start)
    return np.clip(sig, -1, 1)


def _run(job):
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models import opus_decoder as od
    from opus_tpu.models.opus_encoder import OpusEncoder

    stream, rate, kind, seed = job
    t0 = time.time()
    enc = OpusEncoder(FS, 1, application="voip")
    enc.set_bitrate(rate)
    enc.set_force_mode(pkt.Mode.HYBRID)
    enc.set_bandwidth(pkt.Bandwidth.FULLBAND)
    sig = _signal(kind, seed, FRAME * NFRAMES)
    packets = []
    for f in range(NFRAMES):
        p = enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME)
        assert pkt.packet_get_mode(p) == pkt.Mode.HYBRID, (job, f)
        assert pkt.packet_get_bandwidth(p) == pkt.Bandwidth.FULLBAND, (job, f)
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
