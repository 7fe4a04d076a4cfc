"""Writes tests/data/torch_silk16k_24k.npz: real SILK-only packets and the
scalar decoder's outputs for them, the packet source and oracle of the
port's SILK decoder tests and of chip_smoke.py.

Main set, SILK wideband (16 kHz internal), 20 ms, mono: 8 streams x 8
frames from the scalar ``OpusEncoder(16000, 1, application="voip")``:

- streams 0-4: speech-like signals (the tests/test_fused_silk_dec.py
  ``_speechish`` shape) from their own seeds, pitches and levels, 24 kb/s;
- stream 5: the same shape at 12 kb/s;
- stream 6: 24 kb/s with in-band FEC at 20% loss, so LBRR frames occur;
- stream 7: digital silence, then noise fading in with soft bursts
  (inactive and unvoiced frames), 24 kb/s.

Per lane-frame it stores the SILK payload bytes (``frames`` [8, 8, P]
uint8) and lengths, the scalar decoder's int16 output ``xq`` [8, 8, 320]
(captured as tests/test_fused_silk_dec.py ``_scalar_frames`` does) and the
scalar range decoder's final ``rng``.  Extra sets of 3 frames each, keys
prefixed ``nb_``, ``mb_`` and ``wb10_``: NB 8 kHz at 12 kb/s, MB 12 kHz at
16 kb/s and WB with 10 ms frames at 24 kb/s, one stream each.

It also stores the JAX fused decoder's NLSF -> LPC stage on seeded NLSF
vectors (sorted, clustered, unsorted, extreme) at 16 and 8 kHz, keys
``nlsf{16,8}_*``: the input, ``_nlsf_stabilize``'s output, ``_nlsf2a``'s
coefficients and unstable flags, and ``_lpc_inverse_pred_gain`` on random
coefficients.  These paths (the stabilizer's fallback, the unstable-LPC
rounds) are rare in real packets, and the JAX functions are too slow to
run eagerly on a CPU inside a test (tens of seconds: every primitive
compiles on first use).

The encoder is slow (seconds a frame); the streams are encoded in 4
worker processes.  Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_torch_silk_fixture.py
"""

from __future__ import annotations

import os
import sys
import time
import multiprocessing

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_silk16k_24k.npz")
NSTREAMS = 8
NFRAMES = 8
NEXTRA = 3

# (name, fs, frame ms, bitrate, signal kind, seed, fec, frames)
JOBS = [("main", 16000, 20, 24000, "speech", s, False, NFRAMES)
        for s in range(5)] + [
    ("main", 16000, 20, 12000, "speech", 5, False, NFRAMES),
    ("main", 16000, 20, 24000, "speech", 6, True, NFRAMES),
    ("main", 16000, 20, 24000, "noise", 7, False, NFRAMES),
    ("nb", 8000, 20, 12000, "speech", 8, False, NEXTRA),
    ("mb", 12000, 20, 16000, "speech", 9, False, NEXTRA),
    ("wb10", 16000, 10, 24000, "speech", 10, False, NEXTRA),
]


def _signal(kind: str, seed: int, fs: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    if kind == "noise":
        # silence, then noise fading in with soft bursts (a hard onset
        # after silence needs a third pulse escape, outside the fused
        # decoders' envelope)
        sig = np.zeros(n)
        start = n // 4
        ramp = np.minimum(1.0, np.arange(n - start) / (n // 4))
        sig[start:] = 0.03 * ramp * rng.standard_normal(n - start)
        for _ in range(3):
            p0 = int(rng.integers(n // 2, n - 400))
            sig[p0:p0 + 400] += 0.08 * rng.standard_normal(400) \
                * np.hanning(400)
        return np.clip(sig, -1, 1)
    base = 95.0 + 17.0 * seed
    f0 = base * (1 + 0.1 * np.sin(2 * np.pi * (0.7 + 0.2 * seed) * t))
    ph = np.cumsum(f0) / fs
    amp = 0.25 + 0.05 * (seed % 4)
    sig = amp * np.sin(2 * np.pi * ph) + 0.5 * amp * np.sin(4 * np.pi * ph)
    sig *= 0.3 + 0.7 * (np.sin(2 * np.pi * 4.0 * t + seed) > -0.3)
    sig += 0.02 * rng.standard_normal(n)
    return np.clip(sig, -1, 1)


def _run(job):
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.bitstream.range_coder import RangeDecoder
    from opus_tpu.models.opus_encoder import OpusEncoder
    from opus_tpu.silk import decoder as sdec
    from opus_tpu.silk.api import SilkDecoder

    name, fs, ms, rate, kind, seed, fec, nfr = job
    t0 = time.time()
    n = fs * ms // 1000
    enc = OpusEncoder(fs, 1, application="voip")
    enc.set_bitrate(rate)
    want_bw = {8000: pkt.Bandwidth.NARROWBAND, 12000: pkt.Bandwidth.MEDIUMBAND,
               16000: pkt.Bandwidth.WIDEBAND}[fs]
    enc.set_bandwidth(want_bw)
    if fec:
        enc.set_inband_fec(True)
        enc.set_packet_loss_perc(20)
    sig = _signal(kind, seed, fs, n * nfr)
    payloads = []
    for f in range(nfr):
        p = enc.encode(sig[f * n:(f + 1) * n], n)
        assert pkt.packet_get_mode(p) == pkt.Mode.SILK_ONLY, (name, seed, f)
        assert pkt.packet_get_bandwidth(p) == want_bw, (name, seed, f)
        frames = pkt.packet_parse(p).frames
        assert len(frames) == 1
        payloads.append(bytes(frames[0]))

    xq, rngs = [], []
    orig = sdec.ChannelState.decode_frame

    def cap(self, dec, xq_out, lost, cond):
        r = orig(self, dec, xq_out, lost, cond)
        xq.append(np.asarray(xq_out, np.int16).copy())
        return r

    sdec.ChannelState.decode_frame = cap
    try:
        sd = SilkDecoder()
        for p in payloads:
            rd = RangeDecoder(p)
            sd.decode(rd, n_channels_api=1, n_channels_internal=1,
                      api_sample_rate=fs, internal_sample_rate=fs,
                      payload_size_ms=ms, lost_flag=0, new_packet_flag=True)
            rngs.append(rd.rng)
    finally:
        sdec.ChannelState.decode_frame = orig
    assert len(xq) == nfr
    lbrr = sum(1 for p in payloads if p and p[0] & 0x40)
    return dict(job=job, payloads=payloads, xq=np.stack(xq),
                rng=np.asarray(rngs, np.uint32), lbrr=lbrr,
                seconds=time.time() - t0)


def _nlsf_cases(fs_khz: int) -> dict:
    import jax.numpy as jnp
    from opus_tpu.models import fused_silk_dec as JF

    tabs = JF._SilkTabs(fs_khz)
    d = tabs.order
    rng = np.random.default_rng(fs_khz)
    extreme = np.tile(np.linspace(100, 32600, d).astype(np.int64), (8, 1))
    extreme[:4, :] = 32767
    extreme[4:, :d // 2] = 0
    nlsf = np.concatenate([
        np.sort(rng.integers(0, 32768, (24, d)), axis=1),
        np.sort(rng.integers(15000, 15400, (16, d)), axis=1),
        rng.integers(0, 32768, (16, d)), extreme]).astype(np.int32)
    stab = JF._nlsf_stabilize(jnp.asarray(nlsf), tabs.dmin)
    a_q12, unstable = JF._nlsf2a(tabs, stab)
    a = (rng.integers(-32768, 32768, (64, d))
         >> rng.integers(0, 6, (64, 1))).astype(np.int32)
    ok = JF._lpc_inverse_pred_gain(jnp.asarray(a), d)
    pre = f"nlsf{fs_khz}_"
    return {pre + "in": nlsf, pre + "stab": np.asarray(stab),
            pre + "a_q12": np.asarray(a_q12),
            pre + "unstable": np.asarray(unstable), pre + "lpc_a": a,
            pre + "lpc_ok": np.asarray(ok)}


def _pack(results):
    p = max(len(x) for r in results for x in r["payloads"])
    frames = np.zeros((len(results), len(results[0]["payloads"]), p),
                      np.uint8)
    lens = np.zeros(frames.shape[:2], np.int32)
    for s, r in enumerate(results):
        for f, x in enumerate(r["payloads"]):
            frames[s, f, :len(x)] = np.frombuffer(x, np.uint8)
            lens[s, f] = len(x)
    return (frames, lens, np.stack([r["xq"] for r in results]),
            np.stack([r["rng"] for r in results]))


def main():
    t0 = time.time()
    out = {}
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        pending = pool.map_async(_run, JOBS, chunksize=1)
        for fs_khz in (16, 8):
            out.update(_nlsf_cases(fs_khz))
        results = pending.get()
    for name in ("main", "nb", "mb", "wb10"):
        rs = [r for r in results if r["job"][0] == name]
        frames, lens, xq, rng = _pack(rs)
        pre = "" if name == "main" else name + "_"
        out.update({pre + "frames": frames, pre + "lens": lens,
                    pre + "xq": xq, pre + "final_range": rng})
    out["rates"] = np.asarray([j[3] for j in JOBS if j[0] == "main"],
                              np.int32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    for r in results:
        print(f"{r['job'][:7]}: {r['seconds']:.1f} s, LBRR frames "
              f"{r['lbrr']}, lens {[len(x) for x in r['payloads']]}")
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
