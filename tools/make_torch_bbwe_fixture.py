"""Writes tests/data/torch_bbwe.npz: the JAX package's neural blind
bandwidth extension (BBWE) and the scalar decoders with BBWE and OSCE at
48 kHz, the oracle of the port's BBWE tests and of chip_smoke.py's bbwe
and osce_hybrid phases.

Models: BBWE ``random_model(70)``, LACE ``random_lace_model(50)``, NoLACE
``random_nolace_model(60)``.  It stores:

- BBWE alone (``opus_tpu.dnn.bbwe.BBWE``) on 8 seeded int16 streams x 8
  frames of 320 samples: streams 0-3 speech-like tones plus noise, 4
  digital silence, 5 silence then a speech-like onset, 6 a full-scale
  square wave, 7 full-scale noise.  ``bbwe_in`` [8, 8, 320] int16, the
  features ``bbwe_feats`` [8, 8, 2, 114] f32, the conditioning vectors of
  the first COND_FRAMES frames ``bbwe_cond`` [8, 2, 4, 128] f32, the
  output ``bbwe_out`` [8, 8, 960] int16 and each frame's peak |float
  output| before clipping ``bbwe_peak`` [8, 8] f32; and the
  ``upsamp_2x`` and ``interpol_3_2`` calls of stream 0's third frame's
  first subframe (one a channel: the state before, the input, the
  float64 output): ``up2_state`` [3, 2, 3], ``up2_x`` [3, 80] f32,
  ``up2_out`` [3, 160] f64, ``ip_state`` [3, 8], ``ip_x`` [3, 160] f32,
  ``ip_out`` [3, 240] f64;
- the scalar ``SilkDecoder`` at ``api_sample_rate=48000`` on
  tests/data/torch_silk16k_24k.npz's WB 20 ms packets: plain
  (``silk48_xq``), with BBWE (``silk48_bwe_xq``) and with NoLACE + BBWE
  (``silk48_nolace_bwe_xq``), each [8, 8, 960] int16, the BBWE peaks
  (``silk48_bwe_peak``, ``silk48_nolace_bwe_peak`` [8, 8]) and NoLACE's
  (``silk48_nolace_peak``); and its WB 10 ms set, plain and with BBWE
  (``wb10_48_xq``, ``wb10_48_bwe_xq`` [1, 3, 480], ``wb10_48_bwe_peak``);
- the scalar ``OpusDecoder(48000, 1)`` on tests/data/
  torch_hybrid_{fb,swb}20ms.npz's packets (the TOC byte put back), with
  ``set_osce`` LACE and NoLACE, each without and with ``set_osce_bwe``:
  ``hyb_{fb,swb}_{lace,nolace}[_bwe]_rng`` [8, 8] uint32, the OSCE peaks
  ``_osce_peak`` and, with BBWE, the BBWE peaks ``_bwe_peak`` [8, 8], the
  enhanced 16 kHz SILK half ``hyb_{fb,swb}_{lace,nolace}_xq16`` [8, 8,
  320] int16 (BBWE's input less its 1-sample delay), and
  the PCM of the first HYB_FRAMES frames as ``_dlsb`` [8, 3, 960] int32:
  round(32768 (pcm - the plain hybrid fixture's pcm)), the SILK half's
  change in LSB (the CELT half is the same with and without the
  enhancement).  ``chip_smoke.hybrid_fixture_pcm(fx, hfx, name)``
  rebuilds the float32 PCM; the writer checks it within 1e-6 of the
  decoder's.

The random models' int16 outputs are noise-like, ~14 bits a sample
whatever the compressor: the PCM kept is what the size allows.

The peaks are captured by wrapping the JAX functions here (a BBWE
frame's is that of its final adaptive convs' outputs); the plain
48 kHz runs check that the decoders' other outputs equal the fixtures'
(the SILK fixture's final ranges, the hybrid fixtures' PCM and ranges).
It prints the share of output samples at +-32767 per run: with random
weights these show whether the comparison is mostly clipping; and, per
standalone stream, BBWE's largest output change when one input sample a
frame moves by 1 LSB (the sensitivity behind ``chip_smoke.BBWE_GAIN``).

Jobs run in 4 worker processes (~2-3 min).  Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_torch_bbwe_fixture.py
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import HYB_FRAMES, hybrid_fixture_pcm  # noqa: E402

DATA = os.path.join(REPO, "tests", "data")
SILK = os.path.join(DATA, "torch_silk16k_24k.npz")
HYB = {"fb": os.path.join(DATA, "torch_hybrid_fb20ms.npz"),
       "swb": os.path.join(DATA, "torch_hybrid_swb20ms.npz")}
TOC = {"fb": 0x78, "swb": 0x68}       # hybrid, 20 ms, mono, one frame
OUT = os.path.join(DATA, "torch_bbwe.npz")
SEEDS = {"bbwe": 70, "lace": 50, "nolace": 60}
NSTREAMS, NFRAMES, N16 = 8, 8, 320
STAGE_STREAM, STAGE_FRAME = 0, 2
COND_FRAMES = 2


def bbwe_signal(stream: int) -> np.ndarray:
    """Stream ``stream`` of the standalone BBWE input, int16 [8 * 320]."""
    n = NFRAMES * N16
    rng = np.random.default_rng(100 + stream)
    t = np.arange(n) / 16000.0

    def speech(seed):
        f0 = (110 + 23 * seed) * (1 + 0.2 * np.sin(2 * np.pi * 1.3 * t))
        ph = 2 * np.pi * np.cumsum(f0) / 16000.0
        sig = 0.3 * np.sin(ph) + 0.12 * np.sin(3 * ph + 0.5) \
            + 0.05 * np.sin(7 * ph + 1.0)
        sig *= 1 + 0.5 * np.sin(2 * np.pi * 2.1 * t + seed)
        return sig + 0.01 * rng.standard_normal(n)

    if stream < 4:
        sig = speech(stream)
    elif stream == 4:
        sig = np.zeros(n)
    elif stream == 5:
        sig = speech(5)
        sig[:3 * N16 + 37] = 0.0
    elif stream == 6:
        sig = np.sign(np.sin(2 * np.pi * 210 * t))
    else:
        sig = rng.uniform(-1, 1, n)
    return np.clip(np.round(32767 * sig), -32768, 32767).astype(np.int16)


def _capture_peaks(cap, key, mod, name):
    """Wrap mod.name (returning (state, out)) to append max |out| to
    cap[key]; returns the original."""
    orig = getattr(mod, name)

    def wrapped(*a, **k):
        st, out = orig(*a, **k)
        cap[key].append(np.float32(np.max(np.abs(out))))
        return st, out

    setattr(mod, name, wrapped)
    return orig


def _bbwe_peak_spy(bwe, cap):
    """Record each ``bwe.process`` frame's peak |float output| before the
    clipping: the largest |output| of the frame's final adaptive convs
    (the only ``adaconv_process_frame`` calls at 240 samples)."""
    from opus_tpu.dnn import bbwe as J

    def process(xq16, _orig=bwe.process):
        seen = []
        orig_conv = J.nndsp.adaconv_process_frame

        def conv(*a, **k):
            st, out = orig_conv(*a, **k)
            if a[5] == J.FRAME48:
                seen.append(float(np.max(np.abs(out))))
            return st, out

        J.nndsp.adaconv_process_frame = conv
        try:
            out = _orig(xq16)
        finally:
            J.nndsp.adaconv_process_frame = orig_conv
        assert len(seen) == 2 * (len(xq16) // 160)
        cap["bwe_peak"].append(np.float32(max(seen)))
        return out

    bwe.process = process


def _run_bbwe(stream):
    from opus_tpu.dnn import bbwe as J
    sig = bbwe_signal(stream)
    ext = J.BBWE(J.random_model(SEEDS["bbwe"]))
    cap = {k: [] for k in ("feats", "cond", "out", "bwe_peak", "up2",
                           "ip")}
    orig_feat, orig_net = J.bwe_calculate_features, J.feature_net
    orig_up, orig_ip = J.upsamp_2x, J.interpol_3_2
    stage = {"on": False}

    def feats(*a):
        st, f = orig_feat(*a)
        cap["feats"].append(np.asarray(f, np.float32))
        return st, f

    def fnet(*a):
        st, c = orig_net(*a)
        cap["cond"].append(np.asarray(c, np.float32))
        return st, c

    def up(state, x):
        st, out = orig_up(state, x)
        if stage["on"] and len(cap["up2"]) < 3:
            cap["up2"].append((state.upsamp.copy(),
                               np.asarray(x, np.float32), out))
        return st, out

    def ip(state, x):
        st, out = orig_ip(state, x)
        if stage["on"] and len(cap["ip"]) < 3:
            cap["ip"].append((state.interpol.copy(),
                              np.asarray(x, np.float32), out))
        return st, out

    _bbwe_peak_spy(ext, cap)
    J.bwe_calculate_features, J.feature_net = feats, fnet
    J.upsamp_2x, J.interpol_3_2 = up, ip
    try:
        for f in range(NFRAMES):
            stage["on"] = stream == STAGE_STREAM and f == STAGE_FRAME
            cap["out"].append(ext.process(sig[f * N16:(f + 1) * N16]))
    finally:
        J.bwe_calculate_features, J.feature_net = orig_feat, orig_net
        J.upsamp_2x, J.interpol_3_2 = orig_up, orig_ip
    res = dict(bbwe_in=sig.reshape(NFRAMES, N16),
               bbwe_feats=np.stack(cap["feats"]),
               bbwe_cond=np.stack(cap["cond"][:COND_FRAMES]),
               bbwe_out=np.stack(cap["out"]).astype(np.int16),
               bbwe_peak=np.asarray(cap["bwe_peak"], np.float32))
    if cap["up2"]:
        for key, rows in (("up2", cap["up2"]), ("ip", cap["ip"])):
            res[key + "_state"] = np.stack([r[0] for r in rows])
            res[key + "_x"] = np.stack([r[1] for r in rows])
            res[key + "_out"] = np.stack([r[2] for r in rows])
    return res


def _run_silk(job):
    from opus_tpu.bitstream.range_coder import RangeDecoder
    from opus_tpu.dnn import bbwe as J
    from opus_tpu.dnn import osce as JO
    from opus_tpu.silk.api import SilkDecoder

    kind, pre, stream = job
    ms = 20 if pre == "" else 10
    fx = np.load(SILK)
    frames, lens = fx[pre + "frames"][stream], fx[pre + "lens"][stream]
    cap = {"bwe_peak": [], "osce_peak": []}
    orig = _capture_peaks(cap, "osce_peak", JO, "nolace_process_frame")
    try:
        sd = SilkDecoder()
        if kind != "plain":
            ext = J.BBWE(J.random_model(SEEDS["bbwe"]))
            _bbwe_peak_spy(ext, cap)
            sd.channel_state[0].bwe = ext
        if kind == "nolace_bwe":
            sd.channel_state[0].osce = JO.OSCEEnhancer(
                2, JO.random_nolace_model(SEEDS["nolace"]))
        out, rngs = [], []
        for f in range(frames.shape[0]):
            rd = RangeDecoder(bytes(frames[f, :lens[f]]))
            out.append(sd.decode(rd, n_channels_api=1, n_channels_internal=1,
                                 api_sample_rate=48000,
                                 internal_sample_rate=16000,
                                 payload_size_ms=ms, lost_flag=0,
                                 new_packet_flag=True))
            rngs.append(rd.rng)
    finally:
        JO.nolace_process_frame = orig
    if not np.array_equal(np.asarray(rngs, np.uint32),
                          fx[pre + "final_range"][stream]):
        raise RuntimeError(f"{job}: final ranges differ from the SILK "
                           f"fixture")
    return dict(xq=np.stack(out).astype(np.int16),
                bwe_peak=np.asarray(cap["bwe_peak"], np.float32),
                osce_peak=np.asarray(cap["osce_peak"], np.float32))


def _run_hybrid(job):
    from opus_tpu.dnn import bbwe as J
    from opus_tpu.dnn import osce as JO
    from opus_tpu.models.opus_decoder import OpusDecoder

    bw, method, with_bwe, stream = job
    fx = np.load(HYB[bw])
    frames, lens = fx["frames"][stream], fx["lens"][stream]
    cap = {"bwe_peak": [], "osce_peak": []}
    name = "lace_process_frame" if method == 1 else "nolace_process_frame"
    orig = _capture_peaks(cap, "osce_peak", JO, name)
    try:
        dec = OpusDecoder(48000, 1)
        if method:
            dec.set_osce(method, (JO.random_lace_model(SEEDS["lace"])
                                  if method == 1 else
                                  JO.random_nolace_model(SEEDS["nolace"])))
        if with_bwe:
            dec.set_osce_bwe(J.random_model(SEEDS["bbwe"]))
            _bbwe_peak_spy(dec.silk.channel_state[0].bwe, cap)
        enh = dec.silk.channel_state[0].osce
        xq16 = []

        def enhance_frame(*a, _orig=enh.enhance_frame):
            out = _orig(*a)
            xq16.append(np.asarray(out, np.int16))
            return out

        enh.enhance_frame = enhance_frame
        pcm, rngs = [], []
        for f in range(frames.shape[0]):
            p = bytes([TOC[bw]]) + bytes(frames[f, :lens[f]])
            pcm.append(np.asarray(dec.decode(p, 960), np.float32))
            rngs.append(dec.rangeFinal)
    finally:
        setattr(JO, name, orig)
    res = dict(pcm=np.stack(pcm), rng=np.asarray(rngs, np.uint32),
               xq16=np.stack(xq16),
               osce_peak=np.asarray(cap["osce_peak"], np.float32),
               bwe_peak=np.asarray(cap["bwe_peak"], np.float32))
    if not np.array_equal(res["rng"], fx["final_range"][stream]):
        raise RuntimeError(f"{job}: final ranges differ from the hybrid "
                           f"fixture")
    return res


def _run_gain(stream):
    """BBWE's response to one input sample a frame moved by 1 LSB: the
    largest |output change| (LSB) of each frame of the standalone stream
    ``stream``, against the unchanged run."""
    from opus_tpu.dnn import bbwe as J
    sig = bbwe_signal(stream)
    rng = np.random.default_rng(200 + stream)
    model = J.random_model(SEEDS["bbwe"])
    a, b = J.BBWE(model), J.BBWE(model)
    out = []
    for f in range(NFRAMES):
        x = sig[f * N16:(f + 1) * N16]
        y = x.astype(np.int32)
        i = int(rng.integers(N16))
        y[i] += 1 if y[i] < 32767 else -1
        out.append(int(np.abs(a.process(x).astype(np.int32)
                              - b.process(y.astype(np.int16))).max()))
    return np.asarray(out)


def _run(job):
    t0 = time.time()
    kind = job[0]
    if kind == "bbwe":
        out = _run_bbwe(job[1])
    elif kind == "silk":
        out = _run_silk(job[1:])
    elif kind == "gain":
        out = _run_gain(job[1])
    else:
        out = _run_hybrid(job[1:])
    return job, out, time.time() - t0


def _clip_share(x) -> float:
    return float(np.mean(np.abs(np.asarray(x, np.float64)) >= 32767))


def main():
    t0 = time.time()
    silk_kinds = ("plain", "bwe", "nolace_bwe")
    hyb_runs = [(m, b) for m in (1, 2) for b in (False, True)]
    jobs = [("hyb", bw, m, b, s) for bw in ("fb", "swb")
            for m, b in hyb_runs for s in range(NSTREAMS)]
    jobs += [("silk", k, "", s) for k in silk_kinds for s in range(NSTREAMS)]
    jobs += [("silk", k, "wb10_", 0) for k in ("plain", "bwe")]
    jobs += [("bbwe", s) for s in range(NSTREAMS)]
    jobs += [("gain", s) for s in range(NSTREAMS)]
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        results = pool.map(_run, jobs, chunksize=1)
    res = {job: out for job, out, _ in results}
    store = {}
    bb = [res[("bbwe", s)] for s in range(NSTREAMS)]
    for key in ("bbwe_in", "bbwe_feats", "bbwe_cond", "bbwe_out",
                "bbwe_peak"):
        store[key] = np.stack([r[key] for r in bb])
    for key in ("up2_state", "up2_x", "up2_out", "ip_state", "ip_x",
                "ip_out"):
        store[key] = bb[STAGE_STREAM][key]
    for k in silk_kinds:
        name = "silk48" + ("" if k == "plain" else "_" + k)
        rows = [res[("silk", k, "", s)] for s in range(NSTREAMS)]
        store[name + "_xq"] = np.stack([r["xq"] for r in rows])
        if k != "plain":
            store[name + "_peak"] = np.stack([r["bwe_peak"] for r in rows])
        if k == "nolace_bwe":
            store["silk48_nolace_peak"] = np.stack([r["osce_peak"]
                                                    for r in rows])
    for k in ("plain", "bwe"):
        r = res[("silk", k, "wb10_", 0)]
        name = "wb10_48" + ("" if k == "plain" else "_bwe")
        store[name + "_xq"] = r["xq"][None]
        if k == "bwe":
            store[name + "_peak"] = r["bwe_peak"][None]
    for bw in ("fb", "swb"):
        hfx = np.load(HYB[bw])
        for m, b in hyb_runs:
            name = f"hyb_{bw}_{'lace' if m == 1 else 'nolace'}" \
                + ("_bwe" if b else "")
            rows = [res[("hyb", bw, m, b, s)] for s in range(NSTREAMS)]
            pcm = np.stack([r["pcm"] for r in rows])[:, :HYB_FRAMES]
            store[name + "_dlsb"] = np.round(32768.0 * (
                pcm.astype(np.float64)
                - hfx["pcm"][:, :HYB_FRAMES])).astype(np.int32)
            back = hybrid_fixture_pcm(store, hfx, name)
            if np.abs(back - pcm).max() > 1e-6:
                raise RuntimeError(f"{name}: the PCM is not the plain PCM "
                                   f"plus whole LSBs")
            store[name + "_rng"] = np.stack([r["rng"] for r in rows])
            xq16 = np.stack([r["xq16"] for r in rows])
            key = f"hyb_{bw}_{'lace' if m == 1 else 'nolace'}_xq16"
            if b and not np.array_equal(store[key], xq16):
                raise RuntimeError(f"{name}: BBWE changed the SILK half")
            store[key] = xq16
            store[name + "_osce_peak"] = np.stack([r["osce_peak"]
                                                   for r in rows])
            if b:
                store[name + "_bwe_peak"] = np.stack([r["bwe_peak"]
                                                      for r in rows])
    np.savez_compressed(OUT, **store)
    print(f"BBWE alone: {100 * _clip_share(store['bbwe_out']):.2f}% of "
          f"output samples at +-32767; peaks "
          f"{np.round(store['bbwe_peak'].max(axis=1), 2).tolist()} by stream")
    for k in ("silk48", "silk48_bwe", "silk48_nolace_bwe"):
        print(f"{k}: {100 * _clip_share(store[k + '_xq']):.2f}% of samples "
              f"at +-32767")
    for key in sorted(store):
        if key.startswith("hyb_") and key.endswith("_dlsb"):
            print(f"{key}: SILK half changed by up to "
                  f"{int(np.abs(store[key]).max())} LSB")
    gain = np.stack([res[("gain", s)] for s in range(NSTREAMS)])
    print(f"BBWE's largest output change (LSB) for one input sample moved "
          f"by 1 LSB, per stream (frames max): {gain.max(axis=1).tolist()}")
    slow = max(results, key=lambda r: r[2])
    print(f"slowest job {slow[0]}: {slow[2]:.1f} s")
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
