"""Writes tests/data/torch_osce_wb20ms.npz: the scalar SILK decoder's
output with OSCE enhancement on, the oracle of the port's OSCE tests and
of chip_smoke.py's osce phase.

The scalar decoder (``opus_tpu.silk.api.SilkDecoder``, driven as
tools/make_torch_silk_fixture.py drives it) decodes the SILK fixture's
packets (tests/data/torch_silk16k_24k.npz: 8 streams x 8 wideband 20 ms
frames) with ``channel_state[0].osce = OSCEEnhancer(method, model)``, for
LACE (``random_lace_model(50)``) and NoLACE (``random_nolace_model(60)``),
as ``OpusDecoder.set_osce`` switches it on.  Method axis: 0 LACE, 1
NoLACE.  Per lane-frame it stores:

- ``xq`` [2, 8, 8, 320] int16: the enhanced output;
- ``num_bits`` [2, 8, 8], ``numbits`` [2, 8, 8, 2] f32, ``periods``
  [2, 8, 8, 4] and ``features`` [2, 8, 8, 4, 93] f32: the enhancer's
  inputs and intermediates, captured by wrapping ``enhance_frame`` and
  ``calculate_features`` here (the unenhanced input must equal the SILK
  fixture's ``xq``);
- ``peak`` [2, 8, 8] f32: the largest magnitude of the LACE / NoLACE
  float output of the frame, before the first frame's pass-through and
  the clipping (the PCM bounds scale with it);
- ``nb_xq``, ``mb_xq``, ``wb10_xq`` [2, 1, 3, L]: the NB, MB and WB 10 ms
  sets decoded with OSCE on (they must pass through unchanged).

It prints the share of enhanced samples at +-32767 and the RMS change
against the unenhanced output per method: with random weights these show
whether the comparison is mostly clipping.

The JAX layers run eagerly (~0.15 s a LACE frame, ~0.5 s a NoLACE frame
after compiling); the 2 x 11 jobs run in 4 worker processes (~15 s).
Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_torch_osce_fixture.py
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SILK = os.path.join(REPO, "tests", "data", "torch_silk16k_24k.npz")
OUT = os.path.join(REPO, "tests", "data", "torch_osce_wb20ms.npz")
SEEDS = {1: 50, 2: 60}          # LACE, NoLACE
SETS = {"": (16000, 20), "nb_": (8000, 20), "mb_": (12000, 20),
        "wb10_": (16000, 10)}


def _run(job):
    from opus_tpu.bitstream.range_coder import RangeDecoder
    from opus_tpu.dnn import osce as JO
    from opus_tpu.dnn import osce_features as JF
    from opus_tpu.silk import decoder as sdec
    from opus_tpu.silk.api import SilkDecoder

    method, pre, stream = job
    fs, ms = SETS[pre]
    fx = np.load(SILK)
    frames, lens = fx[pre + "frames"][stream], fx[pre + "lens"][stream]
    model = (JO.random_lace_model if method == 1
             else JO.random_nolace_model)(SEEDS[method])
    cap = {k: [] for k in ("xq", "plain", "num_bits", "numbits", "periods",
                           "features", "peak")}
    orig_frame = sdec.ChannelState.decode_frame
    orig_feat = JF.calculate_features

    def decode_frame(self, dec, xq_out, lost, cond):
        r = orig_frame(self, dec, xq_out, lost, cond)
        cap["xq"].append(np.asarray(xq_out, np.int16).copy())
        return r

    def calculate_features(*a, **k):
        out = orig_feat(*a, **k)
        cap["features"].append(out[1])
        cap["numbits"].append(out[2])
        cap["periods"].append(out[3])
        return out

    name = "lace_process_frame" if method == 1 else "nolace_process_frame"
    orig_proc = getattr(JO, name)

    def process_frame(*a):
        state, out = orig_proc(*a)
        cap["peak"].append(np.float32(np.max(np.abs(out))))
        return state, out

    enh = JO.OSCEEnhancer(method, model)
    orig_enh = enh.enhance_frame

    def enhance_frame(xq, num_bits, *a):
        cap["plain"].append(np.asarray(xq, np.int16).copy())
        cap["num_bits"].append(num_bits)
        return orig_enh(xq, num_bits, *a)

    enh.enhance_frame = enhance_frame
    sdec.ChannelState.decode_frame = decode_frame
    JF.calculate_features = calculate_features
    setattr(JO, name, process_frame)
    t0 = time.time()
    try:
        sd = SilkDecoder()
        sd.channel_state[0].osce = enh
        for f in range(frames.shape[0]):
            rd = RangeDecoder(bytes(frames[f, :lens[f]]))
            sd.decode(rd, n_channels_api=1, n_channels_internal=1,
                      api_sample_rate=fs, internal_sample_rate=fs,
                      payload_size_ms=ms, lost_flag=0, new_packet_flag=True)
    finally:
        sdec.ChannelState.decode_frame = orig_frame
        JF.calculate_features = orig_feat
        setattr(JO, name, orig_proc)
    out = {k: np.stack(v) for k, v in cap.items() if v}
    if not np.array_equal(out["plain"], fx[pre + "xq"][stream]):
        raise RuntimeError(f"{job}: the unenhanced output differs from the "
                           f"SILK fixture")
    return job, out, time.time() - t0


def main():
    t0 = time.time()
    jobs = [(m, pre, s) for m in (1, 2) for pre, n in
            (("", 8), ("nb_", 1), ("mb_", 1), ("wb10_", 1))
            for s in range(n)]
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        results = pool.map(_run, jobs, chunksize=1)
    res = {job: out for job, out, _ in results}
    fx = np.load(SILK)
    store = {}
    for pre, n in (("", 8), ("nb_", 1), ("mb_", 1), ("wb10_", 1)):
        store[pre + "xq"] = np.stack([np.stack(
            [res[(m, pre, s)]["xq"] for s in range(n)]) for m in (1, 2)])
    for key in ("num_bits", "numbits", "periods", "features", "peak"):
        store[key] = np.stack([np.stack([res[(m, "", s)][key]
                                         for s in range(8)])
                               for m in (1, 2)])
    store["num_bits"] = store["num_bits"].astype(np.int32)
    store["periods"] = store["periods"].astype(np.int32)
    for pre in ("nb_", "mb_", "wb10_"):
        if not all(np.array_equal(store[pre + "xq"][m], fx[pre + "xq"])
                   for m in range(2)):
            raise RuntimeError(f"{pre}: OSCE did not pass through")
    np.savez_compressed(OUT, **store)
    plain = fx["xq"].astype(np.float64)
    for m, name in enumerate(("LACE", "NoLACE")):
        enh = store["xq"][m].astype(np.float64)
        clip = float(np.mean(np.abs(enh) >= 32767))
        rms_in = np.sqrt(np.mean(plain ** 2))
        rms_d = np.sqrt(np.mean((enh - plain) ** 2))
        print(f"{name}: {100 * clip:.2f}% of enhanced samples at +-32767; "
              f"RMS of the change {rms_d:.1f} against the unenhanced RMS "
              f"{rms_in:.1f} ({20 * np.log10(rms_d / rms_in):.1f} dB); "
              f"enhanced RMS {np.sqrt(np.mean(enh ** 2)):.1f}")
    for job, _out, sec in results:
        if job[1] == "" and job[2] == 0:
            print(f"method {job[0]} stream 0: {sec:.1f} s")
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
