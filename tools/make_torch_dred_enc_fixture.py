"""Writes tests/data/torch_dred_enc.npz: the JAX package's DRED encoder
(``opus_tpu/dnn/dred_enc.py`` ``DREDEnc``, ``opus_tpu/dnn/dred.py``) and
``OpusEncoder._attach_dred`` on seeded speech-like streams, the reference
of the port's DRED encoder tests and of ``chip_smoke.py``'s config-5
chain.

Models from the seeds of tests/test_dred_integration.py (RDOVAE encoder
31, DRED statistics 33, pitch DNN 35; random weights at the published
widths; the decoder side, RDOVAE decoder 32 and FARGAN 36, is not needed
here).  Streams, mono, 24 frames of 20 ms each:

- 8 at 48 kHz (extra delay 0, as a restricted-lowdelay CELT encoder has
  none), 4 at 16 kHz (extra delay 64 samples, a voip encoder's
  fs / 250): the speech-like signal of tests/test_dred_integration.py:20
  with the stream's seed, pitch and level; 48 kHz stream 5 is digital
  silence in its last 6 frames;
- per frame the voice activity is 0 on an all-zero frame, else 1, pushed
  into the encoder's 2.5 ms history as ``OpusEncoder.encode`` does
  (``opus_tpu/models/opus_encoder.py:850-857``).

On each of the last ``ATTACH`` frames, an ``OpusEncoder`` of the stream's
rate whose ``dred``, ``dred_duration`` (40), ``activity_mem``, bitrate
(64 kb/s at 48 kHz, 32 kb/s at 16 kHz) and VBR (on) are set attaches the
stream's payload to a packet (TOC 0xF8 and 160 seeded random bytes) with
``_attach_dred(packet, max_data_bytes)`` (1276 bytes at 48 kHz; 300 at
16 kHz, where the byte budget cuts the ladder).

Stored, ``<r>`` = ``48k`` or ``16k``:
- ``pcm_<r>`` [S, F, N] float32 (the encoder reads it as float64) and
  ``activity_<r>`` [S, F] uint8;
- per frame: ``latent_<r>`` [F, S, 80] and ``state_<r>`` [F, S, 24], the
  newest RDOVAE latent and initial state; ``dred_offset_<r>``,
  ``fill_<r>`` (``latents_buffer_fill``), ``input_fill_<r>`` [F];
- per attach frame a: ``activity_mem_<r>`` [A, S, 416], ``packet_<r>``
  [A, S, 161] (the packet before), ``attached_<r>`` [A, S, L] with
  ``attached_len_<r>``, ``payload_<r>`` [A, S, P] with ``payload_len_<r>``
  (-1: None), ``latent_offset_<r>`` [A, S] (the payload's latent skip),
  ``q0_<r>``/``dq_<r>``/``chunks_<r>``/``max_bytes_<r>`` [A, S] (what
  ``encode_payload`` was given), and the values before rounding of the
  quantizer in the JAX package's order: ``v_state_<r>`` [A, S, 24] and
  ``v_latents_<r>`` [A, S, C, 80] (chunk c the latent 2c + offset);
- ``extra_delay_<r>``, ``max_data_bytes_<r>``, ``bitrate_<r>``, ``seeds``.

Run from the repository root (~1 min on one CPU core):
    JAX_PLATFORMS=cpu python tools/make_torch_dred_enc_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_dred_enc.npz")
SEEDS = dict(enc=31, dec=32, stats=33, pitch=35, fargan=36)
NFRAMES = 24
ATTACH = 2                   # the last frames whose packets carry DRED
DURATION = 40                # 10 ms frames: 11 chunks
SILENT_STREAM, SILENT_FRAMES = 5, 6
RATES = {"48k": dict(fs=48000, streams=8, extra_delay=0,
                     max_data_bytes=1276, bitrate=64000),
         "16k": dict(fs=16000, streams=4, extra_delay=64,
                     max_data_bytes=300, bitrate=32000)}


def speech(fs: int, n: int, seed: int) -> np.ndarray:
    """tests/test_dred_integration.py:20's speech-like signal, with the
    stream's pitch (110-180 Hz) and level."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 110 + 10 * (seed % 8)
    amp = 0.15 + 0.02 * (seed % 6)
    phase = np.cumsum(f0 * (1 + 0.1 * np.sin(2 * np.pi * 3 * t))) / fs
    return np.clip(
        amp * (np.sin(2 * np.pi * phase) + 0.5 * np.sin(4 * np.pi * phase))
        + 0.01 * rng.standard_normal(n), -1, 1)


def signals(key: str) -> np.ndarray:
    """[S, F, N] float32 PCM of the ``key`` rate's streams (float32, the
    type a batched encoder's input has)."""
    cfg = RATES[key]
    n = cfg["fs"] // 50
    first = 11 if key == "16k" else 1
    out = np.stack([speech(cfg["fs"], NFRAMES * n, first + s)
                    for s in range(cfg["streams"])]).reshape(
        cfg["streams"], NFRAMES, n)
    if key == "48k":
        out[SILENT_STREAM, NFRAMES - SILENT_FRAMES:] = 0.0
    return out.astype(np.float32)


def pre_rounding(x, scale, dzone):
    """The value quantize_latents rounds (opus_tpu/dnn/dred.py:77-85), in
    its order: xq - delta * tanh_approx(xq / (delta + 0.1))."""
    from opus_tpu.dnn.nnet import tanh_approx
    x = np.asarray(x, np.float32)
    delta = dzone.astype(np.float32) / 256.0
    xq = x * scale.astype(np.float32) / 256.0
    dead = np.asarray(tanh_approx(xq / (delta + 0.1)), np.float32)
    return xq - delta * dead


def run_rate(key: str, models, rng):
    from opus_tpu.dnn import dred as dredmod
    from opus_tpu.models.opus_encoder import OpusEncoder

    cfg = RATES[key]
    fs, ns = cfg["fs"], cfg["streams"]
    pcm = signals(key)
    n = pcm.shape[2]
    f400 = n * 400 // fs
    activity = (np.abs(pcm).max(axis=2) > 0).astype(np.uint8)
    rec = {k: [] for k in ("latent", "state", "dred_offset", "fill",
                           "input_fill")}
    att = {k: [] for k in ("activity_mem", "packet", "attached", "payload",
                           "latent_offset", "q0", "dq", "chunks",
                           "max_bytes", "v_state", "v_latents")}
    encs = []
    for s in range(ns):
        enc = OpusEncoder(fs, 1, "restricted-lowdelay")
        enc.set_bitrate(cfg["bitrate"])
        enc.enable_dred(models["enc"], models["pitch"], models["stats"],
                        DURATION)
        encs.append(enc)
    for f in range(NFRAMES):
        for s, enc in enumerate(encs):
            d = enc.dred
            d.compute_latents(pcm[s, f].astype(np.float64), n,
                              extra_delay=cfg["extra_delay"])
            enc.activity_mem[f400:] = enc.activity_mem[:-f400].copy()
            enc.activity_mem[:f400] = activity[s, f]
        for k, get in (("latent", lambda e: e.dred.latents[0]),
                       ("state", lambda e: e.dred.states[0]),
                       ("dred_offset", lambda e: e.dred.dred_offset),
                       ("fill", lambda e: e.dred.latents_buffer_fill),
                       ("input_fill", lambda e: e.dred.input_buffer_fill)):
            vals = [get(e) for e in encs]
            if k in ("latent", "state"):
                rec[k].append(np.stack(vals).astype(np.float32))
            else:
                assert len(set(vals)) == 1, (k, vals)
                rec[k].append(vals[0])
        if f < NFRAMES - ATTACH:
            continue
        row = {k: [] for k in att}
        for s, enc in enumerate(encs):
            packet = bytes([0xF8]) + rng.integers(0, 256, 160, np.uint8) \
                .tobytes()
            seen = {}
            orig = enc.dred.encode_payload

            def spy(activity_mem, max_chunks, max_bytes, q0, dq,
                    _orig=orig, _seen=seen):
                _seen.update(max_chunks=max_chunks, max_bytes=max_bytes,
                             q0=q0, dq=dq)
                _seen["payload"] = _orig(activity_mem, max_chunks,
                                         max_bytes, q0=q0, dq=dq)
                return _seen["payload"]

            enc.dred.encode_payload = spy
            try:
                out = enc._attach_dred(packet, cfg["max_data_bytes"])
            finally:
                del enc.dred.encode_payload
            d = enc.dred
            lo = 0
            while lo < d.latents_buffer_fill - 1 and not \
                    enc.activity_mem[8 * lo:8 * lo + 16].any():
                lo += 1
            q0, dq, mc = seen["q0"], seen["dq"], seen["max_chunks"]
            st = models["stats"]
            v_lat = np.zeros((mc, 80), np.float32)
            for c in range(mc):
                if 2 * c + lo >= dredmod.DRED_MAX_FRAMES:
                    break
                lv = dredmod.compute_quantizer(q0, dq, 15, c)
                v_lat[c] = pre_rounding(d.latents[2 * c + lo],
                                        st.latent_scale[lv],
                                        st.latent_dead_zone[lv])
            row["v_latents"].append(v_lat)
            row["v_state"].append(pre_rounding(
                d.states[lo], st.state_scale[q0], st.state_dead_zone[q0]))
            row["activity_mem"].append(enc.activity_mem.copy())
            row["packet"].append(np.frombuffer(packet, np.uint8))
            row["attached"].append(out)
            row["payload"].append(seen["payload"])
            row["latent_offset"].append(lo)
            for k in ("q0", "dq", "max_bytes"):
                row[k].append(seen[k])
            row["chunks"].append(mc)
        for k, v in row.items():
            att[k].append(v)
        print(f"{key} frame {f}: payload bytes "
              f"{[None if p is None else len(p) for p in row['payload']]}, "
              f"latent offsets {row['latent_offset']}", flush=True)

    def ragged(rows):
        """[A][S] bytes or None -> ([A, S, L] uint8, [A, S] lengths, -1
        for None)."""
        width = max([len(p) for r in rows for p in r if p is not None],
                    default=1)
        buf = np.zeros((len(rows), len(rows[0]), width), np.uint8)
        ln = np.full((len(rows), len(rows[0])), -1, np.int32)
        for a, r in enumerate(rows):
            for s, p in enumerate(r):
                if p is not None:
                    buf[a, s, :len(p)] = np.frombuffer(p, np.uint8)
                    ln[a, s] = len(p)
        return buf, ln

    out = {f"pcm_{key}": pcm, f"activity_{key}": activity}
    for k in ("latent", "state"):
        out[f"{k}_{key}"] = np.stack(rec[k])
    for k in ("dred_offset", "fill", "input_fill"):
        out[f"{k}_{key}"] = np.asarray(rec[k], np.int32)
    for k in ("attached", "payload"):
        out[f"{k}_{key}"], out[f"{k}_len_{key}"] = ragged(att[k])
    out[f"packet_{key}"] = np.stack([np.stack(r) for r in att["packet"]])
    out[f"activity_mem_{key}"] = np.stack([np.stack(r) for r in
                                           att["activity_mem"]])
    for k in ("latent_offset", "q0", "dq", "chunks", "max_bytes"):
        out[f"{k}_{key}"] = np.asarray(att[k], np.int32)
    out[f"v_state_{key}"] = np.stack([np.stack(r) for r in att["v_state"]])
    out[f"v_latents_{key}"] = np.stack([np.stack(r) for r in
                                        att["v_latents"]])
    for k in ("extra_delay", "max_data_bytes", "bitrate"):
        out[f"{k}_{key}"] = np.int32(cfg[k])
    return out


def main():
    from opus_tpu.dnn import dred as dredmod
    from opus_tpu.dnn import pitchdnn as pdnn
    from opus_tpu.dnn import rdovae

    t0 = time.time()
    models = dict(enc=rdovae.random_enc_model(SEEDS["enc"]),
                  stats=dredmod.random_stats(SEEDS["stats"]),
                  pitch=pdnn.random_model(SEEDS["pitch"]))
    rng = np.random.default_rng(7)
    out = {"seeds": np.asarray([SEEDS[k] for k in
                                ("enc", "dec", "stats", "pitch", "fargan")],
                               np.int32)}
    for key in RATES:
        out.update(run_rate(key, models, rng))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
