"""Writes tests/data/torch_dred_recovery.npz: real DRED-bearing packets and
the JAX package's DRED loss-recovery outputs for them, the packet source
and reference of the port's DRED tests and of chip_smoke.py's DRED phase.

Models from the seeds of tests/test_dnn_recovery.py (RDOVAE encoder 41,
decoder 42, DRED statistics 43, pitch DNN 45, FARGAN 46; random weights
at the published widths).  Streams, 16 kHz mono, 20 ms frames:

- streams 0-7: ``OpusEncoder(16000, 1, "voip")`` at 32 kb/s with
  ``enable_dred(..., duration_frames_10ms=24)`` over 1 s of the speech-
  like signal of tests/test_dnn_recovery.py (seed = stream + 1); the last
  packet longer than 2 bytes is kept, as that test keeps it;
- stream 8: the same encoder without DRED (seed 9): a stream whose packet
  has no DRED payload.

Stored: ``packets`` [9, P] uint8 and ``lens``; ``pcm0`` [9, 320] (the last
good output, seeded noise as in tests/test_dnn_recovery.py), the loss
offsets (2 + i % 3) and ``n_frames`` = 6; the JAX outputs: the
``ParsedBatch`` fields (``state0``, ``latents``, ``nb_latents``,
``dred_offset``, ``has_dred``), ``playback_rows`` (``cont_idx``,
``play_idx``), the RDOVAE qframes of ``rdovae_decode_frames``
(``qframes`` [T, 9, 80]) and ``BatchedDREDRecovery.recover``'s PCM
(``pcm`` [9, 960]).  Weights are not stored: they are rebuilt from the
seeds.

The encoder takes seconds a frame; the streams are encoded in 4 worker
processes.  Run from the repository root:
    JAX_PLATFORMS=cpu python tools/make_torch_dred_fixture.py
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_dred_recovery.npz")
FS = 16000
FRAME = 320
N_DRED = 8
N_FRAMES = 6
SEEDS = dict(enc=41, dec=42, stats=43, pitch=45, fargan=46)


def _speech(fs, seconds, seed):
    """tests/test_dnn_recovery.py's speech-like test signal."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 100 + 40 * (seed % 3)
    phase = np.cumsum(f0 * (1 + 0.1 * np.sin(2 * np.pi * 3 * t))) / fs
    return np.clip(
        0.25 * (np.sin(2 * np.pi * phase) + 0.5 * np.sin(4 * np.pi * phase))
        + 0.01 * rng.standard_normal(n), -1, 1)


def _run(stream):
    from opus_tpu.dnn import dred as dredmod, pitchdnn as pdnn, rdovae
    from opus_tpu.models.opus_encoder import OpusEncoder

    t0 = time.time()
    enc = OpusEncoder(FS, 1, "voip")
    enc.set_bitrate(32000)
    if stream < N_DRED:
        enc.enable_dred(rdovae.random_enc_model(SEEDS["enc"]),
                        pdnn.random_model(SEEDS["pitch"]),
                        dredmod.random_stats(SEEDS["stats"]),
                        duration_frames_10ms=24)
    pcm = _speech(FS, 1.0, seed=stream + 1)
    last = None
    for i in range(len(pcm) // FRAME):
        p = enc.encode(pcm[i * FRAME:(i + 1) * FRAME], FRAME)
        if len(p) > 2:
            last = p
    assert last is not None, stream
    return stream, bytes(last), time.time() - t0


def main():
    from opus_tpu.dnn import dred as dredmod, fargan as fg, rdovae
    from opus_tpu.dnn.dred_dec import dred_find_payload
    from opus_tpu.models import batched_dnn as bd
    from opus_tpu.models.dnn_recovery import (BatchedDREDRecovery,
                                              parse_batch, playback_rows)

    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        results = sorted(pool.map(_run, range(N_DRED + 1), chunksize=1))
    packets = [r[1] for r in results]
    for s, p, sec in results:
        print(f"stream {s}: {sec:.1f} s, {len(p)} bytes, DRED payload "
              f"{'found' if dred_find_payload(p) else 'none'}")
    assert all(dred_find_payload(p) is not None for p in packets[:N_DRED])
    assert dred_find_payload(packets[N_DRED]) is None

    b = len(packets)
    dec = rdovae.random_dec_model(SEEDS["dec"])
    stats = dredmod.random_stats(SEEDS["stats"])
    fargan = fg.random_model(SEEDS["fargan"])
    parsed = parse_batch(stats, packets, FS, FS)
    rng = np.random.default_rng(7)
    pcm0 = np.clip(0.2 * rng.standard_normal((b, 320)), -1,
                   1).astype(np.float32)
    loss_off = np.array([2 + (i % 3) for i in range(b)], np.int32)
    cont_idx, play_idx = playback_rows(parsed, loss_off, N_FRAMES)
    _, qframes = bd.rdovae_decode_frames(dec, parsed.state0, parsed.latents)
    pcm = BatchedDREDRecovery(dec, stats, fargan).recover(
        parsed, pcm0, loss_off, N_FRAMES)

    p = max(len(x) for x in packets)
    buf = np.zeros((b, p), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, x in enumerate(packets):
        buf[i, :len(x)] = np.frombuffer(x, np.uint8)
        lens[i] = len(x)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, packets=buf, lens=lens, pcm0=pcm0, loss_offset=loss_off,
        n_frames=np.int32(N_FRAMES), state0=parsed.state0,
        latents=parsed.latents, nb_latents=parsed.nb_latents,
        dred_offset=parsed.dred_offset, has_dred=parsed.has_dred,
        cont_idx=cont_idx, play_idx=play_idx,
        qframes=np.asarray(qframes, np.float32),
        pcm=np.asarray(pcm, np.float32))
    print(f"nb_latents {parsed.nb_latents.tolist()}, dred_offset "
          f"{parsed.dred_offset.tolist()}, play rows {play_idx.tolist()}")
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
