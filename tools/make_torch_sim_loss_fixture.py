"""Writes tests/data/torch_sim_loss.npz: the JAX package's per-stream loss
machinery, the reference of the port's per-lane loss tests
(tests/test_torch_lossgen.py, test_torch_plc_lanes.py,
test_torch_resampler_rates.py, test_torch_sim_loss.py) and of
chip_smoke.py's sim_loss, plc_lanes and plc_rates phases.

Random weights at the published widths, from seeds.  Four parts, each
in its own process:

1. ``lossgen``: ``LossGen(random_model(33), seed)`` (opus_demo's stand-in
   model) for the 8 seeds ``LG_SEEDS``: 200 flags at 10% after the
   burn-in (``lg_flags`` [8, 200]); and ``opus_demo._loss_flags(40, 0,
   10, None, None, seed)`` for the seeds ``LF_SEEDS`` (each its own
   ``random_model(seed)``: ``lf_flags`` [2, 40]).
2. ``plc``: 8 independent JAX ``LPCNetPLC`` (PLC 44, pitch DNN 45, FARGAN
   46, the deep-PLC fixture's models), each driven through ``TICKS`` 10 ms
   ticks by its own ``LossGen(random_model(33), 300 + i)`` pattern at 30%
   (``plc_lost`` [8, TICKS]) on ``chip_smoke.speech_history(8, 7,
   TICKS)``: ``update`` on a good tick, ``conceal`` on a lost one; before
   tick ``RESET_TICK`` the lanes ``RESET_LANES`` are ``reset``.  Stored
   per tick: the concealed int16 (``plc_pcm``, zeros on a good tick), the
   features after it (``plc_feats`` [8, TICKS, 36]), the FARGAN period,
   the loss count and the four counters (``plc_<name>`` [8, TICKS]).
3. ``rates``: tests/data/torch_deep_plc.npz's first step on its 9 streams
   at 8, 12 and 24 kHz: 16 ``update``s of its history, then
   ``OpusDecoder(fs).dred_decode`` of 60 ms at ``off<k>`` (the 48 kHz
   offset scaled to fs) with the DRED of torch_dred_recovery.npz's
   packets (RDOVAE 42, statistics 43): ``rate_pcm<k>`` [9, 60 fs / 1000].
4. ``loop``: ``opus_demo.decode``'s loop with ``-dred`` (the scalar
   ``OpusDecoder(48000, 1)`` with ``load_deep_plc`` and
   ``OpusDREDDecoder``; opus_demo's models: RDOVAE 31 / 32, statistics
   33, PLC 34, pitch DNN 35, FARGAN 36) over 8 streams.  The packets
   (``packets`` [8, FRAMES, L], ``packet_lens``) come from a 48 kHz
   restricted-lowdelay ``OpusEncoder`` at 64 kb/s (VBR) with DRED of
   duration 40 on speech-like input; the flags over the first ``LOOP``
   frames are ``-sim_loss 10`` (streams 0-3, ``LossGen(random_model(33),
   500 + i)``) and ``-loss 10`` (streams 4-7, ``default_rng(500 +
   i).random(n) < 0.1``), none before ``dred_from`` (the first frame from
   which every packet carries DRED).  Stored: ``loop_lost`` [8, LOOP],
   the final range after each received packet (``loop_range``, 0 when
   lost), the float PCM of each (``loop_celt`` [8, LOOP, 960]), the
   concealed int16 of each lost frame that a later packet's DRED
   concealed (``loop_conc`` [8, LOOP, 960], ``loop_concealed``), and the
   span still pending at the end (``loop_pending`` [8] samples: the
   reference conceals it with the classic PLC, which the port lacks).

Run from the repository root (~4 min, 4 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_sim_loss_fixture.py
"""

from __future__ import annotations

import copy
import multiprocessing as mp
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_sim_loss.npz")
DRED_FIXTURE = os.path.join(REPO, "tests", "data", "torch_dred_recovery.npz")
PLC_FIXTURE = os.path.join(REPO, "tests", "data", "torch_deep_plc.npz")
LOSSGEN_SEED = 33
LG_SEEDS = tuple(range(100, 108))
LG_STEPS = 200
LF_SEEDS = (7, 8)
PLC_SEEDS = dict(plc=44, pitch=45, fargan=46)
TICKS = 16
PLC_LOSS = 30.0
RESET_TICK, RESET_LANES = 8, (0, 3, 6)
RATES = (8000, 12000, 24000)
DEMO_SEEDS = dict(enc=31, dec=32, stats=33, plc=34, pitch=35, fargan=36)
STREAMS, FRAMES, LOOP = 8, 24, 12
LOSS_PERC = 10.0


def lossgen_flags(seed: int, n: int, perc: float) -> np.ndarray:
    from opus_tpu.dnn import lossgen
    gen = lossgen.LossGen(lossgen.random_model(LOSSGEN_SEED), seed=seed)
    return np.array([gen.sample(perc) != 0 for _ in range(n)], bool)


def part_lossgen():
    from opus_tpu.tools.opus_demo import _loss_flags
    return dict(lg_flags=np.stack([lossgen_flags(s, LG_STEPS, LOSS_PERC)
                                   for s in LG_SEEDS]),
                lg_seeds=np.asarray(LG_SEEDS),
                lf_flags=np.stack([_loss_flags(40, 0, LOSS_PERC, None, None,
                                               seed=s) for s in LF_SEEDS]),
                lf_seeds=np.asarray(LF_SEEDS))


def part_plc():
    from opus_tpu.dnn import fargan as fg, pitchdnn as pdnn, plc as plcmod
    from chip_smoke import speech_history

    models = (plcmod.random_model(PLC_SEEDS["plc"]),
              pdnn.random_model(PLC_SEEDS["pitch"]),
              fg.random_model(PLC_SEEDS["fargan"]))
    n = 8
    hist = speech_history(n, 7, TICKS)
    lost = np.stack([lossgen_flags(300 + i, TICKS, PLC_LOSS)
                     for i in range(n)])
    keys = ("period", "loss_count", "analysis_pos", "predict_pos", "blend",
            "analysis_gap")
    out = dict(plc_pcm=np.zeros((n, TICKS, 160), np.int16),
               plc_feats=np.zeros((n, TICKS, 36), np.float32),
               **{f"plc_{k}": np.zeros((n, TICKS), np.int32) for k in keys})
    for i in range(n):
        lp = plcmod.LPCNetPLC(*models)
        for t in range(TICKS):
            if t == RESET_TICK and i in RESET_LANES:
                lp.reset()
            if lost[i, t]:
                o = np.zeros(160, np.int16)
                lp.conceal(o)
                out["plc_pcm"][i, t] = o
            else:
                lp.update(hist[i, t])
            out["plc_feats"][i, t] = lp.features
            out["plc_period"][i, t] = int(np.asarray(lp.fargan.last_period))
            for k in keys[1:]:
                out[f"plc_{k}"][i, t] = int(getattr(lp, k))
    return dict(plc_hist=hist, plc_lost=lost, **out)


def _fixture_dreds(ddec):
    from opus_tpu.dnn import rdovae
    from opus_tpu.dnn.dred_dec import OpusDRED
    dfx = np.load(DRED_FIXTURE)
    dreds = []
    for i in range(len(dfx["lens"])):
        d, _ = ddec.parse(bytes(dfx["packets"][i, :dfx["lens"][i]]), 16000,
                          16000)
        dreds.append(ddec.process(d) if d is not None else OpusDRED(
            2, 0, 0, np.zeros(rdovae.DRED_STATE_DIM, np.float32),
            np.zeros((0, rdovae.DRED_LATENT_DIM + 1), np.float32),
            np.zeros((0, 20), np.float32)))
    return dreds


def part_rates():
    from opus_tpu.dnn import dred as dredmod, fargan as fg
    from opus_tpu.dnn import pitchdnn as pdnn, plc as plcmod, rdovae
    from opus_tpu.dnn.dred_dec import OpusDREDDecoder
    from opus_tpu.models.opus_decoder import OpusDecoder
    from chip_smoke import rate_offsets

    pfx = np.load(PLC_FIXTURE)
    ddec = OpusDREDDecoder(rdovae.random_dec_model(42),
                           dredmod.random_stats(43))
    dreds = _fixture_dreds(ddec)
    models = (plcmod.random_model(PLC_SEEDS["plc"]),
              pdnn.random_model(PLC_SEEDS["pitch"]),
              fg.random_model(PLC_SEEDS["fargan"]))
    out = {}
    for s in range(len(dreds)):
        lp = plcmod.LPCNetPLC(*models)
        for k in range(16):
            lp.update(pfx["hist"][s, k])
        for fs in RATES:
            dec = OpusDecoder(fs, 1)
            dec.lpcnet = copy.deepcopy(lp)
            off = int(rate_offsets(pfx["off48"][s:s + 1], fs)[0])
            out.setdefault(f"rate_pcm{fs // 1000}", []).append(
                dec.dred_decode(dreds[s], off, 6 * fs // 100))
    res = {k: np.stack(v) for k, v in out.items()}
    for fs in RATES:
        res[f"rate_off{fs // 1000}"] = rate_offsets(pfx["off48"], fs)
    return res


def part_loop():
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.dnn import dred as dredmod, fargan as fg
    from opus_tpu.dnn import pitchdnn as pdnn, plc as plcmod, rdovae
    from opus_tpu.dnn.dred_dec import OpusDREDDecoder, dred_find_payload
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.models.opus_encoder import OpusEncoder
    from make_torch_dred_enc_fixture import speech

    s = DEMO_SEEDS
    enc_m, dec_m = rdovae.random_enc_model(s["enc"]), \
        rdovae.random_dec_model(s["dec"])
    stats = dredmod.random_stats(s["stats"])
    pitch = pdnn.random_model(s["pitch"])
    plc_m, fg_m = plcmod.random_model(s["plc"]), fg.random_model(s["fargan"])
    packets = []
    for i in range(STREAMS):
        enc = OpusEncoder(48000, 1, "restricted-lowdelay")
        enc.set_bitrate(64000)
        enc.enable_dred(enc_m, pitch, stats, 40)
        x = speech(48000, FRAMES * 960, 40 + i)
        packets.append([enc.encode(x[f * 960:(f + 1) * 960], 960, 1276)
                        for f in range(FRAMES)])
    has = np.array([[dred_find_payload(p) is not None for p in row]
                    for row in packets])
    dred_from = int(np.nonzero(has.all(axis=0))[0].min())
    if not has[:, dred_from:].all():
        raise SystemExit("a packet after dred_from carries no DRED")
    lost = np.zeros((STREAMS, LOOP), bool)
    for i in range(STREAMS):
        if i < STREAMS // 2:
            lost[i] = lossgen_flags(500 + i, LOOP, LOSS_PERC)
        else:
            lost[i] = np.random.default_rng(500 + i).random(LOOP) \
                < LOSS_PERC / 100.0
    lost[:, :dred_from] = False

    out = dict(loop_range=np.zeros((STREAMS, LOOP), np.uint32),
               loop_celt=np.zeros((STREAMS, LOOP, 960), np.float32),
               loop_conc=np.zeros((STREAMS, LOOP, 960), np.int16),
               loop_concealed=np.zeros((STREAMS, LOOP), bool),
               loop_pending=np.zeros(STREAMS, np.int64))
    for i in range(STREAMS):
        dec = OpusDecoder(48000, 1)
        dec.load_deep_plc(plc_m, pitch, fg_m)
        ddec = OpusDREDDecoder(dec_m, stats)
        pending = []
        for f in range(LOOP):
            p = packets[i][f]
            if lost[i, f]:
                pending.append(f)
                continue
            if pending:
                n = 960 * len(pending)
                d, _ = ddec.parse(p, n, 48000, defer_processing=False)
                if d is None:
                    raise SystemExit(f"stream {i} frame {f}: no DRED")
                conc = dec.dred_decode(d, n, n).reshape(len(pending), 960)
                out["loop_conc"][i, pending] = conc
                out["loop_concealed"][i, pending] = True
                pending = []
            out["loop_celt"][i, f] = dec.decode(p)
            out["loop_range"][i, f] = dec.rangeFinal
            if pkt.packet_get_nb_samples(p, 48000) != 960:
                raise SystemExit("not a 20 ms packet")
        out["loop_pending"][i] = 960 * len(pending)
    width = max(len(p) for row in packets for p in row)
    buf = np.zeros((STREAMS, FRAMES, width), np.uint8)
    lens = np.zeros((STREAMS, FRAMES), np.int32)
    for i in range(STREAMS):
        for f in range(FRAMES):
            buf[i, f, :len(packets[i][f])] = np.frombuffer(packets[i][f],
                                                           np.uint8)
            lens[i, f] = len(packets[i][f])
    return dict(packets=buf, packet_lens=lens, dred_from=dred_from,
                loop_lost=lost, **out)


PARTS = dict(lossgen=part_lossgen, plc=part_plc, rates=part_rates,
             loop=part_loop)


def _run(name):
    t0 = time.time()
    res = PARTS[name]()
    print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    return res


def main():
    t0 = time.time()
    with mp.get_context("spawn").Pool(4) as pool:
        parts = pool.map(_run, list(PARTS))
    arrays = {}
    for p in parts:
        arrays.update(p)
    lost = arrays["loop_lost"]
    print(f"loop: DRED on every packet from frame {arrays['dred_from']}; "
          f"{int(lost.sum())} of {lost.size} packets lost, "
          f"{int(arrays['loop_concealed'].sum())} concealed, pending at the "
          f"end {arrays['loop_pending'].tolist()}; packets up to "
          f"{arrays['packets'].shape[2]} bytes")
    print(f"plc: {int(arrays['plc_lost'].sum())} of "
          f"{arrays['plc_lost'].size} ticks lost")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
