"""Writes tests/data/torch_deep_plc.npz: the JAX package's deep-PLC outputs
(``OpusDecoder.load_deep_plc`` + ``dred_decode``, ``LPCNetPLC``) on the
nine streams of tests/data/torch_dred_recovery.npz, the reference of
tests/test_torch_deep_plc.py and of chip_smoke.py's deep-PLC phase.

Models from seeds (random weights at the published widths): PLC network
44, pitch DNN 45, FARGAN 46, RDOVAE decoder 42, DRED statistics 43.  Each
stream's packet is parsed and processed by ``OpusDREDDecoder``; the packet
without DRED gets an empty OpusDRED (nb_latents 0), which queues skips
only, so that stream conceals on prediction alone.

The sequence, the same on every stream (``chip_smoke.deep_plc_sequence``
drives the port through it):
1. 16 good 10 ms frames of seeded speech-like int16
   (``chip_smoke.speech_history``) through ``lpcnet.update``;
2. ``dred_decode`` of 60 ms at 48 kHz at the stream's ``off48`` (6
   concealed frames, the blend == 0 catch-up analysis first);
3. 2 more ``update``s, ``fec_clear`` and 2 ``conceal``s (prediction only);
4. ``dred_decode`` of 20 ms at 16 kHz at ``off16`` (the same LPCNetPLC,
   through an ``OpusDecoder(16000, 1)``).

Stored: the inputs (``hist`` [9, 18, 160] int16, ``off48``, ``off16``) and
the outputs: ``pcm48`` [9, 2880] and the 16 kHz pieces behind it
(``pcm48_16k`` [9, 960]), ``pcm_pred`` [9, 320], ``pcm16`` [9, 320] (int16);
the features after each of the 10 concealed frames (``feats`` [9, 10, 36])
with their FARGAN periods (``period``), FEC read positions and loss
counts; every analysed frame's features (``afeats`` [9, 23, 36]) and
pitch periods (``apitch``).

Run from the repository root (about a minute, one process):
    JAX_PLATFORMS=cpu python tools/make_torch_deep_plc_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DRED_FIXTURE = os.path.join(REPO, "tests", "data", "torch_dred_recovery.npz")
OUT = os.path.join(REPO, "tests", "data", "torch_deep_plc.npz")
SEEDS = dict(plc=44, pitch=45, fargan=46, dec=42, stats=43)
N_HIST, N_MORE = 16, 2
# per stream: the step-2 offset in 10 ms frames (the last ones past the
# DRED window: skips before the rows) and the step-4 offset
K48 = (2, 3, 4, 9, 26, 30, 0, 5, 3)
K16 = (3, 0, 5, 1, 20, 25, 2, 4, 1)


def offsets(n_streams: int):
    """(off48, off16) in samples: whole frames plus a seeded remainder."""
    i = np.arange(n_streams)
    k48 = np.asarray(K48)[i % len(K48)]
    k16 = np.asarray(K16)[i % len(K16)]
    return k48 * 480 + (i * 97) % 480, k16 * 160 + (i * 53) % 160


def main():
    from opus_tpu.dnn import dred as dredmod, fargan as fg, features as feat
    from opus_tpu.dnn import pitchdnn as pdnn, plc as plcmod, rdovae
    from opus_tpu.dnn.dred_dec import OpusDRED, OpusDREDDecoder
    from opus_tpu.models.opus_decoder import OpusDecoder
    from chip_smoke import speech_history

    t0 = time.time()
    dfx = np.load(DRED_FIXTURE)
    packets = [bytes(dfx["packets"][i, :dfx["lens"][i]])
               for i in range(len(dfx["lens"]))]
    b = len(packets)
    ddec = OpusDREDDecoder(rdovae.random_dec_model(SEEDS["dec"]),
                           dredmod.random_stats(SEEDS["stats"]))
    dreds = []
    for p in packets:
        d, _ = ddec.parse(p, 16000, 16000)
        dreds.append(ddec.process(d) if d is not None else OpusDRED(
            2, 0, 0, np.zeros(rdovae.DRED_STATE_DIM, np.float32),
            np.zeros((0, rdovae.DRED_LATENT_DIM + 1), np.float32),
            np.zeros((0, 20), np.float32)))
    models = (plcmod.random_model(SEEDS["plc"]),
              pdnn.random_model(SEEDS["pitch"]),
              fg.random_model(SEEDS["fargan"]))
    hist = speech_history(b, 3, N_HIST + N_MORE)
    off48, off16 = offsets(b)

    analysed = []
    orig_cff = feat.compute_frame_features

    def cff(st, pcm, model):
        st, f = orig_cff(st, pcm, model)
        analysed[-1].append(f.copy())       # conceal writes into f later
        return st, f

    feat.compute_frame_features = cff
    out = {k: [] for k in ("pcm48", "pcm48_16k", "pcm_pred", "pcm16",
                           "feats", "fec_read", "loss", "afeats")}
    for s in range(b):
        analysed.append([])
        dec = OpusDecoder(48000, 1)
        dec.load_deep_plc(*models)
        lp = dec.lpcnet
        log = []
        conceal = lp.conceal

        def logged(pcm_out, conceal=conceal, lp=lp, log=log):
            conceal(pcm_out)
            log.append((pcm_out.copy(), lp.features.copy(),
                        lp.fec_read_pos, lp.loss_count))

        lp.conceal = logged
        for k in range(N_HIST):
            lp.update(hist[s, k])
        out["pcm48"].append(dec.dred_decode(dreds[s], int(off48[s]), 2880))
        for k in range(N_HIST, N_HIST + N_MORE):
            lp.update(hist[s, k])
        lp.fec_clear()
        pred = []
        for _ in range(2):
            o = np.zeros(160, np.int16)
            lp.conceal(o)
            pred.append(o)
        dec16 = OpusDecoder(16000, 1)
        dec16.lpcnet = lp
        out["pcm16"].append(dec16.dred_decode(dreds[s], int(off16[s]), 320))
        out["pcm_pred"].append(np.concatenate(pred))
        out["pcm48_16k"].append(np.concatenate([e[0] for e in log[:6]]))
        out["feats"].append(np.stack([e[1] for e in log]))
        out["fec_read"].append(np.array([e[2] for e in log], np.int32))
        out["loss"].append(np.array([e[3] for e in log], np.int32))
        out["afeats"].append(np.stack(analysed[-1]))
        print(f"stream {s}: nb_latents {dreds[s].nb_latents}, dred_offset "
              f"{dreds[s].dred_offset}, off48 {off48[s]}, off16 {off16[s]}, "
              f"FEC reads {out['fec_read'][-1].tolist()}, "
              f"{time.time() - t0:.1f} s")
    feat.compute_frame_features = orig_cff
    arrays = {k: np.stack(v) for k, v in out.items()}
    a = arrays["afeats"][:, :, 18].astype(np.float64)
    arrays["apitch"] = np.floor(0.5 + 256.0 / 2.0 ** (
        (1.0 / 60) * ((a + 1.5) * 60))).astype(np.int32)
    arrays["period"] = np.asarray(fg.period_from_feature(arrays["feats"]),
                                  np.int32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, hist=hist, off48=off48, off16=off16,
                        nb_latents=np.array([d.nb_latents for d in dreds]),
                        **arrays)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
