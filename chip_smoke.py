#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path, 20 ms mono CELT at 48 kHz and 64 kb/s CBR
(160-byte packets), in both directions, for 8 consecutive frames:

1. requires CUDA and prints the card's name and power limit;
2. builds the kernels from ``opus_tpu_torch/csrc`` (nvcc, sm_90a);
3. decode (packets -> PCM, ``KernelCeltDecoder``) over 4096 streams plus
   32 garbage/truncated ones: kernel K1 (the symbol pass) and K2
   (de-emphasis) against their plain torch versions, frame by frame with
   state carried; the decoder end to end with the launch counters reset,
   against the scalar decoder's outputs stored in
   ``tests/data/torch_celt20ms_64k.npz``;
4. encode (PCM -> packets, ``KernelCeltEncoder``) over 4096 fixture
   streams plus 32 hard ones (silence, full-scale noise, clipped input,
   a DC step, impulses, 1e-7 noise): kernel K3 (the encode symbol pass)
   against its plain torch version, frame by frame with state carried;
   the encoder end to end with its launch counter reset; then the encoder
   at 320 bytes a frame (128 kb/s) over the same lanes, K3 against its
   plain version on every frame, its packets decoded on the card to the
   encoder's final range;
5. the duplex chain: the encoder's packets (equal to the encode run's) go
   straight into the decoder on the card, launch counters reset around
   it; final ranges, error lanes and SNR against the JAX twin's, stored in
   ``tests/data/torch_celt20ms_64k_enc.npz``;
6. times K1 and K3 (at B and at 4 x B streams; K3 also at 320 bytes), K2,
   their plain versions, the encoder front end and the encode, decode and
   duplex steps with CUDA events, K2 also by its device time alone
   (``opus_tpu_torch/tools/device_time.py``), and prints K1's, K3's and
   K4's launch geometry (registers, local memory, shared memory per
   block, resident warps per SM; K4 with ptxas's stack and spills, which
   must be 0);
7. SILK (``FusedSilkDecoder``, packets -> int16 PCM, wideband 20 ms,
   24 kb/s) over 4096 streams plus 32 garbage/truncated ones from
   ``tests/data/torch_silk16k_24k.npz``: the fixed-point helpers
   (``ops/silk_fixed.py``) on the card against the CPU; kernel K4 (the
   LPC synthesis) against its plain version on every subframe of the plain
   chain and on extreme inputs at sf 40/60/80; the decoder end to end with
   the launch counter reset, against the scalar decoder's PCM and final
   ranges; K4's device time alone at B and 4 x B streams (sf 80) and at
   sf 40 and 60 (each result held to the plain version), its time a call,
   and CUDA event times of the SILK step and its symbol pass;
8. hybrid (``FusedHybridDecoder``, packets -> 48 kHz PCM, SILK-WB plus
   CELT bands 17-20, fullband 20 ms) over 4096 streams plus 32
   garbage/truncated ones from ``tests/data/torch_hybrid_fb20ms.npz``:
   kernel K1 at start band 17, continuing SILK's range decoder, against
   its plain version frame by frame; the decoder end to end with the
   launch counters reset (K1, K2 and K4), against the scalar decoder's
   final ranges and PCM; CUDA event times of the hybrid step and of its
   SILK, CELT and resampler parts;
9. superwideband hybrid (``FusedHybridDecoder(end=19)``, CELT bands
   17-18) over 4096 streams plus 32 garbage/truncated ones from
   ``tests/data/torch_hybrid_swb20ms.npz``: K1 at start 17 / end 19
   against its plain version frame by frame, then the decoder end to end
   with the launch counters reset (K1, K2 and K4), against the scalar
   decoder's final ranges and PCM;
10. DRED loss recovery (``BatchedDREDRecovery``, tracked config 5,
   bench.py:378-410) over 1024 streams: the DRED fixture's packets
   (``tests/data/torch_dred_recovery.npz``) parsed on the host exactly as
   the JAX package parsed them, tiled, plus random latents as bench.py
   builds them; the recovery with the K2 counter reset, its PCM against
   the port's CPU run on every lane and the JAX package's stored output
   on the fixture lanes, the FARGAN pitch periods equal on the card and
   the CPU, K2 against its plain version at FARGAN's shape; CUDA event
   times of ``fargan_batch_step`` and ``recover`` with their device
   operations and busy share;
11. deep PLC (``BatchedDeepPLC``, tracked config 5's concealment half)
   over the same 1024 streams: the fixture lanes' packets through
   ``OpusDREDDecoder.parse`` and every lane's DRED through
   ``process_batch`` on the card, 16 + 2 frames of seeded speech-like
   history per lane, the sequence of ``tests/data/torch_deep_plc.npz``
   (``dred_decode`` of 60 ms at 48 kHz with the catch-up analysis, 2 good
   frames, 2 concealed frames on prediction alone, ``dred_decode`` of
   20 ms at 16 kHz) with the K2 counter reset around it; every pitch
   period, FARGAN period, FEC read position and loss count equal to the
   port's CPU run (every lane) and to the JAX package's stored output
   (fixture lanes), PCM within 1 LSB at 16 kHz and 4 at 48 kHz, the
   features within 2e-3; K2 against its plain version on every
   de-emphasis call of a second run; CUDA event times of ``dred_decode``,
   of one ``conceal`` and of each stage of ``dred_decode``, with their
   device operations and busy share;
12. OSCE (LACE and NoLACE, ``FusedSilkDecoder.set_osce``) over 1024
   streams of the SILK fixture plus 32 garbage/truncated ones: the lanes
   decoded once on the card (unenhanced PCM and num_bits equal to the
   scalar decoder's), enhanced by ``OSCEEnhancer`` with each method (K2
   against its plain version on every de-emphasis; periods and numbits
   exact, the first frame unenhanced, the enhanced int16 within
   ``osce_pcm_bound`` of ``tests/data/torch_osce_wb20ms.npz`` and of the
   port's CPU run), then the decoder end to end with OSCE on, once per
   method, with the K2 and K4 counters reset around it; CUDA event times
   of the decode without OSCE, with LACE and with NoLACE and of one
   enhancer frame alone, with their device operations and busy share;
13. kernel K5, the op-cost microbenchmarks
   (``opus_tpu_torch.tools.kbench_ops``): all 13 cases at the TPU's tile
   (1024 lanes in one block) and the main path's geometry (4096 lanes in
   64-thread blocks), each exactly equal to its plain version, the ns/op
   table, and each case's signature instruction count in the SASS;
14. 10 ms CELT (LM 2, 480 samples, 80-byte packets) over 4096 streams of
   ``tests/data/torch_celt10ms_64k.npz`` / ``torch_celt10ms_64k_enc.npz``
   plus 32 garbage or hard ones: K1 and K2 against their plain versions
   frame by frame, the decoder end to end against the scalar decoder,
   the encoder with K3 against its plain version on every frame and its
   packets decoded on the card to its final range (launch counters reset
   around each), and K1's and K3's times at 480;
15. tracked config 5's whole loop (``BatchedDREDEncoder``) over 1024
   streams at 48 kHz, 24 frames of 20 ms: the DRED encoder fixture's 8
   streams (``tests/data/torch_dred_enc.npz``) tiled, seeded speech-like
   lanes and lanes with digital silence; each frame K3 encodes the CELT
   frame and the DRED encoder takes its latents, the last two frames'
   packets carry the DRED payload in extension 126, the CELT frames are
   decoded by K1 and K2 to the encoder's final range (counters reset
   around the 24 frames), the DRED is parsed and recovered (K2); the 16
   kHz conversion bit for bit, latents and states, quantized integers,
   packets and parse against the port's CPU run and the JAX package's
   fixture; CUDA event times of ``compute_latents`` and its parts with
   their device operations and busy share, the quantizer, the host
   coder, ``attach`` and the chain frame;
16. BBWE (``dnn/bbwe.BBWE``, seed 70) alone over the standalone streams
   of ``tests/data/torch_bbwe.npz`` tiled to 1024 lanes plus 32 garbage
   ones (full-scale noise, clicks in silence), 8 frames, against the JAX
   fixture and the port's CPU run within ``bbwe_pcm_bound``; then the
   SILK fixture tiled to 1024 + 32 lanes through
   ``FusedSilkDecoder(fs_out=48000)`` end to end, plain (int16 and final
   range bit for bit against the scalar decoder and the CPU run), with
   BBWE and with NoLACE + BBWE, the K2 and K4 counters reset around each
   (half the fixture lanes hand the scalar decoder's enhanced frames on
   to BBWE, ``feed_enhanced``);
17. OSCE on hybrid frames: the FB and SWB hybrid fixtures tiled to 1024 +
   32 lanes through ``FusedHybridDecoder`` with LACE and with NoLACE,
   each without and with BBWE, 8 frames, the K1, K2 and K4 counters reset
   around each and K2 held to its plain version on OSCE's de-emphasis:
   final ranges equal to the scalar decoder's and the enhanced SILK half
   within ``osce_pcm_bound`` on every frame, the PCM of the first 3
   within ``hybrid_pcm_bound`` (half the fixture lanes fed as above); CUDA
   event times of one BBWE frame alone (with its device operations and
   busy share), of the 48 kHz SILK decode without and with BBWE and of
   the FB hybrid decode with NoLACE and with NoLACE + BBWE;
18. per-lane loss on the decode side (``tools/sim_loss.py``), opus_demo's
   loss loop over 1024 streams with a loss pattern each: with ``-dred``
   (sim_loss), per-lane deep PLC state (plc_lanes) and ``dred_decode`` at
   8/12/24 kHz (plc_rates), and the classic CELT concealment (celt_plc):
   the plain loop over 24 ticks and the ``-dred`` loop over 12 with DRED
   stripped from every fourth packet on a quarter of the lanes, each with
   ``flush()``, K1 and K2 counted, held to the port's CPU runs on every
   lane and to the JAX package's loops (``tests/data/torch_celt_plc.npz``)
   on the fixture lanes; CUDA event times of a tick with and without
   concealing lanes, with their device operations and busy share;
19. the SILK classic concealment, comfort noise and in-band FEC, hybrid
   and DTX frames under loss (silk_plc): opus_demo's plain and
   ``-inbandfec`` loops over 1024 SILK-WB lanes each and 1024 FB hybrid
   lanes each (one ``BatchedLossDecoder(mode=...)`` of 2048 lanes a mode,
   the two loops on the same traffic: ``tests/data/torch_silk_plc.npz``'s
   streams tiled, sim_loss's flags, the 8 fixture lanes under their
   fixture patterns), ``SILK_PLC_TICKS`` ticks and ``flush()``, the K1,
   K2 and K4 counters reset around each and held to the count its calls
   imply; slot kinds, final ranges, loss counts and SILK int16 equal to
   the port's CPU run (the fixture lanes and 48 more, in worker processes
   beside the card) and to the JAX package's loops on the fixture lanes,
   hybrid int16 within ``CLASSIC_LSB``; CUDA event times of a SILK-WB tick
   with no lost lane, with a tenth of the lanes' first and second loss
   and with their resume through LBRR, with device operations and busy
   share;
20. the top-level decoder (``BatchedOpusDecoder``, opus_api) over 1024
   lanes of ``tests/data/torch_opus_api.npz``'s mixed mono traffic at two
   packet offsets with losses and in-band FEC, API_TICKS calls: K1 (LM
   0-3), K2 and K4 counted, held to the port's CPU run and the JAX
   decoder; K1 at LM 0/1 against its plain version; the soft clip;
21. stereo and 40/60 ms SILK (opus_stereo): ``BatchedOpusDecoder(
   channels=2)`` over 1024 lanes and ``channels=1`` over 256 of
   ``tests/data/torch_opus_stereo.npz``'s streams (mono SILK at 40/60
   ms, stereo CELT, SILK and hybrid, a stereo <-> mono stream; losses and
   FEC), every other group of 8 lanes from a later step of each stream,
   STEREO_TICKS calls (the first timed, the last traced: operations,
   device time, busy share) and STEREO_MONO_TICKS calls, the counters of
   K1's mono and stereo instantiations, K2 and K4 reset around each, held
   to the port's CPU runs and the JAX decoder at one and two channels,
   with the fixture test's events (the stereo -> mono switch and the
   stereo SILK concealment among them); K1's stereo instantiation
   against its plain version on the inputs the run gave it (LM 0-3,
   start 0 and 17) tiled to 4096 + 32 lanes, disable_inv 0 and 1; K1
   stereo's time, bound and geometry beside the mono instantiation's;
22. every output rate (opus_rates): ``BatchedOpusDecoder(fs=8000, 12000,
   16000, 24000)`` over 256 lanes of the api fixture's traffic (losses,
   in-band FEC) for RATES_TICKS calls a rate, and ``channels=2`` at 24
   kHz over 256 lanes of the stereo fixture's; K1, K2 and K4 counted
   around each, held to the port's CPU runs (int16 and decode24) and on
   the fixture lanes to the JAX decoder at the same rate
   (``tests/data/torch_opus_rates.npz``: ranges, SILK int16 and decode24
   by digest, PCM within 1e-4); opus_api's 1024-lane traffic timed at 16
   kHz (CUDA events, the last tick traced);
23. multistream and projection (opus_ms): ``BatchedOpusMSDecoder`` over
   256 5.1 streams (512 stereo and 512 mono elementary lanes) and
   ``BatchedOpusProjectionDecoder`` over 256 first-order ambisonic
   streams, MS_TICKS calls, the counters around each, held to the JAX
   decoders (``tests/data/torch_opus_ms.npz``: the elementary ranges, PCM,
   the SILK stream's channel exact, the Q15 demix of JAX's internal int16
   equal to JAX's int16) and to the port's CPU run; the 5.1 cell timed.

The script's host, not its card, sets its pace: a second process on the
card runs items 4 and 5 (the encoder and duplex), 7 (SILK), 8 and 9
(both hybrids) and 14 (10 ms CELT) while this one runs the others, then
items 20 and 21's untimed runs beside the loss phases; a third runs
items 22 and 23's untimed card runs from the start, their CPU references
in two worker processes; every timing phase runs after all three have
finished, alone on the card.

Run from the repository root:  python3 chip_smoke.py
The last line of standard output is the result JSON; any failed check
exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_celt20ms_64k.npz")
ENC_FIXTURE = os.path.join(REPO, "tests", "data",
                           "torch_celt20ms_64k_enc.npz")
SILK_FIXTURE = os.path.join(REPO, "tests", "data", "torch_silk16k_24k.npz")
HYB_FIXTURE = os.path.join(REPO, "tests", "data", "torch_hybrid_fb20ms.npz")
SWB_FIXTURE = os.path.join(REPO, "tests", "data", "torch_hybrid_swb20ms.npz")
DRED_FIXTURE = os.path.join(REPO, "tests", "data", "torch_dred_recovery.npz")
B_MAIN = 4096            # fixture streams tiled over the main batch
N_BAD = 32               # garbage and truncated lanes appended
NFRAMES = 8

# Tolerances, each from an f32 ULP budget (u = 2**-24 ~ 6e-8):
# K1 vs plain: the symbol decisions are integer and must be identical; X
# differs only in the order of a band's sums (renormalisation, rotation
# angles from cosf vs torch.cos, each a few u), so 1e-5 of the band
# maximum leaves two decades of room.  Energies are the same f32
# additions in the same order: 1e-5 absolute.
X_REL_TOL = 1e-5
E_ABS_TOL = 1e-5
# K2 vs plain: the plain form is a 128-term f32 dot product per sample,
# error <= 128 u = 7.6e-6 of sum|c^k x| <= max|x| / (1 - c); the serial
# kernel adds <= u / (1 - c).  Bound: 1e-5 * max|x| / (1 - c) per stream.
K2_REL_TOL = 1e-5
# Port PCM vs the scalar (float64) decoder on PCM in [-1, 1]: the f32
# IMDCT is an 800-term dot product (<= 800 u * sum|terms|, ~1e-5 worst
# case at full scale), the comb filter and de-emphasis add a few u: 1e-4.
PCM_ABS_TOL = 1e-4
# K3 vs plain: payload bytes, final range, error and every integer output
# identical.  The float outputs (energy memory and error, delayed_intra)
# are the same f32 operations in the same order but for the wrap taps,
# which the plain version rounds from float64 instead of with fmaf (a
# double rounding, ~2**-29 likely per tap): a few ULPs of values below
# 64 (ULP 2**-18 = 3.8e-6), so 3e-5 absolute.
K3_F_TOL = 3e-5
# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
# memory rate and float32 rate outside the tensor cores, for bound_ms.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# int32 operations: 64 INT32 lanes per SM against 128 FP32 lanes (Hopper
# SM), so at most half the f32 rate
PEAK_I32_S = PEAK_F32_S / 2
# SILK is integer end to end: K4, the plain chain and the scalar decoder
# must agree exactly (no tolerance).
# DRED recovery (tracked config 5, bench.py:378-410): B_DNN streams, the
# DRED fixture's 9 tiled DRED_TILE times and the rest random latents as in
# bench.py (DRED_T chunks, dred_offset 8, loss offsets 2-4), N_CONCEAL
# concealed 10 ms frames.  The card's PCM against the port's CPU run (every
# lane) and the JAX package's stored output (fixture lanes): the JAX
# suite's own batched-vs-scalar bound, rtol 2e-4 / atol 2e-5
# (tests/test_dnn_recovery.py).  The card and the CPU differ only in the
# order of the f32 matmul sums (TF32 off), fed back through FARGAN's GRUs
# and exp(gain) over 28 subframes; the CPU tests measure 3.6e-7 against JAX.
B_DNN = 1024
DRED_TILE = 8
DRED_T = 4
N_CONCEAL = 6
DNN_RTOL, DNN_ATOL = 2e-4, 2e-5
# DRED encoder (tracked config 5's encode half): latents and states
# within the RDOVAE bound of tests/test_torch_dnn_models.py, card against
# the CPU run and the port against the JAX package: the feature analysis
# and the GEMMs sum in another order (TF32 off).  A quantized integer moves
# only if its value before rounding v = xq - delta tanh(xq / (delta +
# 0.1)), xq = x scale / 256, lies near a k + 0.5 boundary: dv/dx is
# scale / 256 times a factor in (0, 1], so a latent within the bound
# moves v by at most (DRED_ATOL + DRED_RTOL |x|) scale / 256 (near_half).
DRED_RTOL, DRED_ATOL = 2e-4, 2e-5


def near_half(v, x, scale):
    """Bool array: values before rounding v whose float inputs x could
    cross a k + 0.5 boundary within the latent bound (see DRED_RTOL)."""
    import numpy as np
    v = np.asarray(v, np.float64)
    margin = (DRED_ATOL + DRED_RTOL * np.abs(np.asarray(x, np.float64))) \
        * np.asarray(scale, np.float64) / 256.0
    return np.abs(v - np.floor(v) - 0.5) <= margin


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_lanes(fx, rng, b_main=B_MAIN):
    """[NFRAMES] of (buf [B, 160] uint8, lens [B]) numpy, plus the fixture
    stream index of each main lane.  Lanes >= b_main: 16 truncated
    fixture packets, then 16 of random bytes."""
    import numpy as np
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    b = b_main + N_BAD
    stream = np.arange(b_main) % ns
    out = []
    for f in range(NFRAMES):
        buf = np.zeros((b, p), np.uint8)
        ln = np.zeros(b, np.int64)
        buf[:b_main] = frames[stream, f]
        ln[:b_main] = lens[stream, f]
        for j in range(N_BAD):
            lane = b_main + j
            if j < N_BAD // 2:
                src = j % ns
                cut = int(rng.integers(0, lens[src, f]))
                buf[lane, :cut] = frames[src, f, :cut]
                ln[lane] = cut
            else:
                cut = int(rng.integers(0, p + 1))
                buf[lane, :cut] = rng.integers(0, 256, cut)
                ln[lane] = cut
        out.append((buf, ln))
    return out, stream


def compare_k1(got, ref, tabs, what=""):
    """Integer outputs identical; X (each channel's, at two channels) and
    energies within tolerance."""
    import torch
    from opus_tpu_torch.models.celt_dec_kernel import INT_KEYS
    for k in INT_KEYS:
        if not torch.equal(got[k], ref[k]):
            bad = (got[k] != ref[k]).nonzero()[:5, 0].tolist()
            fail(f"K1 vs plain{what}: {k} differs at lanes {bad}")
    e_err = (got["energies"] - ref["energies"]).abs().max().item()
    if not e_err <= E_ABS_TOL:
        fail(f"K1 vs plain{what}: energies err {e_err}")
    if not torch.equal(got["pf_gain"], ref["pf_gain"]):
        fail(f"K1 vs plain{what}: pf_gain differs")
    x_err = 0.0
    m, eb = tabs.M, tabs.eBands
    nx = ref["X"].shape[-1]
    for i in range(tabs.nb):
        a, c = m * int(eb[i]), m * int(eb[i + 1])
        xr = ref["X"].reshape(-1, nx)[:, a:c]
        xg = got["X"].reshape(-1, nx)[:, a:c]
        scale = xr.abs().amax(dim=1)
        diff = (xg - xr).abs().amax(dim=1)
        if not bool((diff <= X_REL_TOL * scale).all()):
            lane = int((diff - X_REL_TOL * scale).argmax())
            fail(f"K1 vs plain{what}: X band {i} row {lane} err "
                 f"{diff[lane].item()} (band max {scale[lane].item()})")
        x_err = max(x_err, diff.max().item())
    return x_err, e_err


def phase_kernel_vs_plain(lanes, dev, tabs):
    """Per frame, K1 and the plain symbol pass on the same inputs with the
    plain chain's state carried; K2 vs plain de-emphasis on the plain
    chain's synthesis signal.  Returns (per-frame plain outputs, errors,
    K2 inputs of frame 0)."""
    import torch
    import opus_tpu_torch.models.batched_decode as BD
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state
    from opus_tpu_torch.ops import iir

    coef = float(tabs.mode.preemph[0])
    captured = []

    def plain_deemph(x, mem, c):
        captured.append((x.clone(), mem.clone()))
        return iir.deemphasis_plain(x, mem, c)

    b = lanes[0][0].shape[0]
    state = fused_celt_init_state(b, tabs, dev)
    outs = []
    x_err = e_err = k2_err = k2_rel = 0.0
    saved = BD.deemphasis
    BD.deemphasis = plain_deemph
    try:
        for f, (buf, ln) in enumerate(lanes):
            buf_t = torch.from_numpy(buf).to(dev)
            ln_t = torch.from_numpy(ln).to(dev)
            prevmin = torch.minimum(state["prev1"], state["prev2"])
            got = CK.decode_frame(buf_t, ln_t, state["old_e"], prevmin,
                                  state["seed"], tabs)
            frame_out = {}

            def plain_fn(*args):
                frame_out.update(CK.decode_frame_plain(*args))
                return frame_out

            _pcm, state, _err = CK.kernel_celt_decode_to_pcm(
                buf_t, ln_t, state, tabs, frame_fn=plain_fn)
            torch.cuda.synchronize()
            xe, ee = compare_k1(got, frame_out, tabs)
            x_err, e_err = max(x_err, xe), max(e_err, ee)
            x, mem = captured[-1]
            y_k, m_k = iir.deemphasis(x, mem, coef)
            y_p, m_p = iir.deemphasis_plain(x, mem, coef)
            tol = K2_REL_TOL * x.abs().amax(dim=1) / (1.0 - coef)
            d = (y_k - y_p).abs().amax(dim=1)
            if not bool((d <= tol).all()) or not bool(
                    ((m_k - m_p).abs() <= tol).all()):
                fail(f"K2 vs plain: frame {f} err {d.max().item()}")
            k2_err = max(k2_err, d.max().item())
            k2_rel = max(k2_rel, (d / tol.clamp_min(1e-30)).max().item())
            outs.append({k: v for k, v in frame_out.items() if k != "X"})
            print(f"frame {f}: K1 == plain (ints exact, X err {xe:.3g}, "
                  f"E err {ee:.3g}); K2 err {d.max().item():.3g}")
    finally:
        BD.deemphasis = saved
    print(f"K2 vs plain: max err {k2_err:.3g} in y units (int16 scale; "
          f"garbage lanes reach large values), at most {k2_rel:.3g} of the "
          f"per-stream bound")
    return outs, x_err, e_err, k2_err, captured[0]


def phase_end_to_end(lanes, stream, fx, dev, plain_outs,
                     frame_size: int = 960):
    """The decoder as a user drives it, counters reset around the run."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir

    b, p = lanes[0][0].shape
    bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
            for bu, ln in lanes]
    dec = CK.KernelCeltDecoder(b, frame_size=frame_size, device=dev,
                               max_payload=p)
    frame_outs = []
    orig = CK.decode_frame

    def spy(*args):
        out = orig(*args)
        frame_outs.append(out)
        return out

    torch.cuda.synchronize()
    CK.launches = 0
    iir.launches = 0
    CK.decode_frame = spy
    try:
        for buf, ln in bufs:
            pcm, err = dec.decode_packed(buf, ln)
            frame_outs[-1]["pcm"] = pcm
            frame_outs[-1]["err"] = err
        torch.cuda.synchronize()
    finally:
        CK.decode_frame = orig
    counts = {"K1": CK.launches, "K2": iir.launches}
    print(f"launch counters over {NFRAMES} frames: {counts}")
    if counts != {"K1": NFRAMES, "K2": NFRAMES}:
        fail(f"expected one launch of K1 and K2 per frame, got {counts}")

    fr = fx["final_range"].astype(np.int64)
    ref_pcm = fx["pcm"]
    pcm_err = 0.0
    cov = dict(transient=0, postfilter=0, silence=0)
    for f, out in enumerate(frame_outs):
        rng = out["rng"].cpu().numpy()
        if not np.array_equal(rng[:B_MAIN], fr[stream, f]):
            bad = np.nonzero(rng[:B_MAIN] != fr[stream, f])[0][:5]
            fail(f"frame {f}: final range != scalar decoder at {bad}")
        errs = out["err"].cpu().numpy()
        if errs[:B_MAIN].any():
            fail(f"frame {f}: fixture lanes flagged as error")
        if not np.array_equal(out["error"].cpu().numpy(),
                              plain_outs[f]["error"].cpu().numpy()):
            fail(f"frame {f}: error lanes differ from the plain chain")
        for k in ("rng", "tell", "silence", "is_transient", "pf_pitch"):
            if not torch.equal(out[k], plain_outs[f][k]):
                fail(f"frame {f}: end-to-end {k} differs from the plain "
                     f"chain")
        pcm = out["pcm"][:B_MAIN, 0].cpu().numpy()
        e = float(np.abs(pcm - ref_pcm[stream, f]).max())
        if not np.isfinite(pcm).all() or not e <= PCM_ABS_TOL:
            fail(f"frame {f}: PCM err {e} vs scalar decoder")
        pcm_err = max(pcm_err, e)
        main = slice(0, B_MAIN)
        cov["transient"] += int(out["is_transient"][main].sum())
        cov["postfilter"] += int((out["pf_pitch"][main] > 0).sum())
        cov["silence"] += int(out["silence"][main].sum())
    bad_err = int(frame_outs[-1]["error"][B_MAIN:].sum())
    print(f"all {B_MAIN} x {NFRAMES} fixture lane-frames at the scalar "
          f"decoder's final range; PCM max err {pcm_err:.3g} "
          f"(bound {PCM_ABS_TOL}); no fixture error lanes; garbage lanes "
          f"error flags == plain ({bad_err} set in the last frame)")
    print(f"coverage (lane-frames of {B_MAIN * NFRAMES}): {cov}")
    return pcm_err, counts


def hard_signals(n_lanes: int, nframes: int, rng, frame_size: int = 960):
    """[n_lanes, nframes * frame_size] f32 numpy: digital silence,
    full-scale white noise, clipped input (|x| up to 4), a DC step,
    impulses and 1e-7-level noise, in turn."""
    import numpy as np
    total = nframes * frame_size
    out = np.zeros((n_lanes, total), np.float32)
    for j in range(n_lanes):
        kind = j % 6
        if kind == 1:
            out[j] = rng.uniform(-1, 1, total)
        elif kind == 2:
            out[j] = np.clip(3.0 * rng.standard_normal(total), -4, 4)
        elif kind == 3:
            out[j, total // 3:] = 0.5 if j % 4 else -0.9
        elif kind == 4:
            out[j, rng.integers(0, total, 6 + j % 5)] = 0.99
        elif kind == 5:
            out[j] = 1e-7 * rng.standard_normal(total)
    return out


def make_enc_lanes(efx, rng):
    """[NFRAMES] of pcm [B_MAIN + N_BAD, N] f32 numpy (N the fixture's
    frame size): the fixture's 8 streams tiled over B_MAIN lanes, then the
    hard lanes."""
    import numpy as np
    pcm = efx["pcm"]
    ns, _nf, n = pcm.shape
    hard = hard_signals(N_BAD, NFRAMES, rng, n).reshape(N_BAD, NFRAMES, n)
    stream = np.arange(B_MAIN) % ns
    return [np.concatenate([pcm[stream, f], hard[:, f]]) for f in
            range(NFRAMES)]


def compare_k3(got, ref):
    """Integer outputs identical; float outputs within K3_F_TOL."""
    import torch
    from opus_tpu_torch.models.celt_enc_kernel import INT_OUT
    for k in ("payload", "rng", "err") + INT_OUT:
        if not torch.equal(got[k].to(ref[k].dtype), ref[k]):
            bad = (got[k].to(ref[k].dtype) != ref[k]).reshape(
                ref[k].shape[0], -1).any(dim=1).nonzero()[:5, 0].tolist()
            fail(f"K3 vs plain: {k} differs at lanes {bad}")
    err = 0.0
    for k in ("old_e", "error", "delayed_intra"):
        e = (got[k] - ref[k]).abs().max().item()
        if not e <= K3_F_TOL:
            fail(f"K3 vs plain: {k} err {e}")
        err = max(err, e)
    return err


def phase_k3_vs_plain(enc_lanes, dev):
    """Per frame, K3 and the plain symbol pass on the same front-end
    outputs, with the plain chain's state carried."""
    import torch
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.models.celt_enc_fused import fused_celt_enc_init

    tabs = EK.enc_tabs()
    b = enc_lanes[0].shape[0]
    state = fused_celt_enc_init(b, tabs, dev)
    f_err = 0.0
    for f, pcm in enumerate(enc_lanes):
        ins, X, front = EK._front_end(torch.from_numpy(pcm).to(dev), state,
                                      tabs, 160)
        got = EK.encode_frame(X, ins, tabs, 160)
        ref = EK.encode_frame_plain(X, ins, tabs, 160)
        torch.cuda.synchronize()
        e = compare_k3(got, ref)
        f_err = max(f_err, e)
        state = EK._assemble_state(state, front, ref)
        print(f"frame {f}: K3 == plain (payload, rng, error, ints exact; "
              f"float err {e:.3g}); lanes flagged: "
              f"{int(ref['err'].sum())}, silence "
              f"{int(ins['silence'].sum())}, transient "
              f"{int(ins['is_transient'].sum())}")
    return f_err


def phase_encode(enc_lanes, dev):
    """KernelCeltEncoder alone over the 8 frames, its launch counter reset
    just before and read just after; no fixture lane flagged.  Returns
    the counts and each frame's (payload, range, error) for the duplex
    chain's encoder to equal."""
    import torch
    from opus_tpu_torch.models import celt_enc_kernel as EK

    b = enc_lanes[0].shape[0]
    pcm_in = [torch.from_numpy(p).to(dev) for p in enc_lanes]
    enc = EK.KernelCeltEncoder(b, device=dev)
    torch.cuda.synchronize()
    EK.launches = 0
    outs = [enc.encode_device(pcm) for pcm in pcm_in]
    torch.cuda.synchronize()
    counts = {"K3": EK.launches}
    print(f"encode launch counters over {NFRAMES} frames: {counts}")
    if counts != {"K3": NFRAMES}:
        fail(f"expected one launch of K3 per frame, got {counts}")
    for f, (_payload, _rng, err) in enumerate(outs):
        if err[:B_MAIN].any():
            fail(f"encode frame {f}: {int(err[:B_MAIN].sum())} fixture "
                 "lanes flagged")
    return counts, outs


def phase_duplex(enc_lanes, efx, dev, enc_outs):
    """KernelCeltEncoder feeds KernelCeltDecoder on the card, counters
    reset around the 8-frame run; its encoder's outputs equal the encode
    path's (enc_outs)."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.ops import iir
    from opus_tpu_torch.quality import best_snr

    b = enc_lanes[0].shape[0]
    pcm_in = [torch.from_numpy(p).to(dev) for p in enc_lanes]
    enc = EK.KernelCeltEncoder(b, device=dev)
    dec = CK.KernelCeltDecoder(b, device=dev, max_payload=160)
    lens = torch.full((b,), 160, dtype=torch.int64, device=dev)
    outs = []
    torch.cuda.synchronize()
    CK.launches = iir.launches = EK.launches = 0
    for pcm in pcm_in:
        payload, rng, err = enc.encode_device(pcm)
        out, derr = dec.decode_packed(payload, lens)
        outs.append((payload, rng, err, out, derr, dec.state["seed"]))
    torch.cuda.synchronize()
    counts = {"K1": CK.launches, "K2": iir.launches, "K3": EK.launches}
    print(f"duplex launch counters over {NFRAMES} frames: {counts}")
    if counts != {"K1": NFRAMES, "K2": NFRAMES, "K3": NFRAMES}:
        fail(f"expected one launch of K1, K2 and K3 per frame, got {counts}")

    ns = efx["pcm"].shape[0]
    same = 0
    dec_pcm = []
    for f, (payload, rng, err, out, derr, drng) in enumerate(outs):
        if not all(torch.equal(a, e) for a, e in
                   zip((payload, rng, err), enc_outs[f])):
            fail(f"frame {f}: the duplex encoder's payload, range or error "
                 "differs from the encode path's")
        err, derr = err.cpu().numpy(), derr.cpu().numpy()
        if err[:B_MAIN].any() or derr[:B_MAIN].any():
            fail(f"frame {f}: fixture lanes flagged (encoder "
                 f"{int(err[:B_MAIN].sum())}, decoder "
                 f"{int(derr[:B_MAIN].sum())})")
        ok = err == 0
        if not np.array_equal(rng.cpu().numpy()[ok], drng.cpu().numpy()[ok]):
            fail(f"frame {f}: decoder final range != encoder range")
        pcm = out[:, 0].cpu().numpy()
        if not np.isfinite(pcm).all():
            fail(f"frame {f}: non-finite decoded PCM")
        pay = payload[:B_MAIN].cpu().numpy()
        same += int((pay == efx["payload"][f][np.arange(B_MAIN) % ns])
                    .all(axis=1).sum())
        dec_pcm.append(pcm[:ns])
        print(f"frame {f}: decoder range == encoder range on {int(ok.sum())}"
              f" lanes; hard lanes flagged by the encoder: "
              f"{int(err[B_MAIN:].sum())}")
    dec_pcm = np.stack(dec_pcm, axis=1)             # [ns, NFRAMES, 960]
    snr = []
    for s_ in range(ns):
        v = best_snr(efx["pcm"][s_].reshape(-1), dec_pcm[s_].reshape(-1))
        if not v >= efx["snr"][s_] - 1.0:
            fail(f"stream {s_}: SNR {v:.2f} dB < JAX twin's "
                 f"{efx['snr'][s_]:.2f} - 1")
        snr.append(round(v, 2))
    print(f"duplex SNR per fixture stream {snr} dB (JAX twin "
          f"{[round(float(v), 2) for v in efx['snr']]}); payloads "
          f"byte-identical to the JAX twin: {same}/{B_MAIN * NFRAMES} "
          f"({same / (B_MAIN * NFRAMES):.4f})")
    return counts


def phase_encode_rate(enc_lanes, dev, nbytes: int):
    """KernelCeltEncoder at ``nbytes`` a frame over the 8 frames (of the
    lanes' frame size), state carried: on every frame K3 (spied on at its
    wrapper) equals the plain symbol pass on the same inputs, no fixture
    lane is flagged, and KernelCeltDecoder on the card reaches the
    encoder's final range on every lane-frame the encoder did not flag;
    the launch counters reset just before the run and read just after
    (the plain comparisons launch nothing).  Returns (K3's float error,
    the counts)."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.ops import iir

    b, n = enc_lanes[0].shape
    enc = EK.KernelCeltEncoder(b, frame_size=n, nbytes=nbytes, device=dev)
    dec = CK.KernelCeltDecoder(b, frame_size=n, device=dev,
                               max_payload=nbytes)
    lens = torch.full((b,), nbytes, dtype=torch.int64, device=dev)
    orig = EK.encode_frame
    f_err = 0.0
    torch.cuda.synchronize()
    CK.launches = iir.launches = EK.launches = 0

    def spy(X, ins, tabs, nb_):
        nonlocal f_err
        got = orig(X, ins, tabs, nb_)
        f_err = max(f_err, compare_k3(got, EK.encode_frame_plain(
            X, ins, tabs, nb_)))
        return got

    EK.encode_frame = spy
    try:
        for f, pcm in enumerate(enc_lanes):
            payload, rng, err = enc.encode_device(torch.from_numpy(pcm).to(
                dev))
            _pcm, derr = dec.decode_packed(payload, lens)
            torch.cuda.synchronize()
            if err[:B_MAIN].any():
                fail(f"{nbytes}-byte encode frame {f}: "
                     f"{int(err[:B_MAIN].sum())} fixture lanes flagged")
            ok = err == 0
            if not torch.equal(rng[ok], dec.state["seed"][ok]):
                fail(f"{nbytes}-byte frame {f}: decoder final range != "
                     "encoder range")
            if derr[ok].any():
                fail(f"{nbytes}-byte frame {f}: decoder flagged lanes")
            print(f"{nbytes} bytes, frame {f}: K3 == plain (payload, rng, "
                  f"error, ints exact); decoder range == encoder range on "
                  f"{int(ok.sum())} lanes; hard lanes flagged by the "
                  f"encoder: {int(err[B_MAIN:].sum())}")
        torch.cuda.synchronize()
    finally:
        EK.encode_frame = orig
    counts = {"K1": CK.launches, "K2": iir.launches, "K3": EK.launches}
    if counts != {"K1": NFRAMES, "K2": NFRAMES, "K3": NFRAMES}:
        fail(f"{nbytes}-byte encode and decode at N = {n}: expected one "
             f"launch of K1, K2 and K3 per frame, got {counts}")
    print(f"{nbytes}-byte encode at N = {n}: K3 float err {f_err:.3g} "
          f"(bound {K3_F_TOL}); launch counters {counts}")
    return f_err, counts


def nbytes_of(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k4_bound(b: int, sf: int) -> tuple:
    """K4's bound at B = b and subframe length sf.  Bytes: res, a_rev and
    slpc read, v and the new slpc written (int32).  Operations per sample:
    16 products, 16 shifts, 16 adds and ~6 for the saturating shift and
    add, at the int32 rate."""
    return bound(b * (2 * sf + 3 * 16) * 4, b * sf * 54.0, PEAK_I32_S)


def bound(nbytes: int, flops: float, peak_ops: float = PEAK_F32_S) -> tuple:
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over their peak
    rate (f32 unless given)."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak_ops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k1_bound(tabs, args, out) -> tuple:
    """K1's bound on ``decode_frame(*args)`` -> out.  Bytes: each input
    read once (packets, lens, energy memories, seeds, table), each output
    written once (X, energies, 9 int lanes, gain); operations: ~20 f32
    operations per coefficient (rotation, haar, renormalise; each
    channel's at two channels), an estimate from the source that stays
    below the bytes bound."""
    from opus_tpu_torch.models import celt_dec_kernel as CK
    buf, _ln, old_e, pm, seed = args[:5]
    b = buf.shape[0]
    tab = CK.k1_table(tabs, buf.device)
    nbytes = nbytes_of(buf, old_e, pm, seed, tab, out["X"], out["energies"],
                       out["pf_gain"]) + b * 4 * (1 + 9)
    return bound(nbytes, 20.0 * out["X"].numel())


def k3_bound(tabs, X, out) -> tuple:
    """(K3's bound on ``encode_frame(X, ...)`` -> out, the pulse-search
    score evaluations).  Bytes: X, the 2nb+1 float and 7+2nb int inputs,
    the tables; the payload, 2nb+1 float and 8 int outputs.  Operations:
    this run's pulse-search score evaluations (6 f32 operations each) and
    the wrap taps (2 per tap, 8 taps per coefficient)."""
    from opus_tpu_torch.models import celt_enc_kernel as EK
    itab, ftab = EK.k3_tables(tabs, X.device)
    b, nb = X.shape[0], tabs.nb
    nbytes = nbytes_of(X, itab, ftab, out["payload"]) \
        + b * 4 * ((2 * nb + 1) * 2 + (7 + 2 * nb) + 8)
    evals = float(out["search_evals"].sum().item())
    return bound(nbytes, 6.0 * evals + 16.0 * tabs.nx_rows * b), evals


def phase_times(lanes, dev, tabs, k2_in, smi):
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state
    from opus_tpu_torch.ops import iir
    from opus_tpu_torch.tools.device_time import device_ms

    buf = torch.from_numpy(lanes[0][0][:B_MAIN]).to(dev)
    ln = torch.from_numpy(lanes[0][1][:B_MAIN]).to(dev)
    st = fused_celt_init_state(B_MAIN, tabs, dev)
    pm = torch.minimum(st["prev1"], st["prev2"])
    args = (buf, ln, st["old_e"], pm, st["seed"], tabs)
    k1 = cuda_ms(lambda: CK.decode_frame(*args), 20)
    k1p = cuda_ms(lambda: CK.decode_frame_plain(*args), 1)
    out = CK.decode_frame(*args)
    k1_bnd = k1_bound(tabs, args, out)
    # the same frame tiled to 4 x B_MAIN streams: a time that stays flat
    # means the card had room at B_MAIN; a time per stream that stays flat
    # means B_MAIN already filled it
    big = 4 * B_MAIN
    st4 = fused_celt_init_state(big, tabs, dev)
    args4 = (buf.repeat(4, 1), ln.repeat(4), st4["old_e"],
             torch.minimum(st4["prev1"], st4["prev2"]), st4["seed"], tabs)
    k1_big = cuda_ms(lambda: CK.decode_frame(*args4), 20)
    out4 = CK.decode_frame(*args4)
    if not torch.equal(out4["rng"][:B_MAIN], out["rng"]):
        fail("K1 at 4 x B_MAIN: final ranges differ from B_MAIN's")
    k1_big_bound = k1_bound(tabs, args4, out4)
    print(f"K1 at B={big}: {k1_big:.4f} ms/frame, bound "
          f"{k1_big_bound[0]:.6f} ms ({k1_big_bound[1]}); per stream "
          f"{k1 / B_MAIN * 1e6:.2f} ns at B={B_MAIN}, "
          f"{k1_big / big * 1e6:.2f} ns at B={big}")
    x, mem = k2_in[0][:B_MAIN], k2_in[1][:B_MAIN]
    coef = float(tabs.mode.preemph[0])
    k2_call = cuda_ms(lambda: iir.deemphasis(x, mem, coef), 50)
    k2 = device_ms(lambda: iir.deemphasis(x, mem, coef), "deemphasis_kernel")
    k2p = cuda_ms(lambda: iir.deemphasis_plain(x, mem, coef), 50)
    k2_bound = bound(2 * nbytes_of(x, mem), 2.0 * x.numel())
    print(f"K2 at B={B_MAIN}: device time {k2:.5f} ms a launch (profiler "
          f"records), {k2_call:.5f} ms a call (events around 50 calls); "
          f"bound {k2_bound[0]:.6f} ms ({k2_bound[1]}) [{smi}]")
    dec = CK.KernelCeltDecoder(B_MAIN, device=dev, max_payload=160)
    step = cuda_ms(lambda: dec.decode_packed(buf, ln), 10)
    streams = B_MAIN * 20.0 / step
    print(f"times at B={B_MAIN} [{smi}]: K1 {k1:.4f} ms/frame, plain "
          f"{k1p:.2f} ms; K2 {k2:.4f} ms, plain {k2p:.4f} ms; decode step "
          f"{step:.3f} ms/frame -> {streams:.0f} realtime 20 ms streams")
    return dict(k1=k1, k1p=k1p, k1_bound=k1_bnd, k1_big=k1_big,
                k1_big_bound=k1_big_bound, k2=k2, k2p=k2p,
                k2_bound=k2_bound, dec_step=step)


def phase_enc_times(enc_lanes, dev, smi, t):
    """K3, plain K3, the front end, the encode step and the duplex step at
    B_MAIN with CUDA events."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.models.celt_enc_fused import fused_celt_enc_init

    tabs = EK.enc_tabs()
    pcm = torch.from_numpy(enc_lanes[0][:B_MAIN]).to(dev)
    state = fused_celt_enc_init(B_MAIN, tabs, dev)
    ins, X, _front = EK._front_end(pcm, state, tabs, 160)
    k3 = cuda_ms(lambda: EK.encode_frame(X, ins, tabs, 160), 20)
    k3p = cuda_ms(lambda: EK.encode_frame_plain(X, ins, tabs, 160), 1)
    fe = cuda_ms(lambda: EK._front_end(pcm, state, tabs, 160), 10)
    out = EK.encode_frame(X, ins, tabs, 160)
    k3_bnd, evals = k3_bound(tabs, X, out)
    # the same frame tiled to 4 x B_MAIN streams, as K1 is timed
    big = 4 * B_MAIN
    X4 = X.repeat(4, 1)
    ins4 = {k: v.repeat(4, *([1] * (v.dim() - 1))) for k, v in ins.items()}
    k3_big = cuda_ms(lambda: EK.encode_frame(X4, ins4, tabs, 160), 20)
    out4 = EK.encode_frame(X4, ins4, tabs, 160)
    if not torch.equal(out4["payload"][:B_MAIN], out["payload"]):
        fail("K3 at 4 x B_MAIN: payloads differ from B_MAIN's")
    k3_big_bnd, _ = k3_bound(tabs, X4, out4)
    # 320 bytes a frame (128 kb/s), the front end's inputs at that rate
    ins3, X3, _f3 = EK._front_end(pcm, state, tabs, 320)
    k3_320 = cuda_ms(lambda: EK.encode_frame(X3, ins3, tabs, 320), 20)
    k3p_320 = cuda_ms(lambda: EK.encode_frame_plain(X3, ins3, tabs, 320), 1)
    k3_320_bnd, _ = k3_bound(tabs, X3, EK.encode_frame(X3, ins3, tabs, 320))
    print(f"K3 at B={big}: {k3_big:.4f} ms/frame, bound "
          f"{k3_big_bnd[0]:.6f} ms ({k3_big_bnd[1]}); per stream "
          f"{k3 / B_MAIN * 1e6:.2f} ns at B={B_MAIN}, "
          f"{k3_big / big * 1e6:.2f} ns at B={big}; K3 at 320 bytes, "
          f"B={B_MAIN}: {k3_320:.4f} ms/frame, plain {k3p_320:.2f} ms, bound "
          f"{k3_320_bnd[0]:.6f} ms ({k3_320_bnd[1]}) [{smi}]")
    enc = EK.KernelCeltEncoder(B_MAIN, device=dev)
    enc_step = cuda_ms(lambda: enc.encode_device(pcm), 10)
    dec = CK.KernelCeltDecoder(B_MAIN, device=dev, max_payload=160)
    lens = torch.full((B_MAIN,), 160, dtype=torch.int64, device=dev)
    duplex = cuda_ms(lambda: dec.decode_packed(enc.encode_device(pcm)[0],
                                               lens), 10)
    print(f"times at B={B_MAIN} [{smi}]: K3 {k3:.4f} ms/frame, plain "
          f"{k3p:.2f} ms; front end {fe:.3f} ms; encode step "
          f"{enc_step:.3f} ms/frame -> {B_MAIN * 20.0 / enc_step:.0f} "
          f"realtime encode streams; duplex step {duplex:.3f} ms/frame -> "
          f"{B_MAIN * 20.0 / duplex:.0f} realtime duplex streams; K3 pulse "
          f"search {evals / B_MAIN:.0f} score evaluations per stream")
    t.update(k3=k3, k3p=k3p, k3_bound=k3_bnd, k3_big=k3_big,
             k3_big_bound=k3_big_bnd, k3_320=k3_320, k3p_320=k3p_320,
             k3_320_bound=k3_320_bnd, front=fe, enc_step=enc_step,
             duplex=duplex)
    return t


def phase_silk_fixed(dev):
    """Every helper of ops/silk_fixed.py on ~64 k seeded int32 inputs plus
    boundary values, on the card and on the CPU: identical outputs."""
    import numpy as np
    import torch
    from opus_tpu_torch.ops import silk_fixed as F

    rng = np.random.default_rng(30)
    edges = np.asarray([0, 1, -1, 32767, -32767, -32768, 65535, 65536,
                        -2 ** 31, 2 ** 31 - 1, 1 << 30, -(1 << 30)], np.int64)
    n = 1 << 16
    a = np.concatenate([np.repeat(edges, len(edges)),
                        rng.integers(-2 ** 31, 2 ** 31, n)])
    m = len(a)
    b = np.concatenate([np.tile(edges, len(edges)),
                        rng.integers(-2 ** 31, 2 ** 31, n)])
    b[::97] = 0                                   # zero divisors
    b16 = np.clip(b, -32768, 32767)
    sh = np.concatenate([[0, 31, 32, 33, 40, -1], rng.integers(-2, 41,
                                                               m - 6)])
    s64 = np.concatenate([[1, 31, 32, 63], rng.integers(1, 64, m - 4)])
    q = rng.integers(0, 70, m)
    lg = np.concatenate([np.arange(-200, 4200), a[:m - 4400]])
    cases = {
        "w32": lambda t: F.w32(t["a"] * t["b"]),
        "shl32": lambda t: F.shl32(t["a"], t["sh"]),
        "smulwb": lambda t: F.smulwb(t["a"], t["b16"]),
        "smulwb_any_b": lambda t: F.smulwb(t["a"], t["b"]),
        "smulww": lambda t: F.smulww(t["a"], t["b"]),
        "smmul": lambda t: F.smmul(t["a"], t["b"]),
        "sat16": lambda t: F.sat16(t["a"]),
        "sat32": lambda t: F.sat32((t["a"] * t["b"]) >> 8),
        "add_sat32": lambda t: F.add_sat32(t["a"], t["b"]),
        "lshift_sat32": lambda t: torch.stack(
            [F.lshift_sat32(t["a"], k) for k in (0, 4, 31)]),
        "lshift_sat32_dyn": lambda t: F.lshift_sat32_dyn(t["a"], t["sh"]),
        "rshift_round": lambda t: torch.stack(
            [F.rshift_round(t["a"], k) for k in (1, 8, 12, 31)]),
        "rshift_round64": lambda t: F.rshift_round64(t["a"] * t["b"],
                                                     t["s64"]),
        "rshift_round64_checked": lambda t: torch.stack([
            x.to(torch.int64) for x in
            F.rshift_round64_checked(t["a"] * t["b"], t["s64"])]),
        "clz32": lambda t: F.clz32(t["a"]),
        "div32": lambda t: F.div32(t["a"], t["b"]),
        "inverse32_varq": lambda t: torch.stack(
            [F.inverse32_varq(t["b"], 47), F.inverse32_varq(t["b"], t["q"])]),
        "div32_varq": lambda t: F.div32_varq(t["a"], t["b"], 16),
        "log2lin": lambda t: F.log2lin(t["lg"]),
    }
    arrays = dict(a=a, b=b, b16=b16, sh=sh, s64=s64, q=q, lg=lg)
    cpu = {k: torch.from_numpy(v) for k, v in arrays.items()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    for name, fn in cases.items():
        want = fn(cpu)
        got = fn(card).cpu()
        if not torch.equal(got, want):
            bad = (got != want).reshape(-1).nonzero()[:5, 0].tolist()
            fail(f"silk_fixed.{name}: card != CPU at flat indices {bad}")
    print(f"silk_fixed: {len(cases)} helpers on {m} inputs (boundary values, "
          f"shift counts 0/31/32+, zero divisors) identical on the card and "
          f"the CPU")


def phase_silk_k4_vs_plain(lanes, dev):
    """The SILK chain over NFRAMES frames with the plain LPC, state carried;
    K4 on every subframe's (slpc, res, a_rev) must give the plain v and
    state.  Returns the plain chain's per-frame outputs, the first frame's
    LPC inputs (for timing), the coverage counts and the max error."""
    import torch
    from opus_tpu_torch.models import batched_silk as BS
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import lpc

    b = lanes[0][0].shape[0]
    state = PF.fused_init_state(b, 16, dev)
    first_inputs = []
    n_sub = [0]
    max_err = [0]

    def plain_and_k4(slpc, res, a_rev, order_half):
        v, s = lpc.lpc_subframe_plain(slpc, res, a_rev, order_half)
        vk, sk = lpc.lpc_subframe(slpc, res, a_rev, order_half)
        torch.cuda.synchronize()
        if not (torch.equal(vk, v) and torch.equal(sk, s)):
            bad = ((vk != v).any(1) | (sk != s).any(1)).nonzero()[:5, 0]
            fail(f"K4 vs plain: subframe {n_sub[0]} differs at lanes "
                 f"{bad.tolist()}")
        max_err[0] = max(max_err[0], int((vk.long() - v.long()).abs().max()),
                         int((sk.long() - s.long()).abs().max()))
        if len(first_inputs) < 4:
            first_inputs.append((slpc.clone(), res.clone(), a_rev.clone(),
                                 order_half))
        n_sub[0] += 1
        return v, s

    cov = dict(voiced=0, interp=0, lbrr=0)
    frame_syms = []
    orig_sym = PF._frame_symbols

    def spy_sym(*args):
        # the frame's last call is its regular frame (an LBRR one precedes)
        d, error, syms = orig_sym(*args)
        frame_syms.append(syms)
        return d, error, syms

    orig_lbrr = PF._lbrr_symbols

    def spy_lbrr(d, ctx, active, *args):
        cov["lbrr"] += int(active[:B_MAIN].sum())
        return orig_lbrr(d, ctx, active, *args)

    outs = []
    saved = BS.lpc_subframe
    BS.lpc_subframe = plain_and_k4
    PF._frame_symbols = spy_sym
    PF._lbrr_symbols = spy_lbrr
    try:
        for f, (buf, ln) in enumerate(lanes):
            buf_t = torch.from_numpy(buf).to(dev)
            ln_t = torch.from_numpy(ln).to(dev)
            first = state["first_frame"].clone()
            xq, state, error, d = PF.fused_silk_decode(
                buf_t, ln_t, state, return_rc=True)
            syms = frame_syms[-1]
            cov["voiced"] += int((syms["signal_type"] == 2)[:B_MAIN].sum())
            cov["interp"] += int(((syms["interp_q2"] < 4)
                                  & ~first)[:B_MAIN].sum())
            outs.append(dict(xq=xq, err=error, rng=d["rng"]))
            print(f"SILK frame {f}: K4 == plain on all {b} lanes of its "
                  f"subframes; plain chain flags {int(error.sum())} lanes")
    finally:
        BS.lpc_subframe = saved
        PF._frame_symbols = orig_sym
        PF._lbrr_symbols = orig_lbrr
    if n_sub[0] != 4 * len(lanes):
        fail(f"K4 vs plain: {n_sub[0]} subframes, expected {4 * len(lanes)}")

    # extreme inputs: saturating residuals and states, every subframe length
    import numpy as np
    rng = np.random.default_rng(31)
    for sf in (40, 60, 80):
        res = torch.from_numpy(rng.choice(np.array(
            [2 ** 31 - 1, -2 ** 31, 0, 12345, -1], np.int64),
            size=(B_MAIN, sf))).to(dev)
        a_rev = torch.from_numpy(rng.integers(-32768, 32768,
                                              (B_MAIN, 16))).to(dev)
        slpc = torch.from_numpy(rng.choice(np.array(
            [2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30, 7], np.int64),
            size=(B_MAIN, 16))).to(dev)
        for oh in (5, 8):
            v, s = lpc.lpc_subframe(slpc, res, a_rev, oh)
            vp, sp = lpc.lpc_subframe_plain(slpc, res, a_rev, oh)
            torch.cuda.synchronize()
            if not (torch.equal(v, vp) and torch.equal(s, sp)):
                fail(f"K4 vs plain: extreme inputs at sf {sf} differ")
    print(f"K4 vs plain: identical v and state on {n_sub[0]} subframes x "
          f"{b} lanes and on saturating inputs at sf 40/60/80")
    return outs, first_inputs, cov, max_err[0]


def phase_silk_end_to_end(lanes, stream, sfx, dev, plain_outs):
    """FusedSilkDecoder as a user drives it, the K4 counter reset around
    the run: PCM and final range against the scalar decoder on the fixture
    lanes, and everything against the plain chain on every lane."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import lpc

    b, p = lanes[0][0].shape
    bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
            for bu, ln in lanes]
    dec = PF.FusedSilkDecoder(b, device=dev, max_payload=p)
    outs = []
    torch.cuda.synchronize()
    lpc.launches = 0
    for buf, ln in bufs:
        xq, err = dec.decode_packed(buf, ln)
        outs.append((xq, err, dec.final_range))
    torch.cuda.synchronize()
    count = lpc.launches
    print(f"SILK launch counter over {NFRAMES} frames: K4 {count}")
    if count != 4 * NFRAMES:
        fail(f"expected 4 launches of K4 per frame, got {count}")
    for f, (xq, err, rng) in enumerate(outs):
        ref = plain_outs[f]
        if not torch.equal(xq.to(torch.int64), ref["xq"]) \
                or not torch.equal(err, ref["err"]) \
                or not torch.equal(rng, ref["rng"]):
            fail(f"SILK frame {f}: the decoder differs from the plain chain")
        xq, err, rng = (x.cpu().numpy() for x in (xq, err, rng))
        if err[:B_MAIN].any():
            fail(f"SILK frame {f}: {int(err[:B_MAIN].sum())} fixture lanes "
                 f"flagged")
        if not np.array_equal(xq[:B_MAIN], sfx["xq"][stream, f]):
            bad = np.nonzero((xq[:B_MAIN] != sfx["xq"][stream, f])
                             .any(axis=1))[0][:5]
            fail(f"SILK frame {f}: PCM != scalar decoder at lanes {bad}")
        if not np.array_equal(rng[:B_MAIN], sfx["final_range"][stream, f]):
            fail(f"SILK frame {f}: final range != scalar decoder")
    print(f"SILK: all {B_MAIN} x {NFRAMES} fixture lane-frames bit-exact with "
          f"the scalar decoder (int16 PCM and final range); no fixture lane "
          f"flagged; garbage lanes == the plain chain (PCM, flags, range; "
          f"{int(outs[-1][1][B_MAIN:].sum())} flagged in the last frame)")
    return count


def phase_silk_times(lanes, dev, smi, k4_in, t):
    """K4 and its plain version on a main-path subframe, K4's device time
    alone at B_MAIN and 4 x B_MAIN (sf 80) and at sf 40 and 60, the SILK
    step and the symbol pass alone (one timed call each after a warm-up
    call), at B_MAIN."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import lpc
    from opus_tpu_torch.tools.device_time import device_ms

    slpc, res, a_rev = (x[:B_MAIN].to(torch.int32).contiguous()
                        for x in k4_in[0][:3])
    oh = k4_in[0][3]
    sf = res.shape[1]
    k4_call = cuda_ms(lambda: lpc.lpc_subframe(slpc, res, a_rev, oh), 50)
    k4p = cuda_ms(lambda: lpc.lpc_subframe_plain(slpc, res, a_rev, oh), 3)
    # the main-path subframe, the same tiled to 4 x B_MAIN streams, and
    # seeded inputs of the main path's magnitudes at the other subframe
    # lengths (12 and 8 kHz); each result is held to the plain version's
    rng = np.random.default_rng(32)
    cases = {(B_MAIN, sf): (slpc, res, a_rev),
             (4 * B_MAIN, sf): (slpc.repeat(4, 1), res.repeat(4, 1),
                                a_rev.repeat(4, 1))}
    for sf_ in (40, 60):
        cases[(B_MAIN, sf_)] = tuple(torch.from_numpy(x).to(dev) for x in (
            rng.integers(-1 << 27, 1 << 27, (B_MAIN, 16), np.int32),
            rng.integers(-1 << 20, 1 << 20, (B_MAIN, sf_), np.int32),
            rng.integers(-16384, 16384, (B_MAIN, 16), np.int32)))
    dev_ms = {}
    for (b, sf_), (s_, r_, a_) in cases.items():
        v, s = lpc.lpc_subframe(s_, r_, a_, oh)
        vp, sp = lpc.lpc_subframe_plain(s_, r_, a_, oh)
        if not (torch.equal(v, vp) and torch.equal(s, sp)):
            fail(f"K4 vs plain at B={b}, sf {sf_}: differ")
        ms = device_ms(lambda: lpc.lpc_subframe(s_, r_, a_, oh),
                       "silk_lpc_kernel")
        bnd = k4_bound(b, sf_)
        dev_ms[(b, sf_)] = ms
        print(f"K4 device time at B={b}, sf {sf_}: {ms:.5f} ms a launch "
              f"(profiler records), bound {bnd[0]:.6f} ms ({bnd[1]}), "
              f"{100 * bnd[0] / ms:.1f}% of it [{smi}]")
    k4 = dev_ms[(B_MAIN, sf)]
    k4_bnd = k4_bound(B_MAIN, sf)
    buf = torch.from_numpy(lanes[0][0][:B_MAIN]).to(dev)
    ln = torch.from_numpy(lanes[0][1][:B_MAIN]).to(dev)
    dec = PF.FusedSilkDecoder(B_MAIN, device=dev, max_payload=buf.shape[1])
    step = cuda_ms(lambda: dec.decode_packed(buf, ln), 1)
    st = PF.fused_init_state(B_MAIN, 16, dev)
    sym = cuda_ms(lambda: PF.silk_symbols(buf, ln, st), 1)
    print(f"SILK times at B={B_MAIN} [{smi}]: K4 {k4:.5f} ms device time, "
          f"{k4_call:.5f} ms a call (events around 50 calls; sf {sf}), "
          f"plain {k4p:.3f} ms, bound {k4_bnd[0]:.6f} ms ({k4_bnd[1]}); "
          f"SILK step {step:.3f} ms/frame -> {B_MAIN * 20.0 / step:.0f} "
          f"realtime SILK streams; symbol pass alone {sym:.3f} ms")
    t.update(k4=k4, k4p=k4p, k4_bound=k4_bnd, silk_step=step, silk_sym=sym)
    return t


def phase_hybrid_k1_vs_plain(lanes, dev, tabs):
    """The hybrid chain over NFRAMES frames with the plain symbol pass,
    state carried; per frame K1 (start 17, from the SILK half's coder) on
    the same inputs must give the plain outputs.  Returns the plain
    chain's per-frame outputs, frame 0's K1 inputs (for timing), the
    coverage counts and the max X error."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.models import hybrid_dec_fused as PH

    b = lanes[0][0].shape[0]
    state = PH.hybrid_init_state(b, tabs, dev)
    first_in = []
    x_err = [0.0]
    cov = dict(transient=0, anti_collapse=0, bands18_up_no_bits=0, voiced=0)
    seen = {}

    def plain_and_k1(*args):
        ref = CK.decode_frame_plain(*args)
        got = CK.decode_frame(*args)
        torch.cuda.synchronize()
        xe, _ee = compare_k1(got, ref, tabs)
        x_err[0] = max(x_err[0], xe)
        if not first_in:
            first_in.append(args)
        seen["ref"] = ref
        return ref

    orig_sym = PF._frame_symbols

    def spy_sym(*args):
        d, error, syms = orig_sym(*args)
        seen["voiced"] = syms["signal_type"] == 2
        return d, error, syms

    outs = []
    PF._frame_symbols = spy_sym
    try:
        for f, (buf, ln) in enumerate(lanes):
            pcm, state, err = PH.fused_hybrid_decode(
                torch.from_numpy(buf).to(dev), torch.from_numpy(ln).to(dev),
                state, tabs, plain_and_k1)
            ref = seen["ref"]
            main = slice(0, B_MAIN)
            cov["transient"] += int(ref["is_transient"][main].sum())
            cov["anti_collapse"] += int(ref["anti_collapse_on"][main].sum())
            cov["bands18_up_no_bits"] += int(
                (ref["pulses"][main, 18:tabs.end_band] == 0).sum())
            cov["voiced"] += int(seen["voiced"][main].sum())
            outs.append(dict(pcm=pcm, err=err, rng=state["celt"]["seed"]))
            print(f"hybrid frame {f}: K1 (start 17, end {tabs.end_band}) == "
                  f"plain (ints exact, X err within bound); plain chain "
                  f"flags {int(err.sum())} lanes")
    finally:
        PF._frame_symbols = orig_sym
    return outs, first_in[0], cov, x_err[0]


def phase_hybrid_end_to_end(lanes, stream, hfx, dev, plain_outs, end=21):
    """FusedHybridDecoder(end=end) as a user drives it, the K1, K2 and K4
    counters reset around the run: final range and PCM against the scalar
    decoder on the fixture lanes, flags and ranges against the plain chain
    on every lane."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import hybrid_dec_fused as PH
    from opus_tpu_torch.ops import iir, lpc

    b, p = lanes[0][0].shape
    bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
            for bu, ln in lanes]
    dec = PH.FusedHybridDecoder(b, end=end, max_payload=p, device=dev)
    outs = []
    torch.cuda.synchronize()
    CK.launches = iir.launches = lpc.launches = 0
    for buf, ln in bufs:
        pcm, err = dec.decode_packed(buf, ln)
        outs.append((pcm, err, dec.final_range))
    torch.cuda.synchronize()
    counts = {"K1": CK.launches, "K2": iir.launches, "K4": lpc.launches}
    print(f"hybrid (end {end}) launch counters over {NFRAMES} frames: "
          f"{counts}")
    if counts != {"K1": NFRAMES, "K2": NFRAMES, "K4": 4 * NFRAMES}:
        fail(f"expected K1 = K2 = {NFRAMES} and K4 = {4 * NFRAMES}, got "
             f"{counts}")
    pcm_err = 0.0
    for f, (pcm, err, rng) in enumerate(outs):
        ref = plain_outs[f]
        if not torch.equal(err, ref["err"]) or not torch.equal(rng,
                                                               ref["rng"]):
            fail(f"hybrid frame {f}: flags or final range differ from the "
                 f"plain chain")
        # garbage lanes reach large values: X differs from the plain
        # version within X_REL_TOL of a band's maximum, so bound each lane
        # relative to its own peak
        scale = ref["pcm"].abs().amax(dim=1).clamp_min(1.0)
        d = (pcm - ref["pcm"]).abs().amax(dim=1)
        if not bool((d <= PCM_ABS_TOL * scale).all()):
            fail(f"hybrid frame {f}: PCM differs from the plain chain by "
                 f"{d.max().item()}")
        pcm, err, rng = (x.cpu().numpy() for x in (pcm, err, rng))
        if err[:B_MAIN].any():
            fail(f"hybrid frame {f}: {int(err[:B_MAIN].sum())} fixture "
                 f"lanes flagged")
        if not np.array_equal(rng[:B_MAIN], hfx["final_range"][stream, f]):
            bad = np.nonzero(rng[:B_MAIN] != hfx["final_range"][stream, f])
            fail(f"hybrid frame {f}: final range != scalar decoder at "
                 f"{bad[0][:5]}")
        e = float(np.abs(pcm[:B_MAIN] - hfx["pcm"][stream, f]).max())
        if not np.isfinite(pcm).all() or not e <= PCM_ABS_TOL:
            fail(f"hybrid frame {f}: PCM err {e} vs scalar decoder")
        pcm_err = max(pcm_err, e)
    print(f"hybrid (end {end}): all {B_MAIN} x {NFRAMES} fixture "
          f"lane-frames at the "
          f"scalar decoder's final range, PCM max err {pcm_err:.3g} (bound "
          f"{PCM_ABS_TOL}); no fixture lane flagged; garbage lanes == the "
          f"plain chain (flags, range; PCM within the bound; "
          f"{int(outs[-1][1][B_MAIN:].sum())} flagged in the last frame)")
    return pcm_err, counts


def phase_hybrid_times(lanes, dev, smi, tabs, k1_in, t):
    """K1 at start 17 and its plain version on frame 0's inputs, the hybrid
    step and its SILK, CELT and resampler parts (the step and the SILK
    part one timed call each after a warm-up call), at B_MAIN with CUDA
    events."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.models import hybrid_dec_fused as PH
    from opus_tpu_torch.silk.resampler import upsample_to_48k

    main = slice(0, B_MAIN)
    buf_k, ln_k, old_e, pm, seed, _tabs, d0 = k1_in
    args = (buf_k[main], ln_k[main], old_e[main], pm[main], seed[main], tabs,
            {k: v[main] for k, v in d0.items()})
    k1 = cuda_ms(lambda: CK.decode_frame(*args), 20)
    k1p = cuda_ms(lambda: CK.decode_frame_plain(*args), 1)
    out = CK.decode_frame(*args)
    tab = CK.k1_table(tabs, dev)
    # bytes as for K1 at start 0 plus the 10 coder-state words per lane
    k1_bytes = nbytes_of(args[0], old_e[main], pm[main], seed[main], tab,
                         out["X"], out["energies"], out["pf_gain"]) \
        + B_MAIN * 4 * (1 + 9 + 10)
    k1_bound = bound(k1_bytes, 20.0 * tabs.M * 400 * B_MAIN)
    buf = torch.from_numpy(lanes[0][0][main]).to(dev)
    ln = torch.from_numpy(lanes[0][1][main]).to(dev)
    dec = PH.FusedHybridDecoder(B_MAIN, max_payload=buf.shape[1], device=dev)
    step = cuda_ms(lambda: dec.decode_packed(buf, ln), 1)
    st = PH.hybrid_init_state(B_MAIN, tabs, dev)
    silk = cuda_ms(lambda: PF.fused_silk_decode(buf, ln, st["silk"],
                                                return_rc=True), 1)
    celt = cuda_ms(lambda: CK.kernel_celt_decode_to_pcm(
        *args[:2], st["celt"], tabs, d0=args[6]), 10)
    xq = torch.zeros((B_MAIN, 320), dtype=torch.int64, device=dev)
    rs = cuda_ms(lambda: upsample_to_48k(xq, st["rs"]), 3)
    print(f"hybrid times at B={B_MAIN} [{smi}]: K1 (start 17) {k1:.4f} "
          f"ms/frame, plain {k1p:.2f} ms, bound {k1_bound[0]:.6f} ms "
          f"({k1_bound[1]}); hybrid step {step:.3f} ms/frame -> "
          f"{B_MAIN * 20.0 / step:.0f} realtime hybrid streams; SILK part "
          f"{silk:.3f} ms, CELT part (K1 + synthesis) {celt:.3f} ms, "
          f"resampler {rs:.3f} ms")
    t.update(k1h=k1, k1hp=k1p, k1h_bound=k1_bound, hyb_step=step,
             hyb_silk=silk, hyb_celt=celt, hyb_rs=rs)
    return t


def dred_batch(dfx, stats):
    """The DRED phase's B_DNN-lane batch: the fixture's packets parsed here
    (``parse_batch`` and ``playback_rows`` held exactly to the JAX
    package's outputs stored in the fixture) and tiled DRED_TILE times,
    then random lanes as bench.py:388-397 builds them (DRED_T chunks,
    dred_offset 8, loss offsets 2-4).  Returns (ParsedBatch, pcm0 [B, 320],
    loss offsets [B], the number of fixture lanes)."""
    import numpy as np
    from opus_tpu_torch.models import dnn_recovery as PRec

    lens = dfx["lens"]
    packets = [bytes(dfx["packets"][i, :lens[i]]) for i in range(len(lens))]
    fxp = PRec.parse_batch(stats, packets, 16000, 16000)
    for f in PRec.ParsedBatch._fields:
        if not np.array_equal(getattr(fxp, f), dfx[f]):
            fail(f"DRED parse_batch: {f} differs from the JAX package's")
    if int(dfx["n_frames"]) != N_CONCEAL:
        fail(f"DRED fixture: {int(dfx['n_frames'])} concealed frames")
    cont, play = PRec.playback_rows(fxp, dfx["loss_offset"], N_CONCEAL)
    if not (np.array_equal(cont, dfx["cont_idx"])
            and np.array_equal(play, dfx["play_idx"])):
        fail("DRED playback_rows differ from the JAX package's")
    n_fx = len(packets) * DRED_TILE
    nr = B_DNN - n_fx
    rng = np.random.RandomState(1)
    r_state0 = rng.randn(nr, 24).astype(np.float32) * 0.3
    r_lat = rng.randn(DRED_T, nr, 81).astype(np.float32) * 0.3
    r_pcm0 = np.clip(0.2 * rng.randn(nr, 320), -1, 1).astype(np.float32)
    t_fx = fxp.latents.shape[0]
    lat = np.zeros((max(t_fx, DRED_T), B_DNN, 81), np.float32)
    lat[:t_fx, :n_fx] = np.tile(fxp.latents, (1, DRED_TILE, 1))
    lat[:DRED_T, n_fx:] = r_lat

    def tile(a, rest):
        return np.concatenate([np.tile(a, (DRED_TILE,) + (1,) * (a.ndim - 1)),
                               rest.astype(a.dtype)])
    parsed = PRec.ParsedBatch(
        tile(fxp.state0, r_state0), lat,
        tile(fxp.nb_latents, np.full(nr, DRED_T)),
        tile(fxp.dred_offset, np.full(nr, 8)),
        tile(fxp.has_dred, np.ones(nr, bool)))
    pcm0 = tile(dfx["pcm0"], r_pcm0)
    loss = tile(dfx["loss_offset"], 2 + np.arange(nr) % 3)
    print(f"DRED batch: {B_DNN} streams, {n_fx} from the fixture's "
          f"{len(packets)} packets (parse and playback rows == the JAX "
          f"package's; nb_latents {fxp.nb_latents.tolist()}), {nr} random "
          f"(bench.py's: {DRED_T} chunks, dred_offset 8); latent chunks "
          f"padded to T = {lat.shape[0]}; {N_CONCEAL} concealed frames")
    return parsed, pcm0, loss, n_fx


def dnn_close(got, ref, what):
    """Max abs error; fails outside rtol DNN_RTOL / atol DNN_ATOL."""
    import numpy as np
    bad = np.abs(got - ref) > DNN_ATOL + DNN_RTOL * np.abs(ref)
    if not np.isfinite(got).all() or bad.any():
        lanes = np.nonzero(bad.any(axis=tuple(range(1, bad.ndim))))[0]
        fail(f"{what}: outside rtol {DNN_RTOL} / atol {DNN_ATOL} on lanes "
             f"{lanes[:8].tolist()} (max err "
             f"{float(np.abs(got - ref).max())})")
    return float(np.abs(got - ref).max())


def phase_dred(dev, dfx):
    """BatchedDREDRecovery as a user drives it on B_DNN streams, the K2
    counter reset around the run: the PCM against the port's CPU run on
    every lane and the JAX package's stored output on the fixture lanes;
    the RDOVAE features against the fixture's, and the FARGAN pitch period
    of every feature row read equal on the card and the CPU; then K2
    against its plain version on FARGAN's de-emphasis inputs of a second
    run.  Returns the batch and the numbers of the kernels line."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import dred as PD
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import rdovae as PV
    from opus_tpu_torch.models import batched_dnn as PB
    from opus_tpu_torch.models import dnn_recovery as PRec
    from opus_tpu_torch.ops import iir

    stats = PD.random_stats(43)
    dec = PV.random_dec_model(42, device="cpu")
    fgm = PF.random_model(46, device="cpu")
    parsed, pcm0, loss, n_fx = dred_batch(dfx, stats)
    rec = PRec.BatchedDREDRecovery(dec, stats, fgm, device=dev)
    torch.cuda.synchronize()
    iir.launches = 0
    out = rec.recover(parsed, pcm0, loss, N_CONCEAL)
    torch.cuda.synchronize()
    k2 = iir.launches
    want = PF.FARGAN_NB_SUBFRAMES * (1 + N_CONCEAL)
    print(f"DRED launch counters (one recover): K2 {k2}")
    if k2 != want:
        fail(f"DRED recover: K2 launched {k2} times, expected {want}")
    out = out.cpu().numpy()
    if out.shape != (B_DNN, N_CONCEAL * 160):
        fail(f"DRED recover: output shape {out.shape}")
    t0 = time.time()
    ref = PRec.BatchedDREDRecovery(dec, stats, fgm, device="cpu").recover(
        parsed, pcm0, loss, N_CONCEAL).numpy()
    cpu_s = time.time() - t0
    e_cpu = dnn_close(out, ref, "DRED PCM, card vs the port's CPU run")
    e_jax = dnn_close(out[:n_fx], np.tile(dfx["pcm"], (DRED_TILE, 1)),
                      "DRED PCM, card vs the JAX package (fixture lanes)")

    cont, play = PRec.playback_rows(parsed, loss, N_CONCEAL)
    rows = np.concatenate([cont, play], axis=1)

    def features(model, device):
        _, q = PB.rdovae_decode_frames(
            model, torch.as_tensor(parsed.state0, device=device),
            torch.as_tensor(parsed.latents, device=device))
        feats = q.transpose(0, 1).reshape(B_DNN, -1, 20)
        idx = torch.as_tensor(np.maximum(rows, 0), device=device).long()
        f = torch.gather(feats, 1, idx[..., None].expand(-1, -1, 20))
        return q.cpu().numpy(), PF.period_from_feature(f).cpu().numpy()

    q_card, per_card = features(rec.dec_model, dev)
    q_cpu, per_cpu = features(dec, "cpu")
    t_fx = dfx["qframes"].shape[0]
    # lanes first, as dnn_close reports them
    e_q = max(dnn_close(q_card.transpose(1, 0, 2), q_cpu.transpose(1, 0, 2),
                        "RDOVAE features, card vs CPU"),
              dnn_close(q_card[:t_fx, :n_fx].transpose(1, 0, 2),
                        np.tile(dfx["qframes"], (1, DRED_TILE, 1))
                        .transpose(1, 0, 2),
                        "RDOVAE features, card vs the JAX package"))
    used = rows >= 0
    if not np.array_equal(per_card[used], per_cpu[used]):
        lane, r = np.argwhere((per_card != per_cpu) & used)[0]
        fail(f"DRED: FARGAN period of lane {lane} row {rows[lane, r]} is "
             f"{per_card[lane, r]} on the card, {per_cpu[lane, r]} on the "
             f"CPU (a .5 rounding boundary)")

    again, k2_err = k2_spy(lambda: rec.recover(parsed, pcm0, loss, N_CONCEAL))
    torch.cuda.synchronize()
    dnn_close(again.cpu().numpy(), ref, "DRED PCM (second run) vs CPU")
    print(f"DRED recover at B={B_DNN}: PCM max err {e_cpu:.3g} vs the port's "
          f"CPU run (all lanes), {e_jax:.3g} vs the JAX package ({n_fx} "
          f"fixture lanes); RDOVAE features {e_q:.3g}; FARGAN periods of all "
          f"{int(used.sum())} rows read equal on the card and the CPU; K2 "
          f"== plain on {K2_REL_TOL}-relative bound ({k2} launches at "
          f"[{B_DNN}, 40], max err {k2_err:.3g}); the CPU run took "
          f"{cpu_s:.1f} s (host)")
    return dict(parsed=parsed, pcm0=pcm0, loss=loss, rec=rec, k2=k2,
                k2_err=k2_err, e_cpu=e_cpu, e_jax=e_jax)


def phase_dnn_times(dev, smi, d):
    """fargan_batch_step (B_DNN streams, one 10 ms frame) and recover (the
    DRED batch, N_CONCEAL frames) with CUDA events around back-to-back
    calls, their device operations and device time a call from the
    profiler, K2's device time at FARGAN's shape; realtime streams as
    bench.py defines them (B x 10 ms / step, B x 60 ms / recover)."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.models import batched_dnn as PB
    from opus_tpu_torch.ops import iir
    from opus_tpu_torch.tools.device_time import device_ms, device_profile

    step = PB.fargan_batch_step(d["rec"].fargan)
    state = PF.init_state(B_DNN, device=dev)
    f = torch.as_tensor(np.random.RandomState(0).randn(B_DNN, 20)
                        .astype(np.float32) * 0.3, device=dev)
    iir.launches = 0
    step(state, f)
    k2_step = iir.launches
    ms_step = cuda_ms(lambda: step(state, f), 10)
    ops_step, dev_step = device_profile(lambda: step(state, f))
    args = (d["parsed"], d["pcm0"], d["loss"], N_CONCEAL)
    ms_rec = cuda_ms(lambda: d["rec"].recover(*args), 5)
    ops_rec, dev_rec = device_profile(lambda: d["rec"].recover(*args))
    x = torch.as_tensor(np.random.RandomState(2).randn(B_DNN, 40)
                        .astype(np.float32) * 0.1, device=dev)
    mem = torch.zeros(B_DNN, device=dev)
    k2 = device_ms(lambda: iir.deemphasis(x, mem, PF.FARGAN_DEEMPHASIS),
                   "deemphasis_kernel")
    k2_bound = bound(2 * nbytes_of(x, mem), 2.0 * x.numel())
    print(f"DNN times [{smi}]: fargan_batch_step at B={B_DNN}: "
          f"{ms_step:.3f} ms a 10 ms frame -> "
          f"{B_DNN * 10.0 / ms_step:.0f} realtime streams; {ops_step:.0f} "
          f"device operations and {dev_step:.3f} ms device time a call "
          f"(device busy {100 * dev_step / ms_step:.1f}%); K2 launches a "
          f"call {k2_step}")
    print(f"DNN times [{smi}]: recover at B={B_DNN}, {N_CONCEAL} frames: "
          f"{ms_rec:.3f} ms -> {B_DNN * 10.0 * N_CONCEAL / ms_rec:.0f} "
          f"realtime streams; {ops_rec:.0f} device operations and "
          f"{dev_rec:.3f} ms device time a call (device busy "
          f"{100 * dev_rec / ms_rec:.1f}%); K2 launches a call {d['k2']}; "
          f"K2 at [{B_DNN}, 40]: {k2:.5f} ms device time, bound "
          f"{k2_bound[0]:.6f} ms ({k2_bound[1]})")
    return dict(fargan_step=ms_step, recover=ms_rec, k2_dnn=k2)


# Deep PLC (tracked config 5's concealment half, ``BatchedDeepPLC``): B_DNN
# streams, the deep-PLC fixture's 9 (the DRED fixture's packets) tiled
# DRED_TILE times and the DRED phase's random-latent lanes, each with 16 + 2
# frames of seeded speech-like history, driven through the fixture tool's
# sequence: 16 updates, dred_decode of 60 ms at 48 kHz, 2 updates,
# fec_clear and 2 conceals, dred_decode of 20 ms at 16 kHz.  Bounds, card
# against the port's CPU run (every lane) and the JAX package's stored
# output (fixture lanes):
# - every analysed frame's pitch period, every FARGAN period, FEC read
#   position and loss count equal (integer decisions: one flip moves a
#   stream onto another trajectory);
# - the 16 kHz PCM within 1 LSB: FARGAN's f32 output differs by the order
#   of the GEMM sums and K2's scan (~1e-7 of full scale, 0.003 LSB), which
#   moves a rounding now and then;
# - the 48 kHz PCM within 4 LSB: the upsampler's image of those 16 kHz
#   samples, and a 1-LSB input step moves its output by at most the
#   largest per-phase sum of |h| (3.02: tests/test_torch_deep_plc.py
#   measures it on the impulse response)
#   plus its own rounding;
# - the features within PLC_FEAT_TOL absolute: the concealed PCM's 1-LSB
#   differences re-enter the analysis of step 3 (the cepstra of frames
#   ~-40 dB down move by ~1e-4 for a 1-LSB sample), and the PLC network
#   and RDOVAE feed f32 GEMM-order noise back through their GRUs.
PLC_FIXTURE = os.path.join(REPO, "tests", "data", "torch_deep_plc.npz")
PLC_LSB_16K, PLC_LSB_48K = 1, 4
PLC_FEAT_TOL = 2e-3
# K2 a FARGAN subframe: the 4-subframe priming at each blend == 0 conceal
# (steps 2 and 3) plus 4 per concealed frame (6 + 2 + 2)
PLC_K2_LAUNCHES = 4 * 2 + 4 * 10
PLC_INT_KEYS = ("apitch", "period", "fec_read", "loss")
# per-lane loss on the decode side: the plc_lanes phase's ticks and its
# mid-run reset (before tick PLC_RESET_TICK, on every third lane; the
# fixture's 8 lanes: 0, 3 and 6)
PLC_TICKS, PLC_RESET_TICK = 16, 8
PLC_RESET_LANES = (0, 3, 6)
# dred_decode's other rates: Resampler(16000, fs) down (DOWN_FIR 1/2 at 8
# kHz, 3/4 at 12) or up (IIR_FIR at 24) from the 16 kHz concealment, whose
# samples are within PLC_LSB_16K = 1 LSB of the reference's.  A 1-LSB step
# on every input sample moves an output sample by at most the largest sum
# of |h| that reaches one output sample (``resampler_l1``: 2.38, 2.54 and
# 3.02, measured on the port's bit-exact resampler); the rounded outputs
# then differ by at most its ceiling (3, 3 and 4 LSB), as the 4 LSB at
# 48 kHz above.
PLC_RATES = (8000, 12000, 24000)


def resampler_l1(fs: int, pieces: int = 6) -> float:
    """The largest sum over input samples of |h| reaching one output sample
    of Resampler(16000, fs), from the port's resampler on the CPU: a 4096
    impulse at each of pieces x 160 input positions, one lane each, the
    state carried over 10 ms pieces."""
    import numpy as np
    import torch
    from opus_tpu_torch.silk import resampler as PR
    n, amp = 160 * pieces, 4096
    x = torch.diag(torch.full((n,), amp, dtype=torch.int64))
    st = PR.dec_resampler_init(n, fs)
    ys = []
    for k in range(pieces):
        y, st = PR.resample_16k(x[:, 160 * k:160 * (k + 1)], st, fs)
        ys.append(y)
    h = torch.cat(ys, dim=1).to(torch.float64) / amp
    return float(h.abs().sum(dim=0).max())


def plc_rate_lsb(fs: int) -> int:
    """The int16 bound at fs card vs CPU and port vs JAX (above)."""
    import math
    return int(math.ceil(resampler_l1(fs) * PLC_LSB_16K))


def speech_history(n_streams: int, seed: int, n_frames: int = 18):
    """Seeded speech-like int16 [n, n_frames, 160] at 16 kHz: two harmonics
    of a vibrato f0 in 90-240 Hz plus 1% noise, at 25-75% of full scale."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = 160 * n_frames
    t = np.arange(n) / 16000.0
    f0 = 90 + 150 * rng.rand(n_streams, 1)
    ph = np.cumsum(f0 * (1 + 0.1 * np.sin(2 * np.pi * 3 * t)), 1) / 16000.0
    x = np.clip(0.25 * (np.sin(2 * np.pi * ph) + 0.5 * np.sin(4 * np.pi * ph))
                + 0.01 * rng.randn(n_streams, n), -1, 1)
    level = 0.25 + 0.5 * rng.rand(n_streams, 1)
    return np.round(x * level * 65534).clip(-32768, 32767) \
        .astype(np.int16).reshape(n_streams, n_frames, 160)


def plc_models(device):
    """The deep-PLC models from the fixture tool's seeds."""
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import pitchdnn as PP
    from opus_tpu_torch.dnn import plc as PL
    return (PL.random_model(44, device=device),
            PP.random_model(45, device=device),
            PF.random_model(46, device=device))


def deep_plc_sequence(models, dreds, hist, off48, off16, dev):
    """PLC_SEQUENCE through ``BatchedDeepPLC`` on dev (a 48 kHz and a
    16 kHz instance sharing one ``LPCNetPLC``, as the fixture tool shares
    it between two JAX decoders).  dreds: a ``DREDBatch`` on dev; hist
    int16 [B, 18, 160]; off48 / off16 [B] samples.  Returns the fixture's
    keys as numpy: the PCM, the features, FEC read position and loss count
    after each of the 10 concealed frames, every analysed frame's features
    and the pitch periods, all computed on dev."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import features as PFe
    from opus_tpu_torch.models.deep_plc import BatchedDeepPLC

    b = hist.shape[0]
    plc48 = BatchedDeepPLC(*models, b, fs=48000, device=dev)
    plc16 = BatchedDeepPLC(*models, b, fs=16000, device=dev)
    lp = plc16.lpcnet = plc48.lpcnet
    log, analysed = [], []
    orig_cff, orig_conceal = PFe.compute_frame_features, lp.conceal

    def cff(st, pcm, model):
        st, f = orig_cff(st, pcm, model)
        analysed.append(f)
        return st, f

    def conceal(lanes=None):
        out = orig_conceal(lanes)
        log.append((out, lp.features, lp.fec_read_pos, lp.loss_count))
        return out

    PFe.compute_frame_features, lp.conceal = cff, conceal
    try:
        h = torch.as_tensor(np.asarray(hist), device=dev)
        for k in range(16):
            lp.update(h[:, k])
        pcm48 = plc48.dred_decode(dreds, off48, 2880)
        for k in (16, 17):
            lp.update(h[:, k])
        lp.fec_clear()
        pred = torch.cat([lp.conceal(), lp.conceal()], dim=1)
        pcm16 = plc16.dred_decode(dreds, off16, 320)
    finally:
        PFe.compute_frame_features = orig_cff
        del lp.conceal
    feats = torch.stack([e[1] for e in log], dim=1)
    afeats = torch.stack(analysed, dim=1)
    out = dict(pcm48=pcm48, pcm48_16k=torch.cat([e[0] for e in log[:6]], 1),
               pcm_pred=pred, pcm16=pcm16, feats=feats, afeats=afeats,
               fec_read=torch.stack([e[2] for e in log], dim=1),
               loss=torch.stack([e[3] for e in log], dim=1),
               apitch=PFe.pitch_period(afeats[..., 18].reshape(-1))
               .reshape(b, -1),
               period=PF.period_from_feature(feats))
    return {k: v.cpu().numpy() for k, v in out.items()}, plc48


def compare_plc(got, ref, what):
    """The deep-PLC bounds (above) on every lane; returns the max errors."""
    import numpy as np
    for k in PLC_INT_KEYS:
        bad = (got[k] != ref[k]).reshape(len(ref[k]), -1).any(axis=1)
        if bad.any():
            fail(f"deep PLC {what}: {k} differs on lanes "
                 f"{np.nonzero(bad)[0][:8].tolist()}")
    err = {}
    for k, tol in (("pcm48_16k", PLC_LSB_16K), ("pcm_pred", PLC_LSB_16K),
                   ("pcm16", PLC_LSB_16K), ("pcm48", PLC_LSB_48K),
                   ("feats", PLC_FEAT_TOL), ("afeats", PLC_FEAT_TOL)):
        d = np.abs(got[k].astype(np.float64) - ref[k].astype(np.float64))
        bad = (d > tol).reshape(len(d), -1).any(axis=1)
        if not np.isfinite(d).all() or bad.any():
            fail(f"deep PLC {what}: {k} outside {tol} on lanes "
                 f"{np.nonzero(bad)[0][:8].tolist()} (max {d.max()})")
        err[k] = float(d.max())
    return err


def plc_lanes(pfx, dfx, parser, parsed):
    """The phase's B_DNN lanes: (OpusDRED list, hist, off48, off16, the
    number of fixture lanes).  ``parsed`` is the DRED phase's batch
    (``dred_batch``).  The fixture lanes' packets go through
    ``OpusDREDDecoder.parse`` (checked equal to the DRED phase's parse,
    itself held to the JAX package's); the
    random lanes take the DRED phase's random latents (4 chunks,
    dred_offset 8), a seeded speech-like history and offsets up to 20
    frames, past their 16-row window on some lanes."""
    import numpy as np
    from opus_tpu_torch.dnn import dred_dec as PDD

    lens = dfx["lens"]
    n_fx = len(lens) * DRED_TILE
    dreds = []
    for i in range(B_DNN):
        d = None
        if i < n_fx:
            j = i % len(lens)
            d, _ = parser.parse(bytes(dfx["packets"][j, :lens[j]]), 16000,
                                16000)
        elif parsed.has_dred[i]:
            nb = int(parsed.nb_latents[i])
            d = PDD.OpusDRED(1, int(parsed.dred_offset[i]), nb,
                             parsed.state0[i], parsed.latents[:nb, i], None)
        same = (d is None) == (not parsed.has_dred[i]) and (d is None or (
            d.dred_offset == parsed.dred_offset[i]
            and np.array_equal(d.state, parsed.state0[i])
            and np.array_equal(d.latents,
                               parsed.latents[:d.nb_latents, i])))
        if not same:
            fail(f"deep PLC: OpusDREDDecoder.parse differs on lane {i}")
        dreds.append(d)
    nr = B_DNN - n_fx
    rng = np.random.RandomState(5)
    hist = np.concatenate([np.tile(pfx["hist"], (DRED_TILE, 1, 1)),
                           speech_history(nr, 5)])
    off48 = np.concatenate([np.tile(pfx["off48"], DRED_TILE),
                            rng.randint(0, 21 * 480, nr)])
    off16 = np.concatenate([np.tile(pfx["off16"], DRED_TILE),
                            rng.randint(0, 21 * 160, nr)])
    return dreds, hist, off48, off16, n_fx


def k2_spy(run, mod=None):
    """Runs ``run()`` with every de-emphasis call of the module ``mod``
    (FARGAN's by default) computed by K2 and by its plain version, which
    must agree within K2's bound (K2_REL_TOL plus the carry's share: |y| is
    at most max|x| / (1 - c) + |mem|).  Returns (run's result, max
    error)."""
    from opus_tpu_torch.dnn import fargan
    from opus_tpu_torch.ops import iir

    PF = fargan if mod is None else mod

    err = [0.0]
    orig = PF.deemphasis

    def both(x, mem, coef):
        y, m = orig(x, mem, coef)
        yp, mp = iir.deemphasis_plain(x, mem, coef)
        tol = K2_REL_TOL * (x.abs().amax(dim=1) / (1.0 - coef) + mem.abs())
        d = (y - yp).abs().amax(dim=1)
        if not bool((d <= tol).all()) or not bool(
                ((m - mp).abs() <= tol).all()):
            fail(f"K2 vs plain on {PF.__name__}'s de-emphasis: err "
                 f"{d.max().item()}")
        err[0] = max(err[0], d.max().item())
        return y, m

    PF.deemphasis = both
    try:
        out = run()
    finally:
        PF.deemphasis = orig
    return out, err[0]


def phase_deep_plc(dev, dfx, pfx, dred):
    """The deep-PLC sequence as a user drives it on B_DNN streams, the K2
    counter reset just before it and read just after; its outputs held to
    the port's CPU run on every lane and to the JAX package's stored ones
    on the fixture lanes; then K2 against its plain version on every
    de-emphasis call of a second card run.  Returns the numbers of the
    kernels line and what the timing phase needs."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import dred as PD
    from opus_tpu_torch.dnn import dred_dec as PDD
    from opus_tpu_torch.dnn import rdovae as PV
    from opus_tpu_torch.ops import iir

    stats = PD.random_stats(43)
    dec = PV.random_dec_model(42, device="cpu")
    dreds, hist, off48, off16, n_fx = plc_lanes(
        pfx, dfx, PDD.OpusDREDDecoder(dec, stats, device="cpu"),
        dred["parsed"])
    card_dreds = PDD.OpusDREDDecoder(dec, stats, device=dev) \
        .process_batch(dreds)
    models = plc_models(dev)
    torch.cuda.synchronize()
    iir.launches = 0
    card, plc48 = deep_plc_sequence(models, card_dreds, hist, off48, off16,
                                    dev)
    torch.cuda.synchronize()
    k2 = iir.launches
    print(f"deep PLC launch counters (the sequence): K2 {k2}")
    if k2 != PLC_K2_LAUNCHES:
        fail(f"deep PLC: K2 launched {k2} times, expected {PLC_K2_LAUNCHES}")
    t0 = time.time()
    cpu_dreds = PDD.OpusDREDDecoder(dec, stats, device="cpu") \
        .process_batch(dreds)
    cpu, _ = deep_plc_sequence(plc_models("cpu"), cpu_dreds, hist, off48,
                               off16, "cpu")
    cpu_s = time.time() - t0
    e_cpu = compare_plc(card, cpu, "card vs the port's CPU run")
    tiled = {k: np.tile(pfx[k], (DRED_TILE,) + (1,) * (pfx[k].ndim - 1))
             for k in PLC_INT_KEYS + ("pcm48", "pcm48_16k", "pcm_pred",
                                      "pcm16", "feats", "afeats")}
    e_jax = compare_plc({k: v[:n_fx] for k, v in card.items()}, tiled,
                        "card vs the JAX package (fixture lanes)")
    n_dec = sum(card[k].size for k in PLC_INT_KEYS)
    _, k2_err = k2_spy(lambda: deep_plc_sequence(
        models, card_dreds, hist, off48, off16, dev))
    print(f"deep PLC at B={B_DNN}: {n_dec} integer decisions (pitch "
          f"periods of {card['apitch'].shape[1]} analysed and "
          f"{card['period'].shape[1]} concealed frames, FEC reads, loss "
          f"counts) equal on the card, the CPU and (fixture lanes) JAX; max "
          f"err vs the CPU run: 16 kHz PCM {e_cpu['pcm16']:.0f}/"
          f"{e_cpu['pcm_pred']:.0f}/{e_cpu['pcm48_16k']:.0f} LSB, 48 kHz "
          f"{e_cpu['pcm48']:.0f} LSB, features {e_cpu['feats']:.3g}, "
          f"analysis features {e_cpu['afeats']:.3g}; vs JAX ({n_fx} fixture "
          f"lanes): 16 kHz {e_jax['pcm16']:.0f}/{e_jax['pcm_pred']:.0f}/"
          f"{e_jax['pcm48_16k']:.0f}, 48 kHz {e_jax['pcm48']:.0f} LSB, "
          f"features {e_jax['feats']:.3g}/{e_jax['afeats']:.3g}; K2 == "
          f"plain on {K2_REL_TOL}-relative bound ({k2} launches at "
          f"[{B_DNN}, 40], max err {k2_err:.3g}); the CPU run took "
          f"{cpu_s:.1f} s (host)")
    return dict(k2=k2, k2_err=k2_err, models=models, dreds=card_dreds,
                cpu_dreds=cpu_dreds, n_fx=n_fx,
                hist=hist, off48=off48, e_cpu=e_cpu, e_jax=e_jax)


def phase_plc_times(dev, smi, d):
    """CUDA event times of the two calls a server makes on a lost tick:
    ``dred_decode`` of 60 ms at 48 kHz from the state after the 16 good
    frames (the blend == 0 catch-up analysis of 15 frames, FARGAN's
    priming, 6 concealed frames, the upsampler) and one ``conceal`` in a
    loss already under way; each call's device operations and device time
    (``device_time.device_profile``).  The state is restored before each
    call: it is tensors that are replaced, never written, so a shallow copy
    of the LPCNetPLC is a snapshot."""
    import copy
    import torch
    from opus_tpu_torch.models.deep_plc import BatchedDeepPLC
    from opus_tpu_torch.tools.device_time import device_profile

    plc = BatchedDeepPLC(*d["models"], B_DNN, fs=48000, device=dev)
    h = torch.as_tensor(d["hist"], device=dev)
    for k in range(16):
        plc.lpcnet.update(h[:, k])
    lp0, rs0 = copy.copy(plc.lpcnet), plc.rs

    def dred_call():
        plc.lpcnet, plc.rs = copy.copy(lp0), rs0
        return plc.dred_decode(d["dreds"], d["off48"], 2880)

    def timed(fn, reps):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return min(ts)

    ms_dred = timed(dred_call, 3)
    ops_dred, dev_dred = device_profile(dred_call, reps=2)
    dred_call()
    lp1 = copy.copy(plc.lpcnet)

    def conceal_call():
        plc.lpcnet = copy.copy(lp1)
        return plc.lpcnet.conceal()

    ms_conc = timed(conceal_call, 5)
    ops_conc, dev_conc = device_profile(conceal_call, reps=3)
    parts = plc_parts(lp0, plc.rs, timed)
    print(f"deep PLC times [{smi}]: dred_decode 60 ms at 48 kHz, B={B_DNN} "
          f"(catch-up of 15 frames, priming, 6 frames, upsampler): "
          f"{ms_dred:.3f} ms, {ops_dred:.0f} device operations and "
          f"{dev_dred:.3f} ms device time a call (device busy "
          f"{100 * dev_dred / ms_dred:.1f}%)")
    print(f"deep PLC times [{smi}]: one conceal (blend 1) at B={B_DNN}: "
          f"{ms_conc:.3f} ms -> {B_DNN * 10.0 / ms_conc:.0f} concealed "
          f"streams per card; {ops_conc:.0f} device operations and "
          f"{dev_conc:.3f} ms device time a call (device busy "
          f"{100 * dev_conc / ms_conc:.1f}%)")
    print(f"deep PLC times [{smi}]: dred_decode's parts at B={B_DNN}, ms a "
          f"call (device operations): " + "; ".join(
              f"{k} {v[0]:.3f} ({v[1]:.0f})" for k, v in parts.items()))
    n_a = parts["analysis frame"]
    est = 15 * n_a[0] + parts["Burg, 14 frames"][0] \
        + 16 * parts["PLC net"][0] + parts["FARGAN priming"][0] \
        + 6 * (parts["FARGAN frame"][0] + parts["upsampler 10 ms"][0])
    print(f"deep PLC times [{smi}]: 15 analysis frames + Burg + 16 PLC net "
          f"+ priming + 6 x (FARGAN frame + upsampler) = {est:.3f} ms of "
          f"the {ms_dred:.3f} ms dred_decode")
    return dict(plc_dred=ms_dred, plc_conceal=ms_conc)


def plc_parts(lp, rs, timed):
    """CUDA event times and device operations of the stages of a catch-up
    dred_decode, each alone on the state ``lp`` (an LPCNetPLC after the 16
    good frames): one frame of feature analysis, the Burg cepstra of the
    14 frames that feed the PLC network in one batch, one PLC network
    step, FARGAN's priming, one FARGAN frame and one 10 ms piece of the
    upsampler."""
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import features as PFe
    from opus_tpu_torch.dnn import plc as PL
    from opus_tpu_torch.silk.resampler import upsample_to_48k
    from opus_tpu_torch.tools.device_time import device_profile

    b = lp.batch
    x = 32768.0 * lp.pcm[:, :160]
    frames = torch.cat([32768.0 * lp.pcm[:, p:p + 160]
                        for p in range(160, 2400, 160)], dim=0)
    plc_in = torch.zeros(b, PL.PLC_INPUT, device=lp.device)
    cont = lp.cont_features.reshape(b, PL.CONT_VECTORS, PL.NB_FEATURES)
    feats = lp.features[:, :PL.NB_FEATURES]
    pcm16 = (x[:, :160] / 8).to(torch.int16)
    calls = {
        "analysis frame": lambda: PFe.compute_frame_features(
            lp.enc, x, lp.pitch_model),
        "Burg, 14 frames": lambda: PFe.burg_cepstral_analysis(frames),
        "PLC net": lambda: PL.compute_plc_pred(lp.model, lp.plc_net, plc_in),
        "FARGAN priming": lambda: PF.cont(
            lp.fargan_model, lp.fargan, lp.pcm[:, -PF.FARGAN_CONT_SAMPLES:],
            cont),
        "FARGAN frame": lambda: PF.synthesize_frame(lp.fargan_model,
                                                    lp.fargan, feats),
        "upsampler 10 ms": lambda: upsample_to_48k(pcm16, rs, 16,
                                                   frame_ms=10),
    }
    return {k: (timed(fn, 3), device_profile(fn, reps=2)[0])
            for k, fn in calls.items()}


# OSCE (LACE and NoLACE on the SILK-WB 20 ms decode path, the enhancer of
# tracked config 5, BASELINE.md:30): B_DNN lanes of the SILK fixture's 8
# streams tiled, plus N_BAD garbage/truncated ones, 8 frames; models
# random_lace_model(50) and random_nolace_model(60) at the published
# widths.  Held to tests/data/torch_osce_wb20ms.npz (the scalar decoder
# with OSCEEnhancer, tools/make_torch_osce_fixture.py) and to the port's
# CPU run of the 8 source streams: num_bits, the post-processed periods,
# numbits and the unenhanced PCM exactly; the enhanced int16 within
# osce_pcm_bound.  The float output differs by the order of the GEMM sums
# (up to 768 terms a product, ~sqrt(768) u = 1.7e-6 relative typical) in
# each of NoLACE's ~14 stages and by K2's scan against numpy's serial
# de-emphasis; each difference is relative to the magnitude it comes from,
# and the random-weight stages drive those far past full scale (peaks of
# 3-26 after the first frame, 700-3000 on NoLACE's first; 41-47% of the
# enhanced samples clip).  Bound: 1 LSB of rounding plus OSCE_RTOL (~500
# u: 14 stages of ~sqrt(768) u) of the larger peak |output| of the frame
# and the one before, in LSB (32768 a full scale).  The CPU tests measure
# at most 1 LSB (LACE) and 2 (NoLACE) against JAX.
OSCE_FIXTURE = os.path.join(REPO, "tests", "data", "torch_osce_wb20ms.npz")
OSCE_LSB = 1
OSCE_RTOL = 3e-5
OSCE_SEEDS = {1: 50, 2: 60}              # LACE, NoLACE


def osce_pcm_bound(env):
    """The enhanced int16 PCM's bound (LSB) against another computation of
    it, for a frame whose float output and the previous frame's peak at
    ``env`` (full scale 1)."""
    return OSCE_LSB + 32768.0 * OSCE_RTOL * env


def osce_models(device):
    from opus_tpu_torch.dnn import osce as PO
    return {1: PO.random_lace_model(OSCE_SEEDS[1], device=device),
            2: PO.random_nolace_model(OSCE_SEEDS[2], device=device)}


def osce_env(ofx, m: int):
    """[8, NFRAMES] the peak |float output| of each fixture lane-frame and
    the frame before (method m); the first frame passes through: 0."""
    import numpy as np
    peak = ofx["peak"][m - 1]
    env = np.maximum(peak, np.concatenate([peak[:, :1], peak[:, :-1]], 1))
    env[:, 0] = 0.0
    return env


def osce_compare(got, ref, env, what):
    """got, ref [8 or more lanes tiled from the 8 streams, NFRAMES, 320]
    int16: fails where |got - ref| > osce_pcm_bound(env of the lane's
    stream).  Returns (max LSB, max of the error over its bound)."""
    import numpy as np
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64)).max(axis=2)
    bnd = osce_pcm_bound(env[np.arange(d.shape[0]) % env.shape[0]])
    if (d > bnd).any():
        lane, f = np.argwhere(d > bnd)[0]
        fail(f"OSCE {what}: lane {lane} frame {f} differs by {d[lane, f]} "
             f"LSB, bound {bnd[lane, f]:.2f}")
    return int(d.max()), float((d / bnd).max())


# BBWE and OSCE on hybrid frames.  bbwe_pcm_bound: BBWE's int16
# output against another computation of it.  With the same 16 kHz input,
# the float output differs by the order of the GEMM sums (up to 384 terms
# a product) in the feature net and its ~10 stages and by the float64 FFT
# of the features, each relative to the magnitude it comes from (the
# random model drives frame peaks of 0.3-2237 full scales): 1 LSB of
# rounding plus BBWE_RTOL (OSCE's budget) of the larger peak |float
# output| of the reference's frame and the one before.  Behind an
# enhancer, half the fixture lanes hand the reference's enhanced frames
# on (feed_enhanced), so BBWE is held there with its inputs equal; on the
# rest its inputs differ by the enhancers' difference, and BBWE moves
# its output by up to 49 LSB
# for one input sample moved by 1 LSB on the standalone streams, printed
# by tools/make_torch_bbwe_fixture.py (the stream whose output saturates
# at 2237 full scales flips sign; it is compared with its inputs equal
# only): BBWE_GAIN LSB per LSB of the inputs' L1 difference over the
# frames so far (the feature net's GRU carries every frame forward).  The
# SILK upsampler likewise: UPS_GAIN per LSB plus 1 of rounding, 0 where
# the inputs agree (it is integer-exact).  Hybrid PCM: PCM_ABS_TOL plus
# the SILK half's int16 bound / 32768.
BBWE_FIXTURE = os.path.join(REPO, "tests", "data", "torch_bbwe.npz")
BBWE_SEED = 70
BBWE_LSB = 1
BBWE_RTOL = 3e-5
BBWE_GAIN = 64
UPS_GAIN = 4
OSCE_HYB_FRAMES = 3     # frames of each osce_hybrid run
HYB_FRAMES = 3          # frames of hybrid PCM in the BBWE fixture (its
                        # final ranges and enhanced SILK half: NFRAMES)
# the fixture lanes that hand the reference's enhanced frames on to what
# follows the enhancer (feed_enhanced), and the rest
FED, UNFED = slice(0, B_DNN // 2), slice(B_DNN // 2, B_DNN)


def bbwe_pcm_bound(env, dev=0):
    """BBWE's int16 output bound (LSB) against another computation of it,
    for a frame whose float output and the previous frame's peak at
    ``env`` (full scale 1) and whose inputs so far differ by ``dev`` (L1,
    LSB)."""
    return BBWE_LSB + 32768.0 * BBWE_RTOL * env + BBWE_GAIN * dev


def up48_bound(dev):
    """The 48 kHz upsampler's int16 output bound (LSB) against another
    computation whose 16 kHz inputs so far differ by ``dev`` (L1, LSB)."""
    import numpy as np
    dev = np.asarray(dev, np.float64)
    return np.where(dev > 0, 1 + UPS_GAIN * dev, 0.0)


def hybrid_pcm_bound(silk_lsb):
    """Hybrid PCM bound on [-1, 1] for a SILK half within ``silk_lsb``."""
    return PCM_ABS_TOL + silk_lsb / 32768.0


def hybrid_fixture_pcm(bfx, hfx, name):
    """[8, HYB_FRAMES, 960] f32: the scalar decoder's hybrid PCM of the
    BBWE fixture's run ``name``, kept as the SILK half's change in LSB
    from the plain hybrid fixture's PCM (hfx)."""
    import numpy as np
    return (hfx["pcm"][:, :HYB_FRAMES].astype(np.float64)
            + bfx[name + "_dlsb"] / 32768.0).astype(np.float32)


def peak_env(peak):
    """[..., F] peaks -> the larger of each frame's and the previous
    frame's."""
    import numpy as np
    peak = np.asarray(peak, np.float64)
    return np.maximum(peak, np.concatenate([peak[..., :1], peak[..., :-1]],
                                           axis=-1))


def cum_dev(a, b):
    """a, b [L, F, N] int16 values -> [L, F] the L1 difference (LSB) over
    frames 0..f."""
    import numpy as np
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64)).sum(-1)
    return np.cumsum(d, axis=1)


def within(got, ref, bnd, what):
    """got, ref [L, F, N]; bnd [L, F] (or broadcastable): fails where the
    largest |got - ref| of a lane-frame exceeds its bound.  Returns (max
    error, max of the error over its bound, largest bound)."""
    import numpy as np
    d = np.abs(np.asarray(got, np.float64)
               - np.asarray(ref, np.float64)).max(axis=-1)
    bnd = np.broadcast_to(np.asarray(bnd, np.float64), d.shape)
    if (d > bnd).any():
        lane, f = np.argwhere(d > bnd)[0]
        fail(f"{what}: lane {lane} frame {f} differs by {d[lane, f]:.6g}, "
             f"bound {bnd[lane, f]:.6g}")
    return (float(d.max()), float((d / np.maximum(bnd, 1e-30)).max()),
            float(bnd.max()))


def feed_enhanced(enh, frames=None, lanes=None):
    """Record the outputs of the enhancer ``enh`` (``OSCEEnhancer``) and
    what the decoder goes on with: its own output, or on ``lanes`` the
    f-th call's ``frames[f]`` ([F, lanes, N] int on its device), another
    computation's enhanced frames.  What follows the enhancer (the
    2-sample buffer, the upsampler or BBWE) then sees that computation's
    input and is held to it with no upstream difference.  Returns the
    lists (own, passed), filled call by call."""
    own, passed = [], []
    orig = enh.enhance_frame

    def wrapped(*a, **k):
        y = orig(*a, **k)
        own.append(y)
        if frames is not None:
            y = y.clone()
            y[lanes] = frames[len(passed)].to(y.dtype)
        passed.append(y)
        return y

    enh.enhance_frame = wrapped
    return own, passed


def bbwe_model(device):
    from opus_tpu_torch.dnn import bbwe as PB
    return PB.random_model(BBWE_SEED, device=device)


def phase_osce(dev, sfx, ofx):
    """The osce phase: decode the SILK lanes once on the card with state
    carried (keeping the unenhanced PCM and the OSCE inputs), enhance them
    with LACE and with NoLACE (OSCEEnhancer, state carried; K2 against its
    plain version on every de-emphasis), then FusedSilkDecoder.set_osce
    end to end once per method with the K2 and K4 counters reset around
    it.  Returns the kernels line's numbers and what the timing needs."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import osce as PO
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import iir, lpc

    lanes, stream = make_lanes(sfx, np.random.default_rng(25), B_DNN)
    b, p = lanes[0][0].shape
    bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
            for bu, ln in lanes]
    dec = PF.FusedSilkDecoder(b, device=dev, max_payload=p)
    plain, inputs, errs = [], [], []
    for buf, ln in bufs:
        xq, err = dec.decode_packed(buf, ln, osce_inputs=True)
        plain.append(xq.to(torch.int64))
        inputs.append(dec.osce_in)
        errs.append(err)
    xq_all = torch.stack(plain, 1).cpu().numpy()
    if not np.array_equal(xq_all[:B_DNN], sfx["xq"][stream]):
        fail("OSCE: the unenhanced PCM differs from the scalar decoder's")
    nbits = torch.stack([x["num_bits"] for x in inputs], 1).cpu().numpy()
    fx_lanes = torch.stack(errs, 1)[:B_DNN].any(1).logical_not() \
        .cpu().numpy()
    if not fx_lanes.all():
        fail("OSCE: fixture lanes flagged by the decoder")
    models = osce_models(dev)
    cpu_models = osce_models("cpu")
    out = {"k2_err": 0.0, "counts": {}, "plain": plain, "inputs": inputs,
           "models": models}
    for m, name in ((1, "LACE"), (2, "NoLACE")):
        if not np.array_equal(nbits[:B_DNN], ofx["num_bits"][m - 1][stream]):
            fail(f"OSCE {name}: num_bits differ from the scalar decoder's")
        enh = PO.OSCEEnhancer(m, models[m], b, device=dev)

        def run():
            res = []
            for f in range(NFRAMES):
                y = enh.enhance_frame(plain[f], **inputs[f])
                _feats, numbits, periods = enh.frame_features
                res.append((y, numbits, periods))
            return res

        res, k2_err = k2_spy(run, PO)
        out["k2_err"] = max(out["k2_err"], k2_err)
        enh_pcm = torch.stack([r[0] for r in res], 1).cpu().numpy()
        periods = torch.stack([r[2] for r in res], 1).cpu().numpy()
        numbits = torch.stack([r[1] for r in res], 1).cpu().numpy()
        if not np.array_equal(periods[:B_DNN], ofx["periods"][m - 1][stream]):
            fail(f"OSCE {name}: periods differ from the scalar decoder's")
        if not np.array_equal(numbits[:B_DNN],
                              ofx["numbits"][m - 1][stream]):
            fail(f"OSCE {name}: numbits differ from the scalar decoder's")
        # (clipped to +-32767, which only a garbage lane's -32768 meets)
        if not np.array_equal(enh_pcm[:, 0], xq_all[:, 0].clip(-32767)):
            fail(f"OSCE {name}: the first frame is not the unenhanced one")
        finite = all(bool(torch.isfinite(t).all()) for t in
                     torch.utils._pytree.tree_leaves(enh.state)
                     if t.is_floating_point())
        if not finite:
            fail(f"OSCE {name}: a lane's state is not finite")
        env = osce_env(ofx, m)
        e_fx = osce_compare(enh_pcm[:B_DNN], ofx["xq"][m - 1][stream], env,
                            f"{name} card vs the scalar decoder")
        # the port's CPU run of the 8 source streams, from their inputs
        cpu = PO.OSCEEnhancer(m, cpu_models[m], 8, device="cpu")
        cpu_pcm = np.stack([cpu.enhance_frame(
            plain[f][:8].cpu(), **{k: (v[:8].cpu() if torch.is_tensor(v)
                                       else v)
                                   for k, v in inputs[f].items()}).numpy()
            for f in range(NFRAMES)], 1)
        e_cpu = osce_compare(enh_pcm[:B_DNN], cpu_pcm[stream], env,
                             f"{name} card vs the port's CPU run")
        osce_compare(cpu_pcm, ofx["xq"][m - 1], env,
                     f"{name} CPU run vs the scalar decoder")

        # end to end, as a user drives it
        e2e = PF.FusedSilkDecoder(b, device=dev, max_payload=p)
        e2e.set_osce(m, models[m])
        torch.cuda.synchronize()
        iir.launches = lpc.launches = 0
        got = [e2e.decode_packed(buf, ln)[0] for buf, ln in bufs]
        torch.cuda.synchronize()
        counts = {"K2": iir.launches, "K4": lpc.launches}
        if counts != {"K2": NFRAMES, "K4": 4 * NFRAMES}:
            fail(f"OSCE {name} end to end: launches {counts}, expected K2 "
                 f"{NFRAMES} and K4 {4 * NFRAMES}")
        got = torch.stack(got, 1).to(torch.int64).cpu().numpy()
        e_e2e = osce_compare(got[:B_DNN], ofx["xq"][m - 1][stream], env,
                             f"{name} end to end vs the scalar decoder")
        same = int((got == enh_pcm).all(axis=2).sum())
        clip = float(np.mean(np.abs(got[:B_DNN, 1:]) >= 32767))
        out["counts"][name] = counts
        out[name] = dict(e_fx=e_fx, e_cpu=e_cpu, e_e2e=e_e2e)
        print(f"OSCE {name} at B={b} ({B_DNN} fixture lanes, {N_BAD} "
              f"garbage): num_bits, periods, numbits and the unenhanced PCM "
              f"== the scalar decoder's on every fixture lane-frame; first "
              f"frame == unenhanced; enhanced int16 max diff {e_fx[0]} LSB "
              f"vs the scalar decoder ({e_fx[1]:.2f} of the bound), "
              f"{e_cpu[0]} vs the port's CPU run ({e_cpu[1]:.2f}); end to "
              f"end {e_e2e[0]} LSB ({e_e2e[1]:.2f}), {same}/{b * NFRAMES} "
              f"lane-frames identical to the enhancer alone; launches "
              f"{counts}; K2 == plain within {K2_REL_TOL}-relative (max err "
              f"{k2_err:.3g}); {100 * clip:.1f}% of enhanced samples clip; "
              f"garbage lanes finite, "
              f"{int(torch.stack(errs, 1)[B_DNN:, -1].sum())} flagged")
    out["bufs"] = bufs
    return out


def phase_osce_times(dev, smi, d):
    """CUDA event times at B_DNN streams, host included, of decode_packed
    without OSCE, with LACE and with NoLACE (the second frame's packets,
    state carried; one timed call each after a warm-up call) and of one
    OSCEEnhancer frame alone per method; realtime streams = B x 20 ms /
    step.  Device operations and device time (device_profile, after every
    timing): of the decode without OSCE and of each enhancer alone, whose
    sum is the decode with OSCE (the enhancer runs after the decode, on
    the same stream; profiling the whole decode again would add ~40 s of
    the profiler's own host time per method).  K2's device time at
    [B_DNN, 320]."""
    import torch
    from opus_tpu_torch.dnn import osce as PO
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import iir
    from opus_tpu_torch.tools.device_time import device_ms, device_profile

    buf, ln = (x[:B_DNN] for x in d["bufs"][1])
    xq = d["plain"][1][:B_DNN]
    inp = {k: (v[:B_DNN] if torch.is_tensor(v) else v)
           for k, v in d["inputs"][1].items()}
    names = {0: "none", 1: "LACE", 2: "NoLACE"}
    decs, enhs, ms = {}, {}, {}
    for m in names:
        decs[m] = PF.FusedSilkDecoder(B_DNN, device=dev,
                                      max_payload=buf.shape[1])
        if m:
            decs[m].set_osce(m, d["models"][m])
            enhs[m] = PO.OSCEEnhancer(m, d["models"][m], B_DNN, device=dev)
            for _ in range(2):            # past the reset's pass-through
                enhs[m].enhance_frame(xq, **inp)
    for m in (0, 1, 2):
        ms[m] = cuda_ms(lambda: decs[m].decode_packed(buf, ln), 1)
    ms_e = {m: cuda_ms(lambda: enhs[m].enhance_frame(xq, **inp), 5)
            for m in (1, 2)}
    ops0, dev0 = device_profile(lambda: decs[0].decode_packed(buf, ln), 1)
    prof_e = {m: device_profile(lambda: enhs[m].enhance_frame(xq, **inp), 2)
              for m in (1, 2)}
    res = {}
    for m, name in names.items():
        ops, dms = ops0, dev0
        if m:
            ops, dms = ops0 + prof_e[m][0], dev0 + prof_e[m][1]
        res[name] = ms[m]
        print(f"OSCE times [{smi}]: decode_packed at B={B_DNN}, OSCE "
              f"{name}: {ms[m]:.3f} ms a 20 ms frame -> "
              f"{B_DNN * 20.0 / ms[m]:.0f} realtime streams; {ops:.0f} "
              f"device operations and {dms:.3f} ms device time a call"
              f"{' (the decode and the enhancer profiled apart)' if m else ''}"
              f" (device busy {100 * dms / ms[m]:.1f}%)")
    for m in (1, 2):
        ops_e, dev_e = prof_e[m]
        res[names[m] + " enhancer"] = ms_e[m]
        print(f"OSCE times [{smi}]: one OSCEEnhancer frame alone, "
              f"{names[m]}, B={B_DNN}: {ms_e[m]:.3f} ms -> "
              f"{B_DNN * 20.0 / ms_e[m]:.0f} realtime streams; {ops_e:.0f} "
              f"device operations and {dev_e:.3f} ms device time a call "
              f"(device busy {100 * dev_e / ms_e[m]:.1f}%)")
    x = torch.randn(B_DNN, 320, device=dev) * 0.1
    mem = torch.zeros(B_DNN, device=dev)
    k2 = device_ms(lambda: iir.deemphasis(x, mem, PO.PREEMPH),
                   "deemphasis_kernel")
    k2_bound = bound(2 * nbytes_of(x, mem), 2.0 * x.numel())
    print(f"OSCE times [{smi}]: K2 at [{B_DNN}, 320]: {k2:.5f} ms device "
          f"time, bound {k2_bound[0]:.6f} ms ({k2_bound[1]})")
    return {"osce_" + k: v for k, v in res.items()}


def bbwe_lanes(bfx, rng):
    """[B_DNN + N_BAD, NFRAMES, 320] int64: the standalone BBWE streams
    tiled over B_DNN lanes, then 16 lanes of full-scale random samples and
    16 of silence with isolated full-scale clicks."""
    import numpy as np
    x = bfx["bbwe_in"].astype(np.int64)
    ns, nf, n = x.shape
    out = np.zeros((B_DNN + N_BAD, nf, n), np.int64)
    out[:B_DNN] = x[np.arange(B_DNN) % ns]
    out[B_DNN:B_DNN + N_BAD // 2] = rng.integers(-32768, 32768,
                                                 (N_BAD // 2, nf, n))
    for j in range(N_BAD // 2):
        lane = B_DNN + N_BAD // 2 + j
        pos = rng.integers(0, n, (nf, 3))
        for f in range(nf):
            out[lane, f, pos[f]] = rng.choice([-32768, 32767], 3)
    return out


def cpu_lanes():
    """The lanes a CPU run of a B_DNN + N_BAD batch covers: the first lane
    of each of the 8 fixture streams, then the N_BAD garbage lanes."""
    import numpy as np
    return np.concatenate([np.arange(8), B_DNN + np.arange(N_BAD)])


def silk48_run(bufs, dev, bwe=None, nolace=None, feed=None):
    """The SILK lanes through FusedSilkDecoder(fs_out=48000) on ``dev``
    (the card, or the CPU for the port's CPU run), with BBWE and NoLACE
    when given, NoLACE's output fed as ``feed_enhanced(enhancer, *feed)``,
    the K2 and K4 counters reset around the run.  Returns (pcm [L, F,
    960] int64, final ranges, BBWE peaks [L, F], NoLACE's own output and
    what the decoder went on with, [L, F, 320] each (None without
    NoLACE), counts)."""
    import torch
    from opus_tpu_torch.dnn import osce as PO
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import iir, lpc

    b, p = bufs[0][0].shape
    cuda = torch.device(dev).type == "cuda"
    dec = PF.FusedSilkDecoder(b, device=dev, max_payload=p, fs_out=48000)
    if bwe is not None:
        dec.set_osce_bwe(bwe)
    enh = None
    if nolace is not None:
        dec.set_osce(PO.OSCE_METHOD_NOLACE, nolace)
        enh = feed_enhanced(dec.osce, *(feed or ()))
    if cuda:
        torch.cuda.synchronize()
    iir.launches = lpc.launches = 0
    pcm, rng, peak = [], [], []
    for buf, ln in bufs:
        xq, _err = dec.decode_packed(buf, ln)
        pcm.append(xq.to(torch.int64))
        rng.append(dec.final_range)
        peak.append(dec.bwe.peak if bwe is not None
                    else torch.zeros(b, device=dev))
    if cuda:
        torch.cuda.synchronize()
    counts = {"K2": iir.launches, "K4": lpc.launches}

    def host(ts):
        return torch.stack(ts, 1).cpu().numpy()
    return (host(pcm), host(rng), host(peak),
            None if enh is None else tuple(host(e) for e in enh), counts)


def frames_first(x, dev):
    """[L, F, N] numpy -> [F, L, N] on ``dev`` (feed_enhanced's frames)."""
    import numpy as np
    import torch
    return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))) \
        .to(dev)


def phase_bbwe(dev, sfx, bfx, ofx):
    """The bbwe phase.  BBWE alone on the card over the fixture's streams
    tiled to B_DNN lanes plus N_BAD garbage ones, against the JAX fixture
    and the port's CPU run; then the SILK lanes (B_DNN + N_BAD) through
    FusedSilkDecoder at 48 kHz end to end, plain, with BBWE and with
    NoLACE + BBWE (decoder complexity 7), the K2 and K4 counters reset
    around each run; each held to the scalar decoder (fixture lanes) and
    to the port's CPU run of the same decoder (the 8 streams' first lanes
    and the garbage lanes).  Behind NoLACE the fed lanes hand the scalar
    decoder's enhanced frames on to BBWE, and the CPU run is handed the
    card's.  Returns the kernels line's numbers and what the timing
    needs."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import bbwe as PB

    model, cpu_model = bbwe_model(dev), bbwe_model("cpu")
    sel = cpu_lanes()
    out = {"counts": {}, "model": model}

    # ---- BBWE alone ----
    x = bbwe_lanes(bfx, np.random.default_rng(27))
    b = x.shape[0]
    ext, cpu = PB.BBWE(model, b, device=dev), PB.BBWE(cpu_model, len(sel),
                                                      device="cpu")
    got, ref, ref_peak = [], [], []
    for f in range(NFRAMES):
        got.append(ext.process(torch.from_numpy(x[:, f]).to(dev)))
        ref.append(cpu.process(torch.from_numpy(x[sel, f])).numpy())
        ref_peak.append(cpu.peak.numpy())
    got = torch.stack(got, 1).cpu().numpy()
    ref, ref_peak = np.stack(ref, 1), np.stack(ref_peak, 1)
    stream = np.arange(B_DNN) % 8
    e_fx = within(got[:B_DNN], bfx["bbwe_out"][stream],
                  bbwe_pcm_bound(peak_env(bfx["bbwe_peak"])[stream]),
                  "BBWE alone, card vs JAX")
    bnd_cpu = bbwe_pcm_bound(peak_env(ref_peak))
    e_cpu = within(got[sel], ref, bnd_cpu,
                   "BBWE alone, card vs the port's CPU run")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 torch.utils._pytree.tree_leaves(ext.state)
                 if t.is_floating_point())
    if not finite:
        fail("BBWE alone: a lane's state is not finite")
    out["x"] = x
    print(f"BBWE alone at B={b} ({B_DNN} fixture lanes, {N_BAD} garbage): "
          f"int16 max diff {e_fx[0]:.0f} LSB vs JAX ({e_fx[1]:.2f} of the "
          f"bound; largest bound {e_fx[2]:.1f} LSB), {e_cpu[0]:.0f} vs the "
          f"port's CPU run ({e_cpu[1]:.2f}; {e_cpu[2]:.1f}; "
          f"{int((bnd_cpu >= 65535).sum())}/{bnd_cpu.size} lane-frames "
          f"with a bound past the int16 range); "
          f"{100 * float(np.mean(np.abs(got) >= 32767)):.1f}% of samples "
          f"clip; state finite")

    # ---- SILK at 48 kHz, end to end ----
    lanes, sstream = make_lanes(sfx, np.random.default_rng(26), B_DNN)
    bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
            for bu, ln in lanes]
    cpu_bufs = [(torch.from_numpy(bu[sel]), torch.from_numpy(ln[sel]))
                for bu, ln in lanes]
    nolace, cpu_nolace = osce_models(dev)[2], osce_models("cpu")[2]
    out["bufs"] = bufs
    ref16 = ofx["xq"][1][sstream]             # the scalar decoder's NoLACE
    fed, rest = FED, UNFED
    runs = (("plain", None, None), ("BBWE", model, None),
            ("NoLACE + BBWE", model, nolace))
    keys = {"plain": "silk48", "BBWE": "silk48_bwe",
            "NoLACE + BBWE": "silk48_nolace_bwe"}
    for name, bwe, osc in runs:
        feed = None if osc is None else (frames_first(ref16[fed], dev), fed)
        pcm, rng, pk, enh, counts = silk48_run(bufs, dev, bwe, osc, feed)
        c_feed = None if osc is None else (
            frames_first(enh[1][sel], "cpu"), slice(None))
        c_pcm, c_rng, c_pk, c_enh, _ = silk48_run(
            cpu_bufs, "cpu", None if bwe is None else cpu_model,
            None if osc is None else cpu_nolace, c_feed)
        want = {"K2": NFRAMES if osc is not None else 0,
                "K4": 4 * NFRAMES}
        if counts != want:
            fail(f"SILK 48 kHz {name}: launches {counts}, expected {want}")
        if not np.array_equal(rng[:B_DNN],
                              sfx["final_range"][sstream].astype(np.int64)):
            fail(f"SILK 48 kHz {name}: final ranges differ from the scalar "
                 f"decoder's")
        if not np.array_equal(rng[sel], c_rng):
            fail(f"SILK 48 kHz {name}: final ranges differ from the CPU run")
        ref_fx = bfx[keys[name] + "_xq"][sstream]
        if bwe is None:
            if not np.array_equal(pcm[:B_DNN], ref_fx) or \
                    not np.array_equal(pcm[sel], c_pcm):
                fail("SILK 48 kHz plain: the int16 differs from the scalar "
                     "decoder's or the CPU run's")
            note = "bit-exact"
        else:
            env_fx = peak_env(bfx[keys[name] + "_peak"])[sstream]
            e_cpu = within(pcm[sel], c_pcm, bbwe_pcm_bound(peak_env(c_pk)),
                           f"SILK 48 kHz {name}, card vs the port's CPU run")
            if osc is None:
                e_fx = within(pcm[:B_DNN], ref_fx, bbwe_pcm_bound(env_fx),
                              f"SILK 48 kHz {name}, card vs the scalar "
                              f"decoder")
                note = (f"int16 max diff {e_fx[0]:.0f} LSB vs the scalar "
                        f"decoder ({e_fx[1]:.2f} of the bound; largest "
                        f"bound {e_fx[2]:.1f} LSB), {e_cpu[0]:.0f} vs the "
                        f"port's CPU run ({e_cpu[1]:.2f}; {e_cpu[2]:.1f})")
            else:
                own, passed = enh
                osce_compare(own[:B_DNN], ref16, osce_env(ofx, 2),
                             "NoLACE at 48 kHz, card vs the scalar decoder")
                osce_compare(own[:8], c_enh[0][:8], osce_env(ofx, 2),
                             "NoLACE at 48 kHz, card vs the port's CPU run")
                dv = cum_dev(passed[:B_DNN], ref16)
                bnd = bbwe_pcm_bound(env_fx, dv)
                e_fed = within(pcm[fed], ref_fx[fed], bnd[fed],
                               f"SILK 48 kHz {name}, fed lanes, card vs the "
                               f"scalar decoder")
                e_fx = within(pcm[rest], ref_fx[rest], bnd[rest],
                              f"SILK 48 kHz {name}, card vs the scalar "
                              f"decoder")
                note = (f"int16 max diff {e_fed[0]:.0f} LSB vs the scalar "
                        f"decoder on the {fed.stop} lanes that hand its "
                        f"NoLACE output on to BBWE ({e_fed[1]:.2f} of the "
                        f"bound; largest bound {e_fed[2]:.1f} LSB), "
                        f"{e_fx[0]:.0f} on the rest ({e_fx[1]:.2f}; "
                        f"{e_fx[2]:.1f}; BBWE's inputs equal so far on "
                        f"{int((dv[rest] == 0).sum())}/{dv[rest].size} "
                        f"lane-frames); {e_cpu[0]:.0f} vs the port's CPU "
                        f"run handed the card's NoLACE output "
                        f"({e_cpu[1]:.2f}; {e_cpu[2]:.1f})")
        out["counts"][name] = counts
        print(f"SILK 48 kHz {name} at B={B_DNN + N_BAD}: final ranges == "
              f"the scalar decoder's and the CPU run's; {note}; launches "
              f"{counts}")
    return out


def phase_osce_hybrid(dev, bfx):
    """The osce_hybrid phase: the FB and SWB hybrid fixtures tiled to B_DNN
    lanes plus N_BAD garbage ones through FusedHybridDecoder with LACE and
    with NoLACE, each without and with BBWE, the first OSCE_HYB_FRAMES
    frames (the phase's 8 runs kept the whole script within its time
    limit no longer once the SILK / hybrid loss phase came), the K1, K2
    and K4 counters reset around each run and K2 held to its plain
    version on OSCE's de-emphasis.  Against the scalar decoder on the
    fixture lanes: the final ranges and the enhanced SILK half on every
    frame, the PCM on the first HYB_FRAMES; the fed lanes hand the scalar
    decoder's enhanced SILK half on to the upsampler or BBWE."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import osce as PO
    from opus_tpu_torch.models import hybrid_dec_fused as PH
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir, lpc

    models = osce_models(dev)
    bbwe = bbwe_model(dev)
    out = {"counts": {}, "k2_err": 0.0}
    nf, hf = OSCE_HYB_FRAMES, HYB_FRAMES
    fed, rest = FED, UNFED
    for bw, path, end, seed in (("fb", HYB_FIXTURE, 21, 28),
                                ("swb", SWB_FIXTURE, 19, 29)):
        hfx = dict(np.load(path))
        lanes, stream = make_lanes(hfx, np.random.default_rng(seed), B_DNN)
        bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
                for bu, ln in lanes]
        b, p = bufs[0][0].shape
        if bw == "fb":
            out["bufs"] = bufs
        bufs = bufs[:nf]
        for m, with_bwe in ((1, False), (2, False), (1, True), (2, True)):
            mname = "lace" if m == 1 else "nolace"
            name = f"hyb_{bw}_{mname}" + ("_bwe" if with_bwe else "")
            ref16 = bfx[f"hyb_{bw}_{mname}_xq16"][stream][:, :nf]
            dec = PH.FusedHybridDecoder(b, end=end, max_payload=p, device=dev)
            dec.set_osce(m, models[m])
            if with_bwe:
                dec.set_osce_bwe(bbwe)
            own, passed = feed_enhanced(dec.osce,
                                        frames_first(ref16[fed], dev), fed)

            def run():
                torch.cuda.synchronize()
                CK.launches = iir.launches = lpc.launches = 0
                res = []
                for buf, ln in bufs:
                    pcm, err = dec.decode_packed(buf, ln)
                    res.append((pcm, err, dec.final_range.clone()))
                torch.cuda.synchronize()
                return res, {"K1": CK.launches, "K2": iir.launches,
                             "K4": lpc.launches}

            (res, counts), k2_err = k2_spy(run, PO)
            want = {"K1": nf, "K2": 2 * nf, "K4": 4 * nf}
            if counts != want:
                fail(f"{name}: launches {counts}, expected {want}")
            out["k2_err"] = max(out["k2_err"], k2_err)
            pcm, errs, rng = (torch.stack([r[i] for r in res], 1).cpu()
                              .numpy() for i in range(3))
            e16 = torch.stack(own, 1).cpu().numpy()
            fed16 = torch.stack(passed, 1).cpu().numpy()
            if errs[:B_DNN].any():
                fail(f"{name}: fixture lanes flagged by the decoder")
            if not np.array_equal(rng[:B_DNN],
                                  bfx[name + "_rng"][stream][:, :nf]):
                fail(f"{name}: final ranges differ from the scalar decoder's")
            if not np.isfinite(pcm).all():
                fail(f"{name}: PCM not finite")
            env_o = peak_env(bfx[name + "_osce_peak"])[stream][:, :nf]
            env_o[:, 0] = 0.0              # the first frame passes through
            e_16 = within(e16[:B_DNN], ref16, osce_pcm_bound(env_o),
                          f"{name}: the enhanced SILK half vs the scalar "
                          f"decoder's")
            dv = cum_dev(fed16[:B_DNN, :hf], ref16[:, :hf])
            if with_bwe:
                silk = bbwe_pcm_bound(
                    peak_env(bfx[name + "_bwe_peak"])[stream, :hf], dv)
            else:
                silk = up48_bound(dv)
            bnd = hybrid_pcm_bound(silk)
            ref = hybrid_fixture_pcm(bfx, hfx, name)[stream]
            e_fed = within(pcm[fed, :hf], ref[fed], bnd[fed],
                           f"{name}: PCM vs the scalar decoder's, fed lanes")
            e_pcm = within(pcm[rest, :hf], ref[rest], bnd[rest],
                           f"{name}: PCM vs the scalar decoder's")
            out["counts"][name] = counts
            print(f"{name} at B={b} ({B_DNN} fixture lanes, {N_BAD} garbage, "
                  f"{nf} frames): final ranges == the scalar decoder's; "
                  f"enhanced SILK half within {e_16[0]:.0f} LSB "
                  f"({e_16[1]:.2f} of the bound); PCM of the first {hf} "
                  f"frames within {e_fed[0]:.3g} ({e_fed[1]:.2f} of the "
                  f"bound; largest bound {e_fed[2]:.3g}) on the {fed.stop} "
                  f"lanes that hand the scalar decoder's SILK half on, "
                  f"{e_pcm[0]:.3g} ({e_pcm[1]:.2f}; {e_pcm[2]:.3g}) on the "
                  f"rest, their SILK half's inputs equal so far on "
                  f"{int((dv[rest] == 0).sum())}/{dv[rest].size} lane-frames;"
                  f" launches {counts}; K2 == plain on OSCE's de-emphasis "
                  f"(max err {k2_err:.3g})")
    out["models"], out["bbwe"] = models, bbwe
    return out


def phase_bbwe_times(dev, smi, d, h):
    """CUDA event times at B_DNN streams, host included: one BBWE frame
    alone (20 ms, the standalone streams' second frame, state carried)
    with its device operations and busy share (device_profile); the
    48 kHz SILK decode without and with BBWE (the second frame's packets)
    and the FB hybrid decode with NoLACE and with NoLACE + BBWE (the first
    frame's; without OSCE it is phase_hybrid_times' step), each one timed
    call after a warm-up call, as the other decodes.  The decodes' device
    time is not profiled: the profiler's own host time on a ~72 000-
    operation decode would add ~40 s a call."""
    import torch
    from opus_tpu_torch.dnn import bbwe as PB
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.models import hybrid_dec_fused as PH
    from opus_tpu_torch.tools.device_time import device_profile

    x = torch.from_numpy(d["x"][:B_DNN, 1]).to(dev)
    ext = PB.BBWE(d["model"], B_DNN, device=dev)
    ext.process(x)
    ms_b = cuda_ms(lambda: ext.process(x), 5)
    ops_b, dev_b = device_profile(lambda: ext.process(x), 2)
    print(f"BBWE times [{smi}]: one BBWE frame alone (20 ms) at B={B_DNN}: "
          f"{ms_b:.3f} ms -> {B_DNN * 20.0 / ms_b:.0f} realtime streams; "
          f"{ops_b:.0f} device operations and {dev_b:.3f} ms device time a "
          f"call (device busy {100 * dev_b / ms_b:.1f}%)")

    buf, ln = (t[:B_DNN] for t in d["bufs"][1])
    ms = {}
    for k in ("plain", "BBWE"):
        dec = PF.FusedSilkDecoder(B_DNN, device=dev, fs_out=48000,
                                  max_payload=buf.shape[1])
        if k == "BBWE":
            dec.set_osce_bwe(d["model"])
        ms[k] = cuda_ms(lambda: dec.decode_packed(buf, ln), 1)
        print(f"BBWE times [{smi}]: FusedSilkDecoder(fs_out=48000) "
              f"decode_packed at B={B_DNN}, {k}: {ms[k]:.3f} ms a 20 ms frame "
              f"-> {B_DNN * 20.0 / ms[k]:.0f} realtime streams")

    hbuf, hln = (t[:B_DNN] for t in h["bufs"][0])
    hms = {}
    for k in ("NoLACE", "NoLACE + BBWE"):
        dec = PH.FusedHybridDecoder(B_DNN, max_payload=hbuf.shape[1],
                                    device=dev)
        dec.set_osce(2, h["models"][2])
        if k == "NoLACE + BBWE":
            dec.set_osce_bwe(h["bbwe"])
        hms[k] = cuda_ms(lambda: dec.decode_packed(hbuf, hln), 1)
        print(f"BBWE times [{smi}]: FusedHybridDecoder (FB) decode_packed at "
              f"B={B_DNN}, OSCE {k}: {hms[k]:.3f} ms a 20 ms frame -> "
              f"{B_DNN * 20.0 / hms[k]:.0f} realtime streams")
    return {"bbwe_frame": ms_b, "silk48_plain": ms["plain"],
            "silk48_bbwe": ms["BBWE"], "hyb_nolace": hms["NoLACE"],
            "hyb_nolace_bbwe": hms["NoLACE + BBWE"]}


def phase_k5(dev, smi):
    """Kernel K5's table through its entry point, the counter reset around
    it: every case at both geometries == its plain version; the SASS holds
    each case's chain.  Returns the kernels-line numbers."""
    import torch
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.tools import kbench_ops as KB

    torch.cuda.synchronize()
    KB.launches = 0
    rows = KB.table(device=dev)
    torch.cuda.synchronize()
    launches = KB.launches
    print(f"K5 table [{smi}]: {KB.TRIPS} trips; ns per dependent op per "
          f"thread, lane-ops/s as the TPU tool counts ops")
    for r in rows:
        if not r["equal"]:
            fail(f"K5 {r['case']} at {r['lanes']} lanes differs from plain")
        print(f"  K5 {r['case']:14s} {r['lanes']:5d} lanes/{r['threads']:4d} "
              f"threads: {r['ms']:.5f} ms, {r['ns_per_op']:.4f} ns/op, "
              f"{r['lane_ops_per_s']:.4g} lane-ops/s, plain "
              f"{r['plain_ms']:.2f} ms")
    sass = KB.sass_counts(cuda_build.library_path())
    for case in KB.CASES:
        n, want, top = sass.get(case, (0, 0, []))
        print(f"  K5 SASS {case:14s} {n} signature instructions (chain "
              f"needs >= {want}); most frequent: {top}")
        if case not in sass or n < want:
            fail(f"K5 {case}: {n} signature instructions in the SASS, "
                 f"expected >= {want} (folded chain)")
    main = [r for r in rows if r["lanes"] == B_MAIN]
    ms = sum(r["ms"] for r in main)
    plain_ms = sum(r["plain_ms"] for r in main)
    # operations: every case's int32 ops at B_MAIN lanes, as the TPU tool
    # counts them; bytes: x0, out and aux once each
    ops = float(sum(B_MAIN * KB.ops_per_lane(r["case"]) for r in main))
    nbytes = sum(B_MAIN * 8 + (64 if r["case"] == "dyn_read8" else 40 if
                               r["case"] == "page_sweep40" else 0)
                 * B_MAIN * 4 for r in main)
    print(f"K5: {len(rows)} case runs exact; launches {launches}; the 13 "
          f"cases at {B_MAIN} lanes take {ms:.4f} ms in all")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms,
                bound=bound(nbytes, ops, PEAK_I32_S))


def k4_geometry() -> None:
    """K4's registers, local memory, shared memory and occupancy for each
    subframe length, and ptxas's stack and spill line of each
    instantiation: the design keeps everything in registers, so any stack
    or spill fails."""
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.ops import lpc

    for sf in (40, 60, 80):
        g = lpc.geometry(sf)
        print(f"ptxas: K4 silk_lpc_kernel<{sf}>: {g['registers']} registers, "
              f"{g['local_bytes']} bytes local memory per thread; "
              f"{g['smem_per_block']} bytes dynamic shared memory per block "
              f"of {g['warps_per_block']} warps; {g['blocks_per_sm']} blocks "
              f"= {g['warps_per_sm']} resident warps per SM")
        if g["local_bytes"]:
            fail(f"K4 at sf {sf} uses local memory")
    entry, seen = "", 0
    for line in cuda_build.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "stack frame" in line and "silk_lpc_kernel" in entry:
            seen += 1
            print(f"ptxas: K4 {entry.split(chr(39))[1]}: {line.strip()}")
            if line.strip() != ("0 bytes stack frame, 0 bytes spill stores, "
                                "0 bytes spill loads"):
                fail("K4 has a stack frame or spills")
    if cuda_build.ptxas_log and seen != 3:
        fail(f"ptxas reported {seen} K4 instantiations, expected 3")


# 10 ms CELT (LM 2): the 20 ms phases' checks at 480 samples a frame and
# 80 bytes (64 kb/s), on the 10 ms fixtures (tools/
# make_torch_celt10ms_fixture.py), the same tolerances.
FIXTURE10 = os.path.join(REPO, "tests", "data", "torch_celt10ms_64k.npz")
ENC_FIXTURE10 = os.path.join(REPO, "tests", "data",
                             "torch_celt10ms_64k_enc.npz")


def phase_celt10ms(dev):
    """10 ms CELT over B_MAIN fixture lanes plus N_BAD garbage ones: K1
    and K2 against their plain versions frame by frame with state
    carried, the decoder end to end against the scalar decoder (counters
    reset around it), then the encoder at 80 bytes with K3 against its
    plain version on every frame and its packets decoded on the card to
    its final range (counters reset around it).  Returns the errors, the
    counts and the lanes for the timing phase."""
    import numpy as np
    from opus_tpu_torch.models import celt_dec_kernel as CK

    tabs = CK.dec_tabs(48000, 480)
    fx = dict(np.load(FIXTURE10))
    lanes, stream = make_lanes(fx, np.random.default_rng(25))
    plain, x_err, _e_err, k2_err, _k2_in = phase_kernel_vs_plain(lanes, dev,
                                                                 tabs)
    pcm_err, dcounts = phase_end_to_end(lanes, stream, fx, dev, plain,
                                        frame_size=480)
    efx = dict(np.load(ENC_FIXTURE10))
    enc_lanes = make_enc_lanes(efx, np.random.default_rng(26))
    k3_err, ecounts = phase_encode_rate(enc_lanes, dev, 80)
    print(f"10 ms CELT: K1 == plain (X err {x_err:.3g}), decoder PCM max "
          f"err {pcm_err:.3g} vs the scalar decoder; K3 == plain (float err "
          f"{k3_err:.3g}); launches decode {dcounts}, encode + decode "
          f"{ecounts}")
    return dict(x_err=x_err, k2_err=k2_err, k3_err=k3_err, dcounts=dcounts,
                ecounts=ecounts, lanes=lanes, enc_lanes=enc_lanes, tabs=tabs)


def phase_celt10ms_times(dev, smi, d):
    """K1 and K3 at 480 samples, B_MAIN lanes, timed as their 960 rows are
    (CUDA events around 20 back-to-back launches), beside their plain
    versions and bounds; the 10 ms decode and encode steps."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state
    from opus_tpu_torch.models.celt_enc_fused import fused_celt_enc_init

    tabs = d["tabs"]
    buf = torch.from_numpy(d["lanes"][0][0][:B_MAIN]).to(dev)
    ln = torch.from_numpy(d["lanes"][0][1][:B_MAIN]).to(dev)
    st = fused_celt_init_state(B_MAIN, tabs, dev)
    args = (buf, ln, st["old_e"], torch.minimum(st["prev1"], st["prev2"]),
            st["seed"], tabs)
    k1 = cuda_ms(lambda: CK.decode_frame(*args), 20)
    k1p = cuda_ms(lambda: CK.decode_frame_plain(*args), 1)
    k1_bnd = k1_bound(tabs, args, CK.decode_frame(*args))
    etabs = EK.enc_tabs(48000, 480)
    pcm = torch.from_numpy(d["enc_lanes"][0][:B_MAIN]).to(dev)
    est = fused_celt_enc_init(B_MAIN, etabs, dev)
    ins, X, _front = EK._front_end(pcm, est, etabs, 80)
    k3 = cuda_ms(lambda: EK.encode_frame(X, ins, etabs, 80), 20)
    k3p = cuda_ms(lambda: EK.encode_frame_plain(X, ins, etabs, 80), 1)
    k3_bnd, evals = k3_bound(etabs, X, EK.encode_frame(X, ins, etabs, 80))
    dec = CK.KernelCeltDecoder(B_MAIN, frame_size=480, device=dev,
                               max_payload=buf.shape[1])
    dec_step = cuda_ms(lambda: dec.decode_packed(buf, ln), 10)
    enc = EK.KernelCeltEncoder(B_MAIN, frame_size=480, nbytes=80, device=dev)
    enc_step = cuda_ms(lambda: enc.encode_device(pcm), 10)
    print(f"10 ms times at B={B_MAIN} [{smi}]: K1 {k1:.4f} ms/frame, plain "
          f"{k1p:.2f} ms, bound {k1_bnd[0]:.6f} ms ({k1_bnd[1]}); K3 "
          f"{k3:.4f} ms/frame, plain {k3p:.2f} ms, bound {k3_bnd[0]:.6f} ms "
          f"({k3_bnd[1]}; {evals / B_MAIN:.0f} score evaluations per "
          f"stream); decode step {dec_step:.3f} ms -> "
          f"{B_MAIN * 10.0 / dec_step:.0f} realtime 10 ms streams; encode "
          f"step {enc_step:.3f} ms -> {B_MAIN * 10.0 / enc_step:.0f}")
    return dict(k1_10=k1, k1p_10=k1p, k1_10_bound=k1_bnd, k3_10=k3,
                k3p_10=k3p, k3_10_bound=k3_bnd, dec_step_10=dec_step,
                enc_step_10=enc_step)


# Tracked config 5's whole loop on the card (BASELINE.md:30): PCM -> CELT
# packet (KernelCeltEncoder, K3) and DRED latents (BatchedDREDEncoder) ->
# the packet with the DRED payload in extension 126 (attach) -> the CELT
# frame decoded (KernelCeltDecoder, K1 and K2) and the DRED parsed
# (parse_batch) -> the loss recovery (BatchedDREDRecovery, K2).  B_DNN
# streams at 48 kHz mono, CHAIN_FRAMES frames of 20 ms at 64 kb/s
# (160-byte CELT frames, TOC 0xF8 as the JAX encoder writes it), DRED
# duration 40 (11 chunks); the packets of the last CHAIN_ATTACH frames
# carry DRED (attach codes every lane on the host, ~6 ms a lane).  Models
# from the seeds of tests/data/torch_dred_enc.npz (RDOVAE encoder 31,
# decoder 32, statistics 33, pitch DNN 35, FARGAN 36).  Bounds:
# - the 16 kHz conversion bit for bit card against CPU (float64 in the
#   numpy loop's order on both);
# - latents and states within DRED_RTOL / DRED_ATOL, card against the CPU
#   run (every lane) and against the JAX package (fixture lanes);
# - quantized integers and payload bytes equal, card against CPU and the
#   port against the JAX package; an integer may differ by one only where
#   its value before rounding lies within that bound of a k + 0.5
#   boundary (near_half, int_flips): such lane-frames are counted and
#   printed (expected 0), and a fixture lane's is held instead by coding
#   the JAX floats through the port's quantizer and coder;
# - parse_batch returns exactly what each lane coded;
# - the recovery's PCM within DNN_RTOL / DNN_ATOL of the CPU run.
DRED_ENC_FIXTURE = os.path.join(REPO, "tests", "data", "torch_dred_enc.npz")
CHAIN_FRAMES = 24
CHAIN_ATTACH = 2
CHAIN_MDB, CHAIN_RATE = 1276, 64000
N_SILENT = 48


def fixture_ring(efx, key: str, frame: int):
    """The JAX encoder's latent and state rings (newest first) after
    ``frame`` of tests/data/torch_dred_enc.npz's ``key`` rate, rebuilt
    from the stored newest rows: ([S, 104, 80], [S, 104, 24], fill)."""
    import numpy as np
    lat, st = efx["latent_" + key], efx["state_" + key]
    s = lat.shape[1]
    fill = int(efx["fill_" + key][frame])
    rl = np.zeros((s, 104, lat.shape[2]), np.float32)
    rs = np.zeros((s, 104, st.shape[2]), np.float32)
    for k in range(min(frame + 1, 104)):
        rl[:, k], rs[:, k] = lat[frame - k], st[frame - k]
    return rl, rs, fill


def code_floats(stats, lat, st, nb, dred_offset, activity, q0, dq, qmax,
                max_chunks, max_bytes):
    """One stream's payload from its float rings through the port's
    quantizer (on the CPU) and coder: (payload or None, chunks)."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import dred as PD
    lo = int(PD.latent_skip(np.asarray(activity)[None], nb)[0])
    levels = [PD.compute_quantizer(q0, dq, qmax, c) for c in
              range(max_chunks)]
    idx = np.minimum(2 * np.arange(max_chunks) + lo, lat.shape[0] - 1)
    ql, _ = PD.quantize_latents(torch.from_numpy(lat[idx]),
                                torch.from_numpy(stats.latent_scale[levels]),
                                torch.from_numpy(
                                    stats.latent_dead_zone[levels]))
    qs, _ = PD.quantize_latents(torch.from_numpy(st[lo]),
                                torch.from_numpy(stats.state_scale[q0]),
                                torch.from_numpy(stats.state_dead_zone[q0]))
    return PD.dred_encode(stats, qs.numpy(), ql.numpy(), nb, dred_offset,
                          activity, lo, q0=q0, dq=dq, qmax=qmax,
                          max_chunks=max_chunks, max_bytes=max_bytes)


def int_flips(q, qc, stats, q0: int, dq: int, nb: int):
    """Lanes whose coded integers differ between two
    ``BatchedDREDEnc.quantized`` records (numpy; q the card's, qc the
    reference run's).  Fails unless every difference is one step at a
    value that near_half allows to flip (on the reference's floats)."""
    import numpy as np
    from opus_tpu_torch.dnn import dred as PD
    if not np.array_equal(q["latent_offset"], qc["latent_offset"]):
        fail("DRED: latent offsets differ between the runs")
    v, x = qc["v_latents"], qc["x_latents"]
    levels = [PD.compute_quantizer(q0, dq, 15, c) for c in range(v.shape[1])]
    n = (np.minimum(2 * v.shape[1], nb - q["latent_offset"]) + 1) // 2
    coded = (np.arange(v.shape[1])[None] < n[:, None])[..., None]
    dl = (q["q_latents"] != qc["q_latents"]) & coded
    ds = q["q_state"] != qc["q_state"]
    ok_l = near_half(v, x, stats.latent_scale[levels][None]) & (
        np.abs(q["q_latents"] - qc["q_latents"]) <= 1)
    ok_s = near_half(qc["v_state"], qc["x_state"],
                     stats.state_scale[q0][None]) & (
        np.abs(q["q_state"] - qc["q_state"]) <= 1)
    if (dl & ~ok_l).any() or (ds & ~ok_s).any():
        lanes = np.nonzero((dl & ~ok_l).any(axis=(1, 2))
                           | (ds & ~ok_s).any(axis=1))[0]
        fail(f"DRED: quantized integers differ away from a rounding "
             f"boundary on lanes {lanes[:8].tolist()}")
    return np.nonzero(dl.any(axis=(1, 2)) | ds.any(axis=1))[0]


def fixture_boundary_lanes(efx, key: str, a: int, stats):
    """Streams of the fixture's attach frame a whose JAX values before
    rounding lie near a rounding boundary (near_half on the JAX floats)."""
    import numpy as np
    from opus_tpu_torch.dnn import dred as PD
    frame = efx["fill_" + key].shape[0] - efx["payload_" + key].shape[0] + a
    rl, rs, fill = fixture_ring(efx, key, frame)
    lanes = []
    for s in range(rl.shape[0]):
        lo = int(efx["latent_offset_" + key][a, s])
        q0, dq = int(efx["q0_" + key][a, s]), int(efx["dq_" + key][a, s])
        mc = int(efx["chunks_" + key][a, s])
        n = (min(2 * mc, fill - lo) + 1) // 2
        levels = [PD.compute_quantizer(q0, dq, 15, c) for c in range(n)]
        idx = 2 * np.arange(n) + lo
        if near_half(efx["v_latents_" + key][a, s, :n], rl[s, idx],
                     stats.latent_scale[levels]).any() or near_half(
                efx["v_state_" + key][a, s], rs[s, lo],
                stats.state_scale[q0]).any():
            lanes.append(s)
    return lanes


def speech_lanes(k: int, rng, nf: int, n: int):
    """k seeded speech-like lanes, [k, nf, n] float32 at 48 kHz: two
    harmonics of a vibrato f0 in 90-250 Hz, 1% noise, at 5-30% of full
    scale, drawn from ``rng`` in blocks of 128 lanes."""
    import numpy as np
    t = np.arange(nf * n) / 48000.0
    vib = 1 + 0.1 * np.sin(2 * np.pi * 3 * t)
    out = []
    for i in range(0, k, 128):
        m = min(128, k - i)
        f0 = rng.uniform(90, 250, (m, 1))
        amp = rng.uniform(0.05, 0.3, (m, 1))
        ph = np.cumsum(f0 * vib, axis=1) / 48000.0
        x = amp * (np.sin(2 * np.pi * ph) + 0.5 * np.sin(4 * np.pi * ph)) \
            + 0.01 * rng.standard_normal((m, nf * n))
        out.append(np.clip(x, -1, 1).astype(np.float32))
    return np.concatenate(out).reshape(k, nf, n)


def chain_lanes(efx):
    """PCM [B_DNN, CHAIN_FRAMES, 960] float32 and voice activity [B_DNN,
    CHAIN_FRAMES] (0 on an all-zero frame, as the fixture's): the DRED
    encoder fixture's 8 streams at 48 kHz tiled over the first 64 lanes,
    seeded speech-like lanes (two harmonics of a vibrato f0 in 90-250 Hz,
    1% noise, at 5-30% of full scale), then N_SILENT lanes with digital
    silence: throughout (no DRED: the payload is None), in the last 20
    frames (the latent skip goes back 19 latents) and in frames 8-15 (a
    gap inside the window).  Returns (pcm, activity, fixture lanes)."""
    import numpy as np
    fx_pcm = efx["pcm_48k"]
    ns, nf, n = fx_pcm.shape
    if (nf, n) != (CHAIN_FRAMES, 960):
        fail(f"DRED encoder fixture: {nf} frames of {n}")
    n_fx = ns * 8
    rng = np.random.default_rng(30)

    def speech(k):
        return speech_lanes(k, rng, nf, n)

    silent = speech(N_SILENT)
    third = N_SILENT // 3
    silent[:third] = 0.0
    silent[third:2 * third, 4:] = 0.0
    silent[2 * third:, 8:16] = 0.0
    pcm = np.concatenate([np.tile(fx_pcm, (8, 1, 1)),
                          speech(B_DNN - n_fx - N_SILENT), silent])
    activity = (np.abs(pcm).max(axis=2) > 0).astype(np.uint8)
    if not np.array_equal(activity[:n_fx],
                          np.tile(efx["activity_48k"], (8, 1))):
        fail("DRED chain: fixture lanes' activity differs from the fixture")
    return pcm, activity, n_fx


def phase_dred_chain(dev, efx):
    """Config 5's loop as a user drives it, the launch counters reset
    around the CHAIN_FRAMES frames (K1, K2, K3) and around the recovery
    (K2); then the same DRED encoder on the CPU over every lane, and the
    checks listed above.  Returns what the timing phase and the kernels
    line need."""
    import numpy as np
    import torch
    from opus_tpu_torch.bitstream import packet as pkt
    from opus_tpu_torch.dnn import dred as PD
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import pitchdnn as PP
    from opus_tpu_torch.dnn import rdovae as PV
    from opus_tpu_torch.dnn.dred_dec import dred_find_payload
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.models import dnn_recovery as PRec
    from opus_tpu_torch.models.dred_encoder import BatchedDREDEncoder
    from opus_tpu_torch.ops import iir

    s_enc, s_dec, s_stats, s_pitch, s_fg = (int(v) for v in efx["seeds"])
    stats = PD.random_stats(s_stats)
    enc_m = PV.random_enc_model(s_enc, device="cpu")
    pitch_m = PP.random_model(s_pitch, device="cpu")
    pcm, activity, n_fx = chain_lanes(efx)
    b = B_DNN
    stream = np.arange(n_fx) % efx["pcm_48k"].shape[0]
    celt = EK.KernelCeltEncoder(b, nbytes=160, device=dev)
    dred = BatchedDREDEncoder(enc_m, pitch_m, stats, b,
                              duration_frames_10ms=40, device=dev)
    dec = CK.KernelCeltDecoder(b, device=dev, max_payload=160)
    lens160 = torch.full((b,), 160, dtype=torch.int64, device=dev)
    newest, x16s, attached, frame_s = [], [], [], []
    torch.cuda.synchronize()
    CK.launches = iir.launches = EK.launches = 0
    for f in range(CHAIN_FRAMES):
        t0 = time.perf_counter()
        x = torch.from_numpy(pcm[:, f]).to(dev)
        payload, rng, err = celt.encode_device(x)
        x16 = dred.step(x, activity[:, f])
        if f >= CHAIN_FRAMES - CHAIN_ATTACH:
            pay = payload.cpu().numpy()
            packets = [bytes([0xF8]) + pay[i].tobytes() for i in range(b)]
            dpackets = dred.attach(packets, CHAIN_MDB, CHAIN_RATE)
            frames = []
            for i, p in enumerate(dpackets):
                parsed = pkt.packet_parse(p)
                if isinstance(parsed, int) or parsed.count != 1 \
                        or parsed.frames[0] != pay[i].tobytes():
                    fail(f"DRED chain frame {f} lane {i}: the packet's CELT "
                         "frame is not the encoder's payload")
                frames.append(parsed.frames[0])
            buf, lens = dec.pack(frames)
            q = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                 for k, v in dred.dred.quantized.items()}
            attached.append(dict(packets=packets, dpackets=dpackets, q=q,
                                 dred_offset=dred.dred.dred_offset,
                                 fill=dred.dred.latents_buffer_fill))
        else:
            buf, lens = payload, lens160
        _out, derr = dec.decode_packed(buf, lens)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        ok = err == 0
        if err[:n_fx].any() or derr[ok].any() or not torch.equal(
                dec.state["seed"][ok], rng[ok]):
            fail(f"DRED chain frame {f}: CELT lanes flagged or the decoder "
                 "missed the encoder's final range")
        newest.append((dred.dred.latents[:, 0].cpu().numpy(),
                       dred.dred.states[:, 0].cpu().numpy(),
                       dred.dred.dred_offset, dred.dred.latents_buffer_fill))
        x16s.append(x16.cpu().numpy())
    counts = {"K1": CK.launches, "K2": iir.launches, "K3": EK.launches}
    print(f"DRED chain launch counters over {CHAIN_FRAMES} frames: {counts}")
    if counts != {k: CHAIN_FRAMES for k in ("K1", "K2", "K3")}:
        fail(f"DRED chain: expected one launch of K1, K2 and K3 a frame, "
             f"got {counts}")

    # the same DRED encoder on the CPU, every lane
    t0 = time.time()
    cpu = BatchedDREDEncoder(enc_m, pitch_m, stats, b,
                             duration_frames_10ms=40, device="cpu")
    e_lat = e_jax = 0.0
    for f in range(CHAIN_FRAMES):
        x16 = cpu.step(torch.from_numpy(pcm[:, f]), activity[:, f]).numpy()
        if not np.array_equal(x16.view(np.uint32), x16s[f].view(np.uint32)):
            fail(f"DRED chain frame {f}: convert_to_16k card != CPU")
        lat, st, off, fill = newest[f]
        if (off, fill) != (cpu.dred.dred_offset,
                           cpu.dred.latents_buffer_fill) or (off, fill) != (
                int(efx["dred_offset_48k"][f]), int(efx["fill_48k"][f])):
            fail(f"DRED chain frame {f}: dred_offset / fill {off} / {fill}")
        for got, ref, what in (
                (lat, cpu.dred.latents[:, 0].numpy(), "latents"),
                (st, cpu.dred.states[:, 0].numpy(), "states")):
            bad = np.abs(got - ref) > DRED_ATOL + DRED_RTOL * np.abs(ref)
            if bad.any():
                fail(f"DRED chain frame {f}: {what} card vs CPU outside the "
                     f"bound on lanes {np.nonzero(bad.any(1))[0][:8]}")
            e_lat = max(e_lat, float(np.abs(got - ref).max()))
        for got, key in ((lat, "latent_48k"), (st, "state_48k")):
            ref = efx[key][f][stream]
            bad = np.abs(got[:n_fx] - ref) > DRED_ATOL + DRED_RTOL * np.abs(
                ref)
            if bad.any():
                fail(f"DRED chain frame {f}: {key} card vs the JAX package "
                     f"outside the bound")
            e_jax = max(e_jax, float(np.abs(got[:n_fx] - ref).max()))
        if f >= CHAIN_FRAMES - CHAIN_ATTACH:
            at = attached[f - (CHAIN_FRAMES - CHAIN_ATTACH)]
            at["cpu_dpackets"] = cpu.attach(at["packets"], CHAIN_MDB,
                                            CHAIN_RATE)
            at["cpu_q"] = {k: v.numpy() if torch.is_tensor(v) else v
                           for k, v in cpu.dred.quantized.items()}
    cpu_s = time.time() - t0

    # integers and bytes: card vs CPU, and the port vs the JAX package
    q0 = min(15, max(4, 51 - 3 * max(1, CHAIN_RATE - 12000).bit_length()))
    dq = 3 if CHAIN_RATE - 12000 > 36000 else 5
    n_flip = n_flip_fx = n_none = 0
    for a, at in enumerate(attached):
        q, qc = at["q"], at["cpu_q"]
        flips = set(int_flips(q, qc, stats, q0, dq, at["fill"]).tolist())
        n_flip += len(flips)
        for i in range(b):
            if i not in flips and at["dpackets"][i] != at["cpu_dpackets"][i]:
                fail(f"DRED chain attach {a} lane {i}: packet card != CPU")
        n_none += sum(p == pk for p, pk in zip(at["dpackets"],
                                               at["packets"]))
        # fixture lanes against the JAX package's payloads
        frame = CHAIN_FRAMES - CHAIN_ATTACH + a
        rl, rs, fill = fixture_ring(efx, "48k", frame)
        fx_bnd = None
        for i in range(n_fx):
            s = int(stream[i])
            ln = int(efx["payload_len_48k"][a, s])
            ref = None if ln < 0 else efx["payload_48k"][a, s, :ln].tobytes()
            found = dred_find_payload(at["dpackets"][i])
            if (None if found is None else found[0]) == ref:
                continue
            # a flipped rounding: allowed only near a boundary, and the
            # JAX floats through the port's quantizer and coder give the
            # JAX payload
            if fx_bnd is None:
                fx_bnd = fixture_boundary_lanes(efx, "48k", a, stats)
            got, _ = code_floats(
                stats, rl[s], rs[s], fill, at["dred_offset"],
                efx["activity_mem_48k"][a, s], q0, dq, 15,
                int(efx["chunks_48k"][a, s]),
                int(efx["max_bytes_48k"][a, s]))
            if s not in fx_bnd or got != ref:
                fail(f"DRED chain attach {a} lane {i}: payload != the JAX "
                     f"package's (stream {s})")
            n_flip_fx += 1
    print(f"DRED chain: convert_to_16k card == CPU bit for bit on "
          f"{b} x {CHAIN_FRAMES} lane-frames; latents / states within rtol "
          f"{DRED_RTOL} / atol {DRED_ATOL}: max err {e_lat:.3g} vs the CPU "
          f"run, {e_jax:.3g} vs the JAX package ({n_fx} lanes); the last "
          f"{CHAIN_ATTACH} frames' integers and packets == the CPU run's, "
          f"payloads == the JAX package's; lane-frames with an integer "
          f"flipped at a rounding boundary (expected 0): {n_flip} of "
          f"{b * CHAIN_ATTACH} card vs CPU, {n_flip_fx} of "
          f"{n_fx * CHAIN_ATTACH} vs JAX (held on the JAX floats instead); "
          f"packets without DRED (payload None): {n_none}; the CPU run took "
          f"{cpu_s:.1f} s")

    # parse_batch returns what each lane coded
    at = attached[-1]
    q = at["q"]
    parsed = PRec.parse_batch(stats, at["dpackets"], 48000, 48000)
    levels = [PD.compute_quantizer(q0, dq, 15, c)
              for c in range(q["q_latents"].shape[1])]

    def dequant(qv, scale, r, p0):
        mask = (r != 0) & (p0 != 255)
        return np.where(mask, qv * 256.0 / np.maximum(scale, 1).astype(
            np.float64), 0.0).astype(np.float32)
    lat_exp = dequant(q["q_latents"], stats.latent_scale[levels],
                      stats.latent_r[levels], stats.latent_p0[levels])
    st_exp = dequant(q["q_state"], stats.state_scale[q0][None],
                     stats.state_r[q0][None], stats.state_p0[q0][None])
    has = np.asarray([p != pk for p, pk in zip(at["dpackets"],
                                               at["packets"])])
    nb = np.where(has, q["chunks"], 0)
    if not (np.array_equal(parsed.has_dred, has)
            and np.array_equal(parsed.nb_latents, nb)):
        fail("DRED chain: parse_batch's lanes or chunk counts differ from "
             "what the encoder coded")
    lo = q["latent_offset"]
    if not np.array_equal(parsed.dred_offset[has],
                          (at["dred_offset"] - 8 * lo)[has]):
        fail("DRED chain: parse_batch's dred_offset differs")
    if not np.array_equal(parsed.state0[has], st_exp[has]):
        fail("DRED chain: parse_batch's state differs from the coded one")
    for c in range(int(nb.max())):
        m = nb > c
        if not (np.array_equal(parsed.latents[c, m, :80], lat_exp[m, c])
                and (parsed.latents[c, m, 80]
                     == np.float32(levels[c] * 0.125 - 1.0)).all()):
            fail(f"DRED chain: parse_batch's chunk {c} differs from the "
                 "coded one")
    print(f"DRED chain: parse_batch == the coded latents, state, chunk "
          f"counts ({np.bincount(nb).tolist()} lanes with 0, 1, ... chunks) "
          f"and offsets on all {b} lanes")

    # the recovery from these packets
    dec_m = PV.random_dec_model(s_dec, device="cpu")
    fg_m = PF.random_model(s_fg, device="cpu")
    pcm0 = x16s[-1] / 32768.0
    loss = 2 + np.arange(b) % 3
    rec = PRec.BatchedDREDRecovery(dec_m, stats, fg_m, device=dev)
    torch.cuda.synchronize()
    iir.launches = 0
    out = rec.recover(parsed, pcm0, loss, N_CONCEAL)
    torch.cuda.synchronize()
    rcounts = {"K2": iir.launches}
    if rcounts["K2"] != PF.FARGAN_NB_SUBFRAMES * (1 + N_CONCEAL):
        fail(f"DRED chain recovery: K2 launched {rcounts['K2']} times")
    ref = PRec.BatchedDREDRecovery(dec_m, stats, fg_m, device="cpu").recover(
        parsed, pcm0, loss, N_CONCEAL).numpy()
    e_rec = dnn_close(out.cpu().numpy(), ref,
                      "DRED chain recovery PCM, card vs the CPU run")
    print(f"DRED chain recovery at B={b}: PCM finite, max err {e_rec:.3g} vs "
          f"the CPU run (rtol {DNN_RTOL} / atol {DNN_ATOL}); K2 {rcounts}")
    return dict(counts=counts, rcounts=rcounts, dred=dred, celt=celt,
                dec=dec, pcm=pcm, activity=activity, attached=attached,
                frame_s=frame_s, parsed=parsed, pcm0=pcm0, loss=loss,
                rec=rec, stats=stats, q0=q0, dq=dq)


def phase_dred_chain_times(dev, smi, d):
    """The DRED encoder's parts at B_DNN: compute_latents and its
    conversion, feature analysis and RDOVAE step (CUDA events around
    back-to-back calls, device operations and device time from the
    profiler), the device quantizer, the host coder over every lane,
    attach, and the chain frame with and without DRED."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import dred as PD
    from opus_tpu_torch.dnn import dred_enc as PE
    from opus_tpu_torch.dnn import features as PFe
    from opus_tpu_torch.dnn import rdovae as PV
    from opus_tpu_torch.tools.device_time import device_profile

    enc = d["dred"].dred
    b = B_DNN
    x = torch.from_numpy(d["pcm"][:, 0]).to(dev)
    x64 = x.to(torch.float64)
    mem = torch.zeros((b, PE.RESAMPLING_ORDER + 1), dtype=torch.float64,
                      device=dev)
    frame16 = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([d["pcm"][:, 0, ::3], d["pcm"][:, 1, ::3]], 1)
        * 32768.0)).to(dev)
    fstate = enc.feat_state
    feats = torch.zeros((b, 40), device=dev)
    rstate = enc.rdovae_state

    def features():
        st, f0 = PFe.compute_frame_features(fstate, frame16[:, :160],
                                            enc.pitch_model)
        return PFe.compute_frame_features(st, frame16[:, 160:320],
                                          enc.pitch_model)
    parts = {
        "conversion": lambda: PE.convert_to_16k(x64, 48000, 1, mem, 320),
        "features": features,
        "RDOVAE": lambda: PV.encode_dframe(enc.model, rstate, feats),
        "compute_latents": lambda: enc.compute_latents(x, 960),
    }
    res = {}
    for name, fn in parts.items():
        ms = cuda_ms(fn, 3)
        ops, dev_ms = device_profile(fn, 2)
        res[name] = (ms, ops, dev_ms)
        print(f"DRED encoder at B={b} [{smi}]: {name} {ms:.3f} ms a 20 ms "
              f"frame, {ops:.0f} device operations, {dev_ms:.3f} ms device "
              f"(busy {100 * dev_ms / ms:.1f}%)")
    lo = d["attached"][-1]["q"]["latent_offset"]
    quant = cuda_ms(lambda: enc.quantize(lo, 11, d["q0"], d["dq"], 15), 10)
    qops, qdev = device_profile(
        lambda: enc.quantize(lo, 11, d["q0"], d["dq"], 15), 3)
    q = d["attached"][-1]["q"]
    act = d["dred"].activity_mem
    t0 = time.perf_counter()
    for i in range(b):
        PD.dred_encode(d["stats"], q["q_state"][i], q["q_latents"][i],
                       enc.latents_buffer_fill, enc.dred_offset, act[i],
                       int(lo[i]), q0=d["q0"], dq=d["dq"], max_chunks=11,
                       max_bytes=997)
    coder = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    d["dred"].attach(d["attached"][-1]["packets"], CHAIN_MDB, CHAIN_RATE)
    attach_ms = (time.perf_counter() - t0) * 1e3
    plain = 1e3 * float(np.median(d["frame_s"][2:CHAIN_FRAMES
                                               - CHAIN_ATTACH]))
    with_dred = 1e3 * d["frame_s"][-1]
    print(f"DRED encoder at B={b} [{smi}]: quantizer {quant:.3f} ms "
          f"({qops:.0f} device operations, {qdev:.4f} ms device); host "
          f"coder over {b} lanes {coder:.1f} ms ({coder / b:.3f} ms a lane); "
          f"attach {attach_ms:.1f} ms; chain frame (K3 encode, DRED step, "
          f"K1/K2 decode) {plain:.1f} ms without DRED in the packet (median "
          f"of frames 2-{CHAIN_FRAMES - CHAIN_ATTACH - 1}), {with_dred:.1f} "
          f"ms with attach and the packets' parse")
    return dict(chain_parts=res, chain_quant=quant, chain_coder=coder,
                chain_attach=attach_ms, chain_frame=plain,
                chain_frame_dred=with_dred)


# Per-lane loss on the decode side: opus_demo's `decode -sim_loss 10 -dred`
# / `-loss 10 -dred` loop (tracked config 4's 10% loss with config 5's DRED)
# as ``tools/sim_loss.BatchedLossDecoder`` over B_DNN streams, each with its
# own loss pattern (``tools/loss.py``: lanes below SIM_LOSSGEN_LANES from
# one ``BatchedLossGen`` of ``random_model(LOSSGEN_SEED)``, the rest
# i.i.d.), models from opus_demo's seeds (SIM_SEEDS).  The fixture
# tests/data/torch_sim_loss.npz (tools/make_torch_sim_loss_fixture.py) holds
# the JAX loop on 8 streams of the JAX encoder's packets; on the card those
# streams ride lanes SIM_FX (4 from each source).  Bounds, card against the
# port's CPU run (every lane) and the JAX loop (fixture lanes, its first
# SIM_LOOP frames): loss flags, final ranges, FEC choices and FARGAN
# periods equal; CELT PCM within PCM_ABS_TOL (1e-4, the decode phase's
# bound); concealed int16 at 48 kHz within PLC_LSB_48K (4 LSB).
SIM_FIXTURE = os.path.join(REPO, "tests", "data", "torch_sim_loss.npz")
SIM_SEEDS = dict(enc=31, dec=32, stats=33, plc=34, pitch=35, fargan=36)
LOSSGEN_SEED = 33
SIM_LOSS_PERC = 10.0
PLC_LOSS_PERC = 30.0
SIM_LOSSGEN_LANES = B_DNN // 2
SIM_FX = (0, 1, 2, 3, SIM_LOSSGEN_LANES, SIM_LOSSGEN_LANES + 1,
          SIM_LOSSGEN_LANES + 2, SIM_LOSSGEN_LANES + 3)
SIM_LOOP = 12


def sim_models(device):
    """opus_demo's stand-in models: (PLC, pitch DNN, FARGAN, RDOVAE
    decoder, DRED statistics)."""
    from opus_tpu_torch.dnn import dred as PD
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import pitchdnn as PP
    from opus_tpu_torch.dnn import plc as PL
    from opus_tpu_torch.dnn import rdovae as PV
    s = SIM_SEEDS
    return (PL.random_model(s["plc"], device=device),
            PP.random_model(s["pitch"], device=device),
            PF.random_model(s["fargan"], device=device),
            PV.random_dec_model(s["dec"], device=device),
            PD.random_stats(s["stats"]))


def sim_loss_flags(seeds, lossgen_lanes, n: int, dred_from: int, device):
    """[B, n] bool numpy: ``-sim_loss 10`` (one BatchedLossGen of
    random_model(LOSSGEN_SEED)) on the lanes where ``lossgen_lanes`` holds,
    ``-loss 10`` elsewhere, each lane from its own seed; no loss before
    frame ``dred_from`` (the first frame from which every packet carries
    DRED)."""
    import numpy as np
    from opus_tpu_torch.dnn import lossgen
    from opus_tpu_torch.tools.loss import loss_flags
    seeds = np.asarray(seeds)
    lg = np.asarray(lossgen_lanes, bool)
    out = np.zeros((len(seeds), n), bool)
    if lg.any():
        model = lossgen.random_model(LOSSGEN_SEED, device=device)
        out[lg] = loss_flags(n, seeds[lg], sim_loss_perc=SIM_LOSS_PERC,
                             model=model, device=device).cpu().numpy()
    if (~lg).any():
        out[~lg] = loss_flags(n, seeds[~lg], loss_perc=SIM_LOSS_PERC,
                              device=device).cpu().numpy()
    out[:, :dred_from] = False
    return out


def sim_fixture_packets(sfx):
    """The fixture's packets: [8][FRAMES] bytes."""
    lens = sfx["packet_lens"]
    return [[bytes(sfx["packets"][i, f, :lens[i, f]])
             for f in range(lens.shape[1])] for i in range(lens.shape[0])]


def sim_loss_run(dec, packets, lost):
    """Drives a BatchedLossDecoder through packets[i][f] with the flags
    lost [B, F]; returns numpy: the final range after each received packet
    (``rng``, 0 when lost), its float PCM (``celt``), the concealed int16 of
    each lost frame a later packet's DRED concealed (``conc``, with
    ``concealed``), the span ``pending`` at the end, the resume events, and
    each concealed 10 ms frame's lanes, FEC choices and FARGAN periods
    (``trace_mask``, ``trace_fec``, ``trace_period`` [N, B]); ``k2`` is the
    number of K2 launches the run makes (one a tick for the CELT
    de-emphasis, one per FARGAN subframe of each concealed frame and of
    each tick's priming)."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    b, nf = lost.shape
    rng = np.zeros((b, nf), np.uint32)
    celt = np.zeros((b, nf, 960), np.float32)
    conc = np.zeros((b, nf, 960), np.int16)
    concealed = np.zeros((b, nf), bool)
    pend = [[] for _ in range(b)]
    tm, tf, tp, tick_s = [], [], [], []
    k2 = 0
    for f in range(nf):
        resume = ~lost[:, f] & (dec.pending() > 0)
        prime = bool((resume & (dec.plc.lpcnet.blend.cpu().numpy()
                                == 0)).any())
        t0 = time.perf_counter()
        out, n = dec.tick([packets[i][f] for i in range(b)], lost[:, f])
        if dec.device.type == "cuda":
            torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        out = out.cpu().numpy()
        k2 += 1 + PF.FARGAN_NB_SUBFRAMES * (prime + (
            len(dec.plc.trace) if resume.any() else 0))
        if resume.any():
            for m, fec, per in dec.plc.trace:
                tm.append(m.cpu().numpy())
                tf.append(fec.cpu().numpy())
                tp.append(per.cpu().numpy())
        r = dec.final_range().cpu().numpy()
        pcm = dec.pcm.cpu().numpy()
        for i in np.nonzero(~lost[:, f])[0]:
            p = len(pend[i])
            if n[i] != 960 * (p + 1):
                fail(f"sim_loss frame {f} lane {i}: {n[i]} samples out")
            if p:
                conc[i, pend[i]] = out[i, :960 * p].reshape(p, 960)
                concealed[i, pend[i]] = True
                pend[i] = []
            rng[i, f] = r[i]
            celt[i, f] = pcm[i]
        for i in np.nonzero(lost[:, f])[0]:
            pend[i].append(f)
    z = np.zeros((0, b))
    return dict(lost=lost, rng=rng, celt=celt, conc=conc,
                concealed=concealed, pending=dec.pending(),
                resumes=dec.resumes, k2=k2, tick_s=tick_s,
                trace_mask=np.array(tm).reshape(-1, b) if tm else z.astype(
                    bool),
                trace_fec=np.array(tf).reshape(-1, b) if tf else z.astype(
                    bool),
                trace_period=np.array(tp).reshape(-1, b) if tp else z)


def sim_compare(got, ref, what, lanes=None, frames=None):
    """The sim_loss bounds on ``lanes`` (default all) over the first
    ``frames`` (default all) frames; ``ref`` a sim_loss_run result or the
    fixture's JAX loop (``loop_*`` keys).  Returns (max CELT PCM error,
    max concealed LSB, lane-frames concealed in both)."""
    import numpy as np
    if "loop_lost" in ref:
        ref = {"lost": ref["loop_lost"], "rng": ref["loop_range"],
               "celt": ref["loop_celt"], "conc": ref["loop_conc"],
               "concealed": ref["loop_concealed"]}
    nf = ref["lost"].shape[1] if frames is None else frames
    sel = np.arange(len(got["lost"])) if lanes is None else \
        np.asarray(lanes)
    gl = {k: got[k][sel][:, :nf] for k in ("lost", "rng", "celt", "conc",
                                         "concealed")}
    rl = {k: ref[k][:, :nf] for k in gl}
    if not np.array_equal(gl["lost"], rl["lost"]):
        fail(f"sim_loss {what}: loss flags differ")
    recv = ~rl["lost"]
    if not np.array_equal(gl["rng"][recv], rl["rng"][recv]):
        fail(f"sim_loss {what}: final ranges differ on lane-frames "
             f"{np.argwhere(recv & (gl['rng'] != rl['rng']))[:4].tolist()}")
    e_pcm = float(np.abs(gl["celt"][recv] - rl["celt"][recv]).max()) \
        if recv.any() else 0.0
    if not e_pcm <= PCM_ABS_TOL:
        fail(f"sim_loss {what}: CELT PCM err {e_pcm} > {PCM_ABS_TOL}")
    both = rl["concealed"]
    if (both & ~gl["concealed"]).any():
        fail(f"sim_loss {what}: lost frames the reference concealed are not "
             f"concealed")
    d = np.abs(gl["conc"][both].astype(np.int64)
               - rl["conc"][both].astype(np.int64))
    e_conc = int(d.max()) if d.size else 0
    if e_conc > PLC_LSB_48K:
        fail(f"sim_loss {what}: concealed PCM {e_conc} LSB > {PLC_LSB_48K}")
    return e_pcm, e_conc, int(both.sum())


def sim_traffic(dev, sfx):
    """The sim_loss phase's packets, [B_DNN][CHAIN_FRAMES] bytes: seeded
    speech-like lanes (``speech_lanes``) through the config-5 encoder on
    the card (K3 at 160 bytes, ``BatchedDREDEncoder`` of duration 40,
    ``attach`` on every frame with the DRED chain's 1276-byte budget and
    rate), the fixture's 8 JAX-encoded streams on lanes SIM_FX.  Returns
    (packets, K3 launches, seconds)."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import dred as PD
    from opus_tpu_torch.dnn import pitchdnn as PP
    from opus_tpu_torch.dnn import rdovae as PV
    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.models.dred_encoder import BatchedDREDEncoder

    t0 = time.time()
    b = B_DNN
    pcm = speech_lanes(b, np.random.default_rng(31), CHAIN_FRAMES, 960)
    s = SIM_SEEDS
    celt = EK.KernelCeltEncoder(b, nbytes=160, device=dev)
    dred = BatchedDREDEncoder(PV.random_enc_model(s["enc"], device="cpu"),
                              PP.random_model(s["pitch"], device="cpu"),
                              PD.random_stats(s["stats"]), b,
                              duration_frames_10ms=40, device=dev)
    ones = np.ones(b, np.uint8)
    packets = [[] for _ in range(b)]
    torch.cuda.synchronize()
    EK.launches = 0
    for f in range(CHAIN_FRAMES):
        x = torch.from_numpy(pcm[:, f]).to(dev)
        payload, _rng, err = celt.encode_device(x)
        if err.any():
            fail(f"sim_loss traffic frame {f}: the encoder flagged lanes")
        dred.step(x, ones)
        pay = payload.cpu().numpy()
        for i, p in enumerate(dred.attach(
                [bytes([0xF8]) + pay[i].tobytes() for i in range(b)],
                CHAIN_MDB, CHAIN_RATE)):
            packets[i].append(p)
    torch.cuda.synchronize()
    k3 = EK.launches
    for s_, lane in enumerate(SIM_FX):
        packets[lane] = sim_fixture_packets(sfx)[s_]
    return packets, k3, time.time() - t0


def dred_from_frame(packets) -> int:
    """The first frame from which every lane's packets carry DRED."""
    from opus_tpu_torch.dnn.dred_dec import dred_find_payload
    nf = len(packets[0])
    first = 0
    for f in range(nf):
        if any(dred_find_payload(p[f]) is None for p in packets):
            first = f + 1
    if first >= nf:
        fail("sim_loss: the last frame's packets carry no DRED")
    return first


def sim_seeds(b: int):
    """Each lane's loss seed (1000 + lane; the fixture's streams 500 + s on
    lanes SIM_FX) and its source (lossgen below SIM_LOSSGEN_LANES)."""
    import numpy as np
    seeds = 1000 + np.arange(b)
    for s, lane in enumerate(SIM_FX):
        seeds[lane] = 500 + s
    return seeds, np.arange(b) < SIM_LOSSGEN_LANES


def sim_loss_inputs(dev, sfx):
    """The sim_loss phase's traffic (``sim_traffic``), the first frame with
    DRED on every packet, and each lane's flags from ``tools/loss.py`` on
    the card."""
    import numpy as np
    packets, k3, traffic_s = sim_traffic(dev, sfx)
    dred_from = dred_from_frame(packets)
    seeds, lg = sim_seeds(B_DNN)
    lost = sim_loss_flags(seeds, lg, CHAIN_FRAMES, dred_from, dev)
    if not np.array_equal(lost[list(SIM_FX), :SIM_LOOP], sfx["loop_lost"]):
        fail("sim_loss: the fixture lanes' flags differ from the JAX "
             "package's")
    return dict(packets=packets, k3=k3, traffic_s=traffic_s,
                dred_from=dred_from, lost=lost, lossgen=lg)


def cpu_sim_loss(packets, lost):
    """The sim_loss run on the CPU (the port's plain versions), in a worker
    process while the card runs."""
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder
    t0 = time.time()
    out = sim_loss_run(BatchedLossDecoder(len(packets), *sim_models("cpu"),
                                          device="cpu"), packets, lost)
    out["seconds"] = time.time() - t0
    return out


def phase_sim_loss(dev, sfx, inp, cpu_job):
    """The loss loop as a user drives it: the BatchedLossDecoder on the
    card over ``sim_loss_inputs``' traffic and flags, the K1 and K2
    counters reset just before it and read just after; held to the CPU run
    (``cpu_job``, a future of ``cpu_sim_loss``) and the JAX loop.  Returns
    what the timing phase and the kernels line need."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

    packets, lost, lg = inp["packets"], inp["lost"], inp["lossgen"]
    dred_from, k3 = inp["dred_from"], inp["k3"]
    b, nf = lost.shape
    width = max(len(p) for row in packets for p in row)
    torch.cuda.synchronize()
    CK.launches = iir.launches = 0
    dec = BatchedLossDecoder(b, *sim_models(dev), device=dev)
    card = sim_loss_run(dec, packets, lost)
    torch.cuda.synchronize()
    counts = {"K1": CK.launches, "K2": iir.launches}
    print(f"sim_loss launch counters over {nf} ticks: {counts}; the "
          f"traffic's encoder: K3 {k3}")
    if counts != {"K1": nf, "K2": card["k2"]} or k3 != nf:
        fail(f"sim_loss: expected K1 {nf}, K2 {card['k2']} and K3 {nf}")
    cpu = cpu_job.result()
    e_pcm, e_conc, n_conc = sim_compare(card, cpu, "card vs the CPU run")
    if not (np.array_equal(card["pending"], cpu["pending"])
            and np.array_equal(card["trace_mask"], cpu["trace_mask"])):
        fail("sim_loss: pending spans or concealed lanes card != CPU")
    m = card["trace_mask"]
    for k in ("trace_fec", "trace_period"):
        if not np.array_equal(card[k][m], cpu[k][m]):
            fail(f"sim_loss: {k[6:]} card != CPU")
    jx = sim_compare(card, sfx, "card vs the JAX loop", lanes=SIM_FX,
                     frames=SIM_LOOP)
    share = {src: float(lost[sel, dred_from:].mean()) for src, sel in
             (("sim_loss", lg), ("loss", ~lg))}
    print(f"sim_loss at B={b} over {nf} ticks (traffic {inp['traffic_s']:.1f} "
          f"s, packets up to {width} bytes, DRED on every packet from frame "
          f"{dred_from}): realised loss share from frame {dred_from} "
          f"{share['sim_loss']:.4f} (-sim_loss {SIM_LOSS_PERC:g}, lanes "
          f"0-{SIM_LOSSGEN_LANES - 1}) and {share['loss']:.4f} (-loss "
          f"{SIM_LOSS_PERC:g}); {card['resumes']} resume events, "
          f"{int(m.any(axis=1).sum())} concealed 10 ms frames "
          f"({int(m.sum())} lane-frames, {int(card['trace_fec'][m].sum())} "
          f"from a FEC row); pending at the end {int(card['pending'].sum())} "
          f"samples on {int((card['pending'] > 0).sum())} lanes (the "
          f"classic PLC's, not ported); card vs CPU: flags, ranges, FEC "
          f"choices, FARGAN periods equal, CELT PCM {e_pcm:.3g}, concealed "
          f"{e_conc} LSB on {n_conc} lane-frames; fixture lanes vs the JAX "
          f"loop ({SIM_LOOP} frames): CELT PCM {jx[0]:.3g}, concealed "
          f"{jx[1]} LSB on {jx[2]} lane-frames; card ticks "
          f"{1e3 * min(card['tick_s']):.1f}-{1e3 * max(card['tick_s']):.1f} "
          f"ms; the CPU run took {cpu['seconds']:.1f} s (worker process)")
    return dict(counts=dict(counts, K3=k3), packets=packets, lost=lost,
                e_pcm=e_pcm, e_conc=e_conc)


def plc_lanes_run(lp, hist, lost, reset, feed=None):
    """PLC_TICKS ticks of per-lane update / conceal on an LPCNetPLC (reset
    before PLC_RESET_TICK on the lanes of ``reset``): per tick the
    concealed int16, features, FARGAN period and counters, the lanes
    whose conceal primed FARGAN (``primed``) and the pitch features of its
    5 priming frames (``cont_pitch``), numpy; and the K2 launches the run
    makes.  ``feed`` (int16 [B, PLC_TICKS, 160], another run's concealed
    frames) puts those frames in the history in place of this run's own,
    so that the next catch-up analyses the same PCM."""
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.dnn import plc as PL
    dev = lp.device
    h = torch.as_tensor(hist, device=dev)
    keys = ("loss_count", "analysis_pos", "predict_pos", "blend",
            "analysis_gap")
    rec = {k: [] for k in ("pcm", "feats", "period", "primed",
                           "cont_pitch") + keys}
    k2 = 0
    orig_cont = PF.cont

    def cont(model, state, pcm0, features0):
        rec["cont_pitch"][-1] = features0[..., PL.NB_BANDS]
        return orig_cont(model, state, pcm0, features0)
    PF.cont = cont
    try:
        for t in range(PLC_TICKS):
            if t == PLC_RESET_TICK:
                lp.reset(torch.as_tensor(reset, device=dev))
            lt = torch.as_tensor(lost[:, t], device=dev)
            primed = lt & (lp.blend == 0)
            rec["primed"].append(primed)
            rec["cont_pitch"].append(torch.zeros((len(hist), 5),
                                                 device=dev))
            lp.update(h[:, t], ~lt)
            rec["pcm"].append(lp.conceal(lt))
            k2 += PF.FARGAN_NB_SUBFRAMES * (1 + bool(primed.any()))
            if feed is not None:
                fed = torch.as_tensor(feed[:, t], device=dev)
                lp.pcm = torch.where(lt[:, None], torch.cat(
                    [lp.pcm[:, :-160], fed.to(torch.float32) / 32768.0],
                    dim=1), lp.pcm)
            rec["feats"].append(lp.features)
            rec["period"].append(lp.fargan.last_period)
            for k in keys:
                rec[k].append(getattr(lp, k))
    finally:
        PF.cont = orig_cont
    return {k: torch.stack(v, dim=1).cpu().numpy() for k, v in
            rec.items()}, k2


def period_value(f):
    """FARGAN's period before rounding (``fargan.period_from_feature``'s
    256 / 2**(...) in its float32 steps) from pitch features, float64."""
    import numpy as np
    f = np.asarray(f, np.float32)
    e = np.float32(1.0 / 60.0) * ((f + np.float32(1.5)) * np.float32(60.0))
    p = np.power(2.0, e.astype(np.float64)).astype(np.float32)
    return (np.float32(256.0) / p).astype(np.float64)


def period_flips(card, ref):
    """[B] the first tick at which a lane's FARGAN period decisions (its 5
    priming frames' and its synthesized frame's) differ between two
    plc_lanes runs (PLC_TICKS where none does).  A difference is allowed
    only where the period before rounding lies within the features'
    float bound (PLC_FEAT_TOL, through d period = period ln 2 d feature)
    of k + 0.5; fails on any other, or on more than 1% of the lanes."""
    import numpy as np
    vc, vr = period_value(card["cont_pitch"]), period_value(ref["cont_pitch"])
    cont = card["primed"][..., None] & (np.floor(vc + 0.5)
                                        != np.floor(vr + 0.5))
    synth = card["period"] != ref["period"]
    vs = period_value(card["feats"][..., 18])
    margin = np.log(2.0) * PLC_FEAT_TOL

    def near(v):
        return np.abs(v - np.floor(v) - 0.5) <= margin * v
    ok = (~cont | near(vc)).all(axis=2) & (~synth | near(vs))
    bad = cont.any(axis=2) | synth
    first = np.where(bad.any(axis=1), bad.argmax(axis=1), PLC_TICKS)
    lanes = np.nonzero(first < PLC_TICKS)[0]
    if not ok[lanes, first[lanes]].all():
        fail(f"plc_lanes: FARGAN periods differ away from a rounding "
             f"boundary on lanes {lanes[~ok[lanes, first[lanes]]][:8]}")
    if len(lanes) > len(first) // 100:
        fail(f"plc_lanes: period flips on {len(lanes)} lanes")
    return first


def plc_lanes_inputs(dev, sfx):
    """The plc_lanes phase's B_DNN lanes: the fixture's 8 histories then
    seeded speech-like ones, each lane's BatchedLossGen pattern
    (PLC_LOSS_PERC, seed 300 + lane) from the card, every third lane
    reset."""
    import numpy as np
    from opus_tpu_torch.dnn import lossgen
    from opus_tpu_torch.tools.loss import loss_flags
    b = B_DNN
    n_fx = sfx["plc_lost"].shape[0]
    hist = np.concatenate([sfx["plc_hist"],
                           speech_history(b - n_fx, 8, PLC_TICKS)])
    lost = loss_flags(PLC_TICKS, 300 + np.arange(b),
                      sim_loss_perc=PLC_LOSS_PERC,
                      model=lossgen.random_model(LOSSGEN_SEED, device=dev),
                      device=dev).cpu().numpy()
    if not np.array_equal(lost[:n_fx], sfx["plc_lost"]):
        fail("plc_lanes: the fixture lanes' patterns differ from JAX's")
    return dict(hist=hist, lost=lost, reset=np.arange(b) % 3 == 0)


def cpu_plc_lanes(hist, lost, reset, feed):
    """plc_lanes_run on the CPU fed the card's concealed frames, in a
    worker process."""
    from opus_tpu_torch.dnn import plc as PL
    t0 = time.time()
    out, _ = plc_lanes_run(PL.LPCNetPLC(*plc_models("cpu"), len(hist),
                                        device="cpu"), hist, lost, reset,
                           feed)
    return out, time.time() - t0


def phase_plc_lanes(dev, sfx, inp, pool):
    """Per-lane update / conceal on ``plc_lanes_inputs``' lanes with K2
    counted; card vs the CPU run on every lane (integers equal, PCM within
    1 LSB, features within PLC_FEAT_TOL) and vs the fixture's 8 JAX
    instances on lanes 0-7.  The CPU run (in ``pool``) is fed the card's
    concealed frames, so that every catch-up of both runs analyses the
    same PCM.  A FARGAN period may flip at a rounding boundary
    (``period_flips``: a card run met 150.49998 on the card and 150.5 on
    the CPU in one priming frame of lane 260, from analysed
    pitch features one float32 step apart, and the concealed frame moved
    by 708 LSB); such a lane is held up to the flip and counted."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import plc as PL
    from opus_tpu_torch.ops import iir

    hist, lost, reset = inp["hist"], inp["lost"], inp["reset"]
    b = len(hist)
    n_fx = sfx["plc_lost"].shape[0]
    torch.cuda.synchronize()
    iir.launches = 0
    card, k2 = plc_lanes_run(PL.LPCNetPLC(*plc_models(dev), b, device=dev),
                             hist, lost, reset)
    torch.cuda.synchronize()
    counts = {"K2": iir.launches}
    print(f"plc_lanes launch counters over {PLC_TICKS} ticks: {counts}")
    if counts["K2"] != k2:
        fail(f"plc_lanes: K2 launched {counts['K2']} times, expected {k2}")
    cpu, cpu_s = pool.submit(cpu_plc_lanes, hist, lost, reset,
                             card["pcm"]).result()
    ints = ("period", "loss_count", "analysis_pos", "predict_pos", "blend",
            "analysis_gap")

    def check(got, ref, what, upto):
        held = np.arange(PLC_TICKS)[None, :] < upto[:, None]
        for k in ints:
            if not np.array_equal(got[k][held], ref[k][held]):
                fail(f"plc_lanes {what}: {k} differs")
        e_pcm = int(np.abs(got["pcm"][held].astype(np.int64)
                           - ref["pcm"][held].astype(np.int64)).max())
        e_f = float(np.abs(got["feats"][held] - ref["feats"][held]).max())
        if e_pcm > PLC_LSB_16K or not e_f <= PLC_FEAT_TOL:
            fail(f"plc_lanes {what}: PCM {e_pcm} LSB, features {e_f}")
        return e_pcm, e_f
    first = period_flips(card, cpu)
    flipped = np.nonzero(first < PLC_TICKS)[0]
    e_cpu = check(card, cpu, "card vs the CPU run", first)
    e_jax = check({k: v[:n_fx] for k, v in card.items()},
                  {k: sfx["plc_" + k] for k in ints + ("pcm", "feats")},
                  "card vs JAX", np.full(n_fx, PLC_TICKS))
    print(f"plc_lanes at B={b}: {int(lost.sum())} concealed lane-ticks of "
          f"{lost.size} (loss share {lost.mean():.4f}), reset on "
          f"{int(reset.sum())} lanes before tick {PLC_RESET_TICK}; "
          f"integers equal card / CPU, PCM {e_cpu[0]} LSB, features "
          f"{e_cpu[1]:.3g} (the CPU run fed the card's concealed frames); "
          f"lanes with a FARGAN period flipped at a rounding boundary, held "
          f"up to the flip: {flipped.tolist()} at ticks "
          f"{first[flipped].tolist()}; {e_jax[0]} LSB, {e_jax[1]:.3g} vs "
          f"JAX ({n_fx} lanes, every tick); the CPU run took {cpu_s:.1f} s "
          f"(worker process)")
    return dict(counts=counts, hist=hist, lost=lost)


def rate_offsets(off48, fs: int):
    """The deep-PLC fixture's 48 kHz offsets at fs: whole 10 ms frames kept,
    the remainder scaled."""
    return (off48 // 480) * (fs // 100) + (off48 % 480) * fs // 48000


RATE_PIECES = 6


def rate_inputs(b: int):
    """Seeded int16 [b, RATE_PIECES, 160] for the resampler alone (8
    full-scale lanes, 8 alternating at -32768)."""
    import numpy as np
    rng = np.random.default_rng(40)
    x = np.clip(rng.standard_normal((b, RATE_PIECES, 160)) * 9000, -32768,
                32767).astype(np.int64)
    x[:8] = 32767
    x[8:16, :, ::2] = -32768
    return x


def plc_rates_run(fs, device, dreds, hist, off48, x):
    """16 good frames, then dred_decode of 60 ms at fs on ``device``
    (int16, each concealed frame's lanes, FEC choices and FARGAN periods,
    numpy), and the resampler alone on ``x``."""
    import numpy as np
    import torch
    from opus_tpu_torch.models.deep_plc import BatchedDeepPLC
    from opus_tpu_torch.silk import resampler as PR
    p = BatchedDeepPLC(*plc_models(device), len(hist), fs=fs, device=device)
    h = torch.as_tensor(hist, device=device)
    for k in range(16):
        p.lpcnet.update(h[:, k])
    out = p.dred_decode(dreds, rate_offsets(off48, fs), 6 * fs // 100)
    trace = [np.stack([t.cpu().numpy() for t in e]) for e in p.trace]
    st = PR.dec_resampler_init(len(x), fs, device)
    ys = []
    for k in range(x.shape[1]):
        y, st = PR.resample_16k(torch.as_tensor(x[:, k], device=device), st,
                                fs)
        ys.append(y.cpu().numpy())
    return out.cpu().numpy(), np.stack(trace), np.concatenate(ys, axis=1)


def cpu_plc_rates(dreds, hist, off48):
    """plc_rates_run at every rate on the CPU, in a worker process."""
    t0 = time.time()
    x = rate_inputs(len(hist))
    out = {fs: plc_rates_run(fs, "cpu", dreds, hist, off48, x)
           for fs in PLC_RATES}
    return out, time.time() - t0


def phase_plc_rates(dev, sfx, plc, cpu_job):
    """The deep-PLC sequence's first step (16 good frames, dred_decode
    of 60 ms) at 8, 12 and 24 kHz on the deep-PLC phase's lanes, K2
    counted; card vs the CPU run (``cpu_job``) on every lane (FEC choices
    and FARGAN periods equal, int16 within plc_rate_lsb) and the JAX
    decoder's output on the fixture lanes; the resampler alone card vs CPU
    bit for bit."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    from opus_tpu_torch.ops import iir

    b = B_DNN
    x = rate_inputs(b)
    n_fx = plc["n_fx"]
    counts = {"K2": 0}
    card = {}
    for fs in PLC_RATES:
        torch.cuda.synchronize()
        iir.launches = 0
        card[fs] = plc_rates_run(fs, dev, plc["dreds"], plc["hist"],
                                 plc["off48"], x)
        torch.cuda.synchronize()
        counts["K2"] += iir.launches
        if iir.launches != PF.FARGAN_NB_SUBFRAMES * (1 + 6):
            fail(f"plc_rates at {fs} Hz: K2 launched {iir.launches} times")
    cpu, cpu_s = cpu_job.result()
    for fs in PLC_RATES:
        (out, tr, rs), (out_c, tr_c, rs_c) = card[fs], cpu[fs]
        if not np.array_equal(rs, rs_c):
            fail(f"plc_rates: the resampler at {fs} Hz card != CPU")
        if not np.array_equal(tr, tr_c):
            fail(f"plc_rates at {fs} Hz: FEC choices or periods card != CPU")
        bound = plc_rate_lsb(fs)
        e_cpu = int(np.abs(out.astype(np.int64) - out_c).max())
        ref = np.tile(sfx[f"rate_pcm{fs // 1000}"], (DRED_TILE, 1))
        e_jax = int(np.abs(out[:n_fx].astype(np.int64) - ref).max())
        if e_cpu > bound or e_jax > bound:
            fail(f"plc_rates at {fs} Hz: {e_cpu} / {e_jax} LSB > {bound}")
        print(f"plc_rates at {fs} Hz, B={b}: dred_decode of 60 ms (catch-up, "
              f"6 frames, Resampler(16000, {fs})): FEC choices and FARGAN "
              f"periods equal card / CPU; int16 within {e_cpu} LSB of the "
              f"CPU run and {e_jax} of JAX ({n_fx} lanes), bound {bound}; "
              f"the resampler alone card == CPU on {x.size} samples")
    print(f"plc_rates: K2 {counts['K2']}; the CPU run took {cpu_s:.1f} s "
          f"(worker process)")
    return dict(counts=counts)


def cpu_pool(workers: int = 4):
    """Worker processes for the CPU reference runs of the loss phases (or,
    with 2 workers, of opus_rates and opus_ms from the start), so that
    they run while the card does (2 torch threads each)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init)


def _cpu_worker_init():
    import torch
    sys.path.insert(0, REPO)
    torch.set_num_threads(2)


def loss_times(dev, smi, sl, pl, plc):
    """CUDA event times (and device operations and busy share from the
    profiler, one call after the timed ones: the profiler's host time is
    ~0.25 ms an operation) of a BatchedLossDecoder tick with no resuming
    lane and one with resuming lanes, BatchedLossGen's first sample (the
    burn-in: 1001 samples, so its operations are counted from a later
    sample's) and a later one, a conceal with a third of the lanes masked,
    and dred_decode of 60 ms at 8, 12 and 24 kHz."""
    import copy
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import lossgen
    from opus_tpu_torch.dnn import plc as PL
    from opus_tpu_torch.models.deep_plc import BatchedDeepPLC
    from opus_tpu_torch.silk import resampler as PR
    from opus_tpu_torch.tools.device_time import device_profile
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

    b = B_DNN
    out = {}

    def timed(setup, fn, reps=3):
        ts = []
        for _ in range(reps):
            setup()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return min(ts)

    def report(name, setup, fn, reps=3, profiled=None):
        ms = timed(setup, fn, reps)
        ops, dms = profiled if profiled else device_profile(
            lambda: (setup(), fn()), reps=1, warmup=False)
        out[name] = ms
        print(f"loss times [{smi}]: {name} at B={b}: {ms:.3f} ms a call, "
              f"{ops:.0f} device operations, {dms:.3f} ms device (busy "
              f"{100 * dms / ms:.1f}%)")

    packets = sl["packets"]
    dec = BatchedLossDecoder(b, *sim_models(dev), device=dev)
    first = np.zeros(b, bool)
    first[::10] = True
    dec.tick([p[0] for p in packets], first)
    snap = (dec.celt.state, copy.copy(dec.plc.lpcnet), dec.plc.rs,
            dec.pending(), dec.resumes)

    def restore():
        (dec.celt.state, lp, dec.plc.rs, dec._pending, dec.resumes) = snap
        dec.plc.lpcnet = copy.copy(lp)
    none = np.zeros(b, bool)

    def restore_none():
        restore()
        dec._pending = np.zeros(b, np.int64)
    report("tick, no resuming lane", restore_none,
           lambda: dec.tick([p[1] for p in packets], none))
    report(f"tick, {int(first.sum())} lanes resuming after 20 ms", restore,
           lambda: dec.tick([p[1] for p in packets], none))
    model = lossgen.random_model(LOSSGEN_SEED, device=dev)
    seeds = 1000 + np.arange(SIM_LOSSGEN_LANES)
    gen = [None]

    def fresh():
        gen[0] = lossgen.BatchedLossGen(model, seeds, device=dev)
    fresh()
    gen[0].sample(SIM_LOSS_PERC)
    ops, dms = device_profile(lambda: gen[0].sample(SIM_LOSS_PERC), reps=3)
    report(f"BatchedLossGen.sample, {SIM_LOSSGEN_LANES} lanes",
           lambda: None, lambda: gen[0].sample(SIM_LOSS_PERC),
           profiled=(ops, dms))
    burn = lossgen.BURN_IN + 1
    report(f"BatchedLossGen.sample with the burn-in, {SIM_LOSSGEN_LANES} "
           f"lanes ({burn} samples' operations)", fresh,
           lambda: gen[0].sample(SIM_LOSS_PERC), reps=1,
           profiled=(burn * ops, burn * dms))
    lp = PL.LPCNetPLC(*plc_models(dev), b, device=dev)
    h = torch.as_tensor(pl["hist"], device=dev)
    for k in range(16):
        lp.update(h[:, k])
    third = torch.as_tensor(np.arange(b) % 3 == 0, device=dev)
    lp.conceal(third)
    lp0 = copy.copy(lp)
    report("conceal on a third of the lanes", lambda: None,
           lambda: copy.copy(lp0).conceal(third))
    # dred_decode differs between the rates only by the resampler: the
    # 24 kHz call is profiled whole, the others take its operations with
    # its resampler's 6 pieces swapped for their own (profiled alone)
    piece = torch.as_tensor(rate_inputs(b)[:, 0], device=dev)
    rs_prof = {fs: device_profile(lambda fs=fs: PR.resample_16k(
        piece, PR.dec_resampler_init(b, fs, dev), fs), reps=3)
        for fs in PLC_RATES}
    whole = None
    for fs in sorted(PLC_RATES, reverse=True):
        p = BatchedDeepPLC(*plc_models(dev), b, fs=fs, device=dev)
        hh = torch.as_tensor(plc["hist"], device=dev)
        for k in range(16):
            p.lpcnet.update(hh[:, k])
        snap_p = (copy.copy(p.lpcnet), p.rs)

        def back(p=p, s=snap_p):
            p.lpcnet, p.rs = copy.copy(s[0]), s[1]

        def call(p=p, fs=fs):
            return p.dred_decode(plc["dreds"], rate_offsets(plc["off48"], fs),
                                 6 * fs // 100)
        if whole is None:
            prof = whole = device_profile(lambda: (back(), call()), reps=1,
                                          warmup=False)
        else:
            prof = tuple(w + 6 * (r - r24) for w, r, r24 in zip(
                whole, rs_prof[fs], rs_prof[max(PLC_RATES)]))
        report(f"dred_decode of 60 ms at {fs} Hz (catch-up of 15 frames"
               f"{'' if prof is whole else '; operations from 24 kHz'})",
               back, call, reps=1, profiled=prof)
    return out


# The classic CELT packet-loss concealment (``celt/plc.py``,
# ``KernelCeltDecoder.conceal``) and opus_demo's loss loops without DRED
# (plain: a lost packet concealed in its own tick), with -inbandfec (the loss
# deferred to the next packet, then concealed; a CELT-only stream carries
# no LBRR) and with -dred where a resuming packet carries no DRED, as
# ``tools/sim_loss.BatchedLossDecoder(dred=, inbandfec=)``.  The fixture
# tests/data/torch_celt_plc.npz (tools/make_torch_celt_plc_fixture.py) holds
# the JAX package's opus_demo loops on torch_sim_loss.npz's 8 streams, each
# lane under its own pattern, and 10 ms concealments.  Bounds:
# - branches, pitch periods, zeroing decisions, loss flags and final ranges
#   equal (card, CPU and JAX);
# - decoded PCM, the frames after a loss included, within PCM_ABS_TOL (the
#   decode phase's 1e-4);
# - concealed int16 within CLASSIC_LSB: the concealment runs in float64
#   from the float32 history, energies and postfilter state, which hold
#   the decoded PCM's bound; extrapolating that history does not amplify
#   it (the attenuation and the energy rescaling are <= 1 and the LPC
#   synthesis inverts the LPC analysis of the same samples), so the
#   concealed float PCM holds PCM_ABS_TOL too, and its int16 (floor(32768
#   x + 0.5)) moves by at most floor(32768 PCM_ABS_TOL) + 1 = 4 LSB
#   (measured: 1 LSB, the float gap ~2e-6);
# - concealed from DRED: PLC_LSB_48K, as in sim_loss.
# A pitch period or a zeroing decision whose tie margin (``plc_trace``'s
# ``pitch_margin``: the relative gap of the correlation ratios or half-lag
# tests behind it; ``zero_margin``: of s1 against 0.2 s2) is below
# CLASSIC_FLIP_TOL on the card or the CPU may flip between them (their
# float64 sums round in other orders, their histories hold the PCM bound):
# such a flip is counted, and its lane is held up to it.
CELT_PLC_FIXTURE = os.path.join(REPO, "tests", "data", "torch_celt_plc.npz")
CLASSIC_LSB = int(32768 * PCM_ABS_TOL) + 1
CLASSIC_FLIP_TOL = 1e-3
CLASSIC_DRED_FRAMES = 12        # the -dred loop's ticks (the fixture's)
CLASSIC_KEYS = ("branch", "pitch", "zeroed", "pitch_margin", "zero_margin")


def classic_loss_run(dec, packets, lost, flush=True):
    """Drives a BatchedLossDecoder through packets[i][f] with the flags
    lost [B, F], then ``flush()``; returns numpy: each lane's int16 output
    in frame order (``out16`` [B, F * 960]: a slot's samples whenever the
    loop emitted them), per slot its ``kind`` (0 decoded, 1 concealed
    classically, 2 from DRED, 3 the zeros of a lane that has decoded
    nothing), the final range of a decoded packet (``rng``), its float PCM
    (``celt``), the classic concealment's branch, pitch, zeroing and tie
    margins, the span ``pending`` at the end, the number of K2 launches
    (``k2``: one a tick for the CELT decode, one a concealment call with a
    concealing lane, 4 a FARGAN subframe of each DRED frame and priming)
    and the tick times."""
    import numpy as np
    import torch
    from opus_tpu_torch.dnn import fargan as PF
    b, nf = lost.shape
    out16 = np.zeros((b, nf * 960), np.int16)
    n = np.zeros(b, np.int64)
    rec = dict(kind=np.zeros((b, nf), np.int8),
               rng=np.zeros((b, nf), np.uint32),
               branch=np.zeros((b, nf), np.int8),
               pitch=np.zeros((b, nf), np.int64),
               zeroed=np.zeros((b, nf), bool),
               pitch_margin=np.ones((b, nf)), zero_margin=np.ones((b, nf)))
    celt = np.zeros((b, nf, 960), np.float32)
    queue = [[] for _ in range(b)]
    k2 = 0
    tick_s = []

    def emit(o, cnt):
        o = o.cpu().numpy()
        for i in np.nonzero(cnt)[0]:
            out16[i, n[i]:n[i] + cnt[i]] = o[i, :cnt[i]]
        n[:] += cnt

    def take(entries):
        nonlocal k2
        for e in entries:
            k2 += int((e["branch"] != 0).any())
            for i in np.nonzero(e["lanes"])[0]:
                f = queue[i].pop(0)
                rec["kind"][i, f] = 1 if e["branch"][i] else 3
                for k in CLASSIC_KEYS:
                    rec[k][i, f] = e[k][i]

    for f in range(nf):
        m0 = len(dec.classic_trace)
        blend = dec.plc.lpcnet.blend.cpu().numpy() if dec.plc else None
        for i in np.nonzero(lost[:, f])[0]:
            queue[i].append(f)
        t0 = time.perf_counter()
        o, cnt = dec.tick([packets[i][f] for i in range(b)], lost[:, f])
        if dec.device.type == "cuda":
            torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        emit(o, cnt)
        dl = dec.dred_lanes
        if dl.any():
            prime = bool((dl & (blend == 0)).any())
            k2 += PF.FARGAN_NB_SUBFRAMES * (prime + len(dec.plc.trace))
            for i in np.nonzero(dl)[0]:
                rec["kind"][i, queue[i]] = 2
                queue[i] = []
        take(dec.classic_trace[m0:])
        k2 += 1
        recv = ~lost[:, f]
        rec["rng"][recv, f] = dec.final_range().cpu().numpy()[recv]
        celt[recv, f] = dec.pcm.cpu().numpy()[recv]
    if flush:
        m0 = len(dec.classic_trace)
        emit(*dec.flush())
        take(dec.classic_trace[m0:])
    return dict(lost=lost, out16=out16, n=n, celt=celt,
                pending=dec.pending(), k2=k2, tick_s=tick_s, **rec)


def classic_fixture(cfx, name: str, frames=None) -> dict:
    """The fixture's ``name`` loop ("plain" or "dred") over its first
    ``frames`` frames (default all) in classic_loss_run's layout, without
    out16: ``conc`` the int16 of the concealed slots (kind 1 and 2,
    lane-major), ``after`` the float PCM of the first decoded frame after
    each concealed run."""
    import numpy as np
    kind = cfx[f"{name}_kind"]
    nf = kind.shape[1] if frames is None else frames
    early = np.arange(kind.shape[1]) < nf
    conc = (kind == 1) | (kind == 2)
    after = classic_after_mask(kind)
    out = {k: cfx[f"{name}_{k}"][:, :nf]
           for k in ("kind", "branch", "pitch", "zeroed")}
    out.update(lost=cfx["lost"][:, :nf], rng=cfx[f"{name}_range"][:, :nf],
               conc=cfx[f"{name}_conc"][(conc & early)[conc]],
               after=cfx[f"{name}_after_pcm"][(after & early)[after]])
    return out


def classic_after_mask(kind):
    """The first decoded frame after a run of concealed ones."""
    import numpy as np
    c = (kind == 1) | (kind == 2)
    after = np.zeros_like(c)
    after[:, 1:] = c[:, :-1] & (kind[:, 1:] == 0)
    return after


def classic_flips(got, ref, held):
    """Lanes whose first disagreement of kind, branch, pitch or zeroing
    with ``ref`` is a classic concealment whose tie margin (on either
    side) is below CLASSIC_FLIP_TOL: {lane: frame}; ``held`` [B, F] is
    cleared from that frame on.  Any other disagreement fails."""
    import numpy as np
    flips = {}
    diff = np.zeros_like(held)
    for k in ("kind", "branch", "pitch", "zeroed"):
        diff |= got[k] != ref[k]
    for i in np.nonzero(diff.any(axis=1))[0]:
        f = int(np.argmax(diff[i]))
        tie = min(got["pitch_margin"][i, f], got["zero_margin"][i, f],
                  ref["pitch_margin"][i, f], ref["zero_margin"][i, f])
        if got["kind"][i, f] != 1 or not tie < CLASSIC_FLIP_TOL:
            fail(f"classic loss: lane {i} frame {f}: kind / branch / pitch "
                 f"/ zeroing {[int(got[k][i, f]) for k in CLASSIC_KEYS[:3]]}"
                 f" against {[int(ref[k][i, f]) for k in CLASSIC_KEYS[:3]]}"
                 f" (tie margin {tie:.3g})")
        flips[int(i)] = f
        held[i, f:] = False
    return flips


def classic_compare(got, ref, what, lanes=None):
    """The classic loss bounds of ``got`` (a classic_loss_run result) on
    ``lanes`` (default all) against ``ref``: another run (every check on
    every held slot, flips excused as ``classic_flips`` says) or
    ``classic_fixture`` (its frames; no flip excused).  Returns (max
    decoded PCM error, max classic-concealed LSB, max DRED-concealed LSB,
    lane-slots concealed, flips)."""
    import numpy as np
    sel = np.arange(len(got["lost"])) if lanes is None else np.asarray(lanes)
    nf = ref["kind"].shape[1]
    g = {k: got[k][sel][:, :nf] for k in ("lost", "kind", "rng", "branch",
                                           "pitch", "zeroed", "pitch_margin",
                                           "zero_margin", "celt")}
    g16 = got["out16"][sel].reshape(len(sel), -1, 960)[:, :nf]
    if not np.array_equal(g["lost"], ref["lost"]):
        fail(f"classic loss {what}: loss flags differ")
    held = np.ones(g["kind"].shape, bool)
    flips = {}
    if "conc" in ref:
        for k in ("kind", "branch", "pitch", "zeroed"):
            if not np.array_equal(g[k], ref[k]):
                bad = np.argwhere(g[k] != ref[k])[:4].tolist()
                fail(f"classic loss {what}: {k} differs at {bad}")
    else:
        flips = classic_flips(g, {k: ref[k][sel][:, :nf] for k in g}, held)
    dec = (g["kind"] == 0) & held
    rr = ref["rng"] if "conc" in ref else ref["rng"][sel][:, :nf]
    if not np.array_equal(g["rng"][dec], rr[dec]):
        fail(f"classic loss {what}: final ranges differ on lane-frames "
             f"{np.argwhere(dec & (g['rng'] != rr))[:4].tolist()}")
    conc = (g["kind"] == 1) | (g["kind"] == 2)
    if "conc" in ref:
        after = classic_after_mask(g["kind"])
        e_pcm = float(np.abs(g["celt"][after] - ref["after"]).max()) \
            if after.any() else 0.0
        d16 = np.abs(g16[conc].astype(np.int64) - ref["conc"])
        zeros = g16[g["kind"] == 3]
    else:
        r16 = ref["out16"][sel].reshape(len(sel), -1, 960)[:, :nf]
        e_pcm = float(np.abs(g["celt"][dec] - ref["celt"][sel][:, :nf][dec])
                      .max()) if dec.any() else 0.0
        d16 = np.abs(g16[conc & held].astype(np.int64)
                     - r16[conc & held])
        zeros = g16[(g["kind"] == 3) & held]
    if zeros.any():
        fail(f"classic loss {what}: a lane that decoded nothing concealed "
             f"non-zero samples")
    if not e_pcm <= PCM_ABS_TOL:
        fail(f"classic loss {what}: decoded PCM err {e_pcm} > {PCM_ABS_TOL}")
    kinds = (g["kind"][conc & held] if "conc" not in ref
             else g["kind"][conc])
    e_cl = int(d16[kinds == 1].max()) if (kinds == 1).any() else 0
    e_dr = int(d16[kinds == 2].max()) if (kinds == 2).any() else 0
    if e_cl > CLASSIC_LSB or e_dr > PLC_LSB_48K:
        fail(f"classic loss {what}: concealed int16 {e_cl} LSB (bound "
             f"{CLASSIC_LSB}), from DRED {e_dr} (bound {PLC_LSB_48K})")
    return e_pcm, e_cl, e_dr, int(conc.sum()), flips


def strip_dred(p: bytes) -> bytes:
    """A one-frame CELT packet without its padding (and DRED): the TOC as
    code 0 and the CELT frame alone."""
    from opus_tpu_torch.tools.sim_loss import mode_frame
    return bytes([p[0] & 0xFC]) + mode_frame(p, "celt")


def dred_loop_packets(packets, strip):
    """packets[i][f] for the -dred loop's frames, DRED stripped where strip
    [B, F] holds."""
    nf = strip.shape[1]
    return [[strip_dred(p) if strip[i, f] else p
             for f, p in enumerate(row[:nf])] for i, row in
            enumerate(packets)]


def classic_inputs(sl_in, cfx):
    """The celt_plc phase's traffic: sim_loss's packets and flags (lanes
    0-511 BatchedLossGen, 512-1023 i.i.d. 10%); on lanes SIM_FX (which
    carry torch_sim_loss.npz's streams) the fixture's flags.  The -dred
    loop's packets: DRED stripped from every fourth packet (frames 2, 6,
    10) on a quarter of the lanes (lane % 4 == 1), and on SIM_FX as the
    fixture strips them."""
    import numpy as np
    packets = sl_in["packets"]
    lost = sl_in["lost"].copy()
    fx = list(SIM_FX)
    lost[fx] = cfx["lost"]
    nd = CLASSIC_DRED_FRAMES
    strip = np.zeros((len(packets), nd), bool)
    strip[1::4, 2::4] = True
    strip[fx] = cfx["strip"][:, :nd]
    return dict(packets=packets, lost=lost,
                dred_packets=dred_loop_packets(packets, strip),
                dred_lost=lost[:, :nd], strip=strip)


def cpu_classic(packets, lost, dred):
    """A classic loop on the CPU (the port's plain versions) in a worker
    process while the card runs: plain, or -dred (opus_demo's models)."""
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder
    t0 = time.time()
    models = sim_models("cpu") if dred else ()
    out = classic_loss_run(BatchedLossDecoder(len(packets), *models,
                                              device="cpu", dred=dred),
                           packets, lost)
    out["seconds"] = time.time() - t0
    return out


def phase_celt_plc(dev, cfx, inp, jobs):
    """The classic loops as a user drives them on the card: the plain loop
    over 24 ticks and the -dred loop over CLASSIC_DRED_FRAMES, each with
    flush(), the K1 and K2 counters reset just before each and read just
    after; held to the CPU runs (``jobs``: futures of cpu_classic) on every
    lane and to the JAX loops on the fixture lanes.  -inbandfec conceals
    what the plain loop conceals (a CELT-only stream has no LBRR), one
    tick later: the CPU tests hold it."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

    res = {}
    for name, pk, lost, dred in (
            ("plain", inp["packets"], inp["lost"], False),
            ("dred", inp["dred_packets"], inp["dred_lost"], True)):
        b, nf = lost.shape
        models = sim_models(dev) if dred else ()
        torch.cuda.synchronize()
        CK.launches = iir.launches = 0
        dec = BatchedLossDecoder(b, *models, device=dev, dred=dred)
        card = classic_loss_run(dec, pk, lost)
        torch.cuda.synchronize()
        counts = {"K1": CK.launches, "K2": iir.launches}
        if counts != {"K1": nf, "K2": card["k2"]}:
            fail(f"celt_plc {name}: launches {counts}, expected K1 {nf}, "
                 f"K2 {card['k2']}")
        if card["pending"].any():
            fail(f"celt_plc {name}: samples pending after flush")
        cpu = jobs[name].result()
        e_cpu = classic_compare(card, cpu, f"{name}: card vs the CPU run")
        e_jax = classic_compare(card, classic_fixture(cfx, name),
                                f"{name}: card vs the JAX loop",
                                lanes=SIM_FX)
        k = card["kind"]
        br = card["branch"]
        print(f"celt_plc {name} at B={b} over {nf} ticks + flush: "
              f"{int((k == 1).sum())} classic concealments "
              f"({int((br == 1).sum())} periodic, {int((br == 2).sum())} "
              f"noise, {int(card['zeroed'].sum())} zeroed), "
              f"{int((k == 2).sum())} from DRED, {int((k == 3).sum())} "
              f"before any packet; launches {counts}; card vs CPU: decoded "
              f"PCM {e_cpu[0]:.3g}, concealed {e_cpu[1]} LSB (DRED "
              f"{e_cpu[2]}), {len(e_cpu[4])} tie flips excused "
              f"{e_cpu[4]}; fixture lanes vs JAX: decoded PCM "
              f"{e_jax[0]:.3g}, concealed {e_jax[1]} LSB (DRED {e_jax[2]}) "
              f"on {e_jax[3]} slots; card ticks "
              f"{1e3 * min(card['tick_s']):.1f}-"
              f"{1e3 * max(card['tick_s']):.1f} ms; the CPU run took "
              f"{cpu['seconds']:.1f} s (worker process)")
        res[name] = dict(counts=counts, e_cpu=e_cpu, e_jax=e_jax,
                         kind=k, branch=br)
    return res


def celt_plc_times(dev, smi, inp):
    """CUDA event times, device operations and busy share of a plain-loop
    tick at B_DNN with no lost lane, with every tenth lane's first loss
    (periodic, with the pitch search), with their second loss (periodic,
    the period kept), and with their sixth (noise)."""
    import numpy as np
    import torch
    from opus_tpu_torch.tools.device_time import device_profile
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

    b = B_DNN
    pk = inp["packets"]
    dec = BatchedLossDecoder(b, device=dev, dred=False)
    none = np.zeros(b, bool)
    some = np.zeros(b, bool)
    some[::10] = True
    for f in range(3):
        dec.tick([p[f] for p in pk], none)
    snaps = [dict(dec.celt.state)]
    for k in range(5):
        dec.tick([p[3 + k] for p in pk], some)
        snaps.append(dict(dec.celt.state))
    out = {}
    for name, snap, flags in (("no lost lane", 0, none),
                              (f"{int(some.sum())} lanes' first loss "
                               f"(periodic, pitch search)", 0, some),
                              ("their second loss (periodic)", 1, some),
                              ("their sixth loss (noise)", 5, some)):
        def setup(s=snaps[snap]):
            dec.celt.state = dict(s)
            dec.classic_trace = []

        def call(flags=flags):
            dec.tick([p[8] for p in pk], flags)
        ts = []
        for _ in range(2):
            setup()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        ms = min(ts)
        ops, dms = device_profile(lambda: (setup(), call()), reps=1,
                                  warmup=False)
        out[name] = ms
        print(f"celt_plc times [{smi}]: a tick at B={b}, {name}: {ms:.3f} "
              f"ms a call ({b * 20 / ms:.0f} realtime streams), {ops:.0f} "
              f"device operations, {dms:.3f} ms device (busy "
              f"{100 * dms / ms:.1f}%)")
    return out


# ---- SILK / hybrid loss: the classic concealment, CNG and in-band FEC ----
SILK_PLC_FIXTURE = os.path.join(REPO, "tests", "data", "torch_silk_plc.npz")
SILK_PLC_TICKS = 10     # of the fixture's 16 (the script's time limit)
SILK_PLC_KEY = dict(silk="silk", hybrid="hyb")     # the fixture's prefixes
SLOT_KEYS = ("kind", "rng", "loss_cnt")


def silk_plc_packets(sfx, mode: str):
    """The fixture's 8 streams of ``mode`` ("silk" or "hybrid"): [8][16]
    packets, TOC included."""
    k = SILK_PLC_KEY[mode]
    buf, lens = sfx[f"{k}_packets"], sfx[f"{k}_lens"]
    return [[bytes(buf[i, f, :lens[i, f]]) for f in range(lens.shape[1])]
            for i in range(lens.shape[0])]


def slot_digests(out16):
    """[B, F, 16] uint8: each 20 ms slot's BLAKE2b-128 digest of its int16
    samples (little-endian), as tools/make_torch_silk_plc_fixture.py keeps
    the SILK loops' reference."""
    import hashlib
    import numpy as np
    b = out16.shape[0]
    slots = np.ascontiguousarray(out16.astype("<i2")).reshape(b, -1, 960)
    return np.asarray([[np.frombuffer(hashlib.blake2b(
        x.tobytes(), digest_size=16).digest(), np.uint8) for x in row]
        for row in slots])


def loss_run(dec, packets, lost, flush=True):
    """Drives a BatchedLossDecoder of any mode through packets[i][f] with
    the flags lost [B, F], then ``flush()``; returns numpy: each lane's
    int16 output in slot order (``out16`` [B, F * 960]), per 20 ms slot its
    ``kind`` (``sim_loss.KINDS``: 0 decoded, 1 concealed, 2 from DRED, 3
    zeros, 4 LBRR, 5 DTX), the final range after it (``rng``) and the SILK
    loss count after it (``loss_cnt``), the span ``pending`` at the end
    and the tick times."""
    import numpy as np
    import torch
    b, nf = lost.shape
    out16 = np.zeros((b, nf * 960), np.int16)
    n = np.zeros(b, np.int64)
    rec = dict(kind=np.full((b, nf), -1, np.int8),
               rng=np.zeros((b, nf), np.uint32),
               loss_cnt=np.zeros((b, nf), np.int16))
    slot = np.zeros(b, np.int64)
    tick_s = []

    def emit(o, cnt):
        o = o.cpu().numpy()
        for i in np.nonzero(cnt)[0]:
            out16[i, n[i]:n[i] + cnt[i]] = o[i, :cnt[i]]
        n[:] += cnt

    def take(events):
        for ev in events:
            idx = np.nonzero(ev["lanes"])[0]
            if "span" in ev:                               # DRED
                for i in idx:
                    k = int(ev["span"][i])
                    rec["kind"][i, slot[i]:slot[i] + k] = 2
                    slot[i] += k
                continue
            s = slot[idx]
            rec["kind"][idx, s] = ev["kind"][idx]
            rec["rng"][idx, s] = ev["rng"][idx]
            if "loss_cnt" in ev:
                rec["loss_cnt"][idx, s] = ev["loss_cnt"][idx]
            slot[idx] += 1

    for f in range(nf):
        e0 = len(dec.events)
        t0 = time.perf_counter()
        o, cnt = dec.tick([packets[i][f] for i in range(b)], lost[:, f])
        if dec.device.type == "cuda":
            torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        emit(o, cnt)
        take(dec.events[e0:])
    if flush:
        e0 = len(dec.events)
        emit(*dec.flush())
        take(dec.events[e0:])
    return dict(lost=lost, out16=out16, n=n, pending=dec.pending(),
                tick_s=tick_s, **rec)


def silk_plc_fixture(sfx, mode: str, loop: str, ticks=None) -> dict:
    """The fixture's ``loop`` ("plain" or "fec") of ``mode`` over its first
    ``ticks`` frames (default all) in loss_run's layout: kind, rng,
    loss_cnt and lost, and the reference output: ``digest`` (SILK: each
    slot's digest) or ``out16`` (hybrid).  Cut short, the -inbandfec
    loop's slots of a loss run still open at the cut (which a run of
    ``ticks`` ticks flushes and the fixture resumes later) are marked kind
    -2: not held."""
    import numpy as np
    k = SILK_PLC_KEY[mode]
    nf = sfx[f"{k}_lost"].shape[1] if ticks is None else ticks
    lost = sfx[f"{k}_lost"][:, :nf]
    out = dict(lost=lost, kind=sfx[f"{k}_{loop}_kind"][:, :nf].copy(),
               rng=sfx[f"{k}_{loop}_range"][:, :nf],
               loss_cnt=sfx[f"{k}_{loop}_loss_cnt"][:, :nf])
    if loop == "fec":
        for i in range(len(lost)):
            f = nf - 1
            while f >= 0 and lost[i, f]:
                out["kind"][i, f] = -2
                f -= 1
    if mode == "silk":
        out["digest"] = sfx[f"silk_{loop}_digest"][:, :nf]
    else:
        plain = np.cumsum(sfx["hyb_plain_d16"].astype(np.int64), axis=1)
        if loop == "fec":
            plain = plain + np.cumsum(sfx["hyb_fec_d16"].astype(np.int64),
                                      axis=1)
        out["out16"] = plain[:, :nf * 960].astype(np.int16)
    return out


def silk_plc_compare(got, ref, mode: str, what: str, lanes=None):
    """The SILK / hybrid loss bounds of ``got`` (a loss_run result) on
    ``lanes`` (default all) against ``ref``, whose rows are those lanes:
    another run or ``silk_plc_fixture``.  Slot kinds, final ranges and
    SILK loss counts equal; SILK int16 equal on every sample (against the
    fixture, each slot's digest); hybrid int16 within CLASSIC_LSB.
    Returns (max int16 difference, slots by kind)."""
    import numpy as np
    sel = np.arange(len(got["lost"])) if lanes is None else np.asarray(lanes)
    r = {k: ref[k] for k in SLOT_KEYS + ("lost",)}
    if not np.array_equal(got["lost"][sel], r["lost"]):
        fail(f"silk_plc {mode} {what}: loss flags differ")
    held = r["kind"] != -2
    for k in SLOT_KEYS:
        g = got[k][sel]
        if not np.array_equal(g[held], r[k][held]):
            bad = np.argwhere((g != r[k]) & held)[:4].tolist()
            fail(f"silk_plc {mode} {what}: {k} differs at lane-slots {bad}: "
                 f"{[int(g[i, j]) for i, j in bad]} against "
                 f"{[int(r[k][i, j]) for i, j in bad]}")
    g16 = got["out16"][sel]
    if "digest" in ref:
        dg = slot_digests(g16)
        same = (dg == ref["digest"]).all(axis=2) | ~held
        if not same.all():
            fail(f"silk_plc {mode} {what}: int16 differs on lane-slots "
                 f"{np.argwhere(~same)[:4].tolist()}")
        e = 0
    else:
        d = np.abs(g16.astype(np.int64) - ref["out16"]) \
            * np.repeat(held, 960, axis=1)
        e = int(d.max())
        lim = 0 if mode == "silk" else CLASSIC_LSB
        if e > lim:
            i, j = np.unravel_index(np.argmax(d), g16.shape)
            fail(f"silk_plc {mode} {what}: int16 {e} LSB from the reference"
                 f" (bound {lim}) at lane {i} slot {j // 960}")
    kinds = got["kind"][sel]
    return e, {k: int((kinds == k).sum()) for k in range(6)}


def silk_plc_expected(events, mode: str) -> dict:
    """The K1 / K2 / K4 launches a run's ``events`` imply: a decode call
    one K4 a subframe (4), and in hybrid one K1 and one K2; a concealment
    call with a lane that had decoded a packet 8 K4 (the concealment's and
    the comfort noise's synthesis) and in hybrid one K2 (the CELT noise
    concealment's de-emphasis); an FEC call 4 K4 (plus 8 where a lane
    whose packet has no LBRR frame conceals) and in hybrid one K2."""
    k = dict(K1=0, K2=0, K4=0)
    hyb = mode == "hybrid"
    for ev in events:
        kinds = ev["kind"][ev["lanes"]]
        if ev["call"] == "decode":
            k["K4"] += 4
            k["K1"] += hyb
            k["K2"] += hyb
        elif ev["call"] == "conceal" and (kinds != 3).any():
            k["K4"] += 8
            k["K2"] += hyb
        elif ev["call"] == "fec":
            k["K4"] += 4 + 8 * bool((kinds == 1).any())
            k["K2"] += hyb
    return k


def silk_plc_inputs(sl_in, sfx):
    """The silk_plc phase's traffic, per mode: B_DNN lanes of the plain
    loop then B_DNN of -inbandfec on the same packets and flags (one
    decoder of 2 B_DNN lanes); the fixture's 8 streams tiled, the lanes
    SIM_FX carrying stream j under its fixture pattern, the others
    sim_loss's flags (lanes 0-511 BatchedLossGen, 512-1023 i.i.d. 10%)
    over SILK_PLC_TICKS.  ``cpu_lanes``: the fixture lanes and 48 others
    with a loss, whose CPU run the card is held to."""
    import numpy as np
    b, nf = B_DNN, SILK_PLC_TICKS
    base = sl_in["lost"][:, :nf]
    out = {}
    for mode in ("silk", "hybrid"):
        streams = silk_plc_packets(sfx, mode)
        packets = [streams[i % len(streams)] for i in range(b)]
        lost = base.copy()
        for j, lane in enumerate(SIM_FX):
            packets[lane] = streams[j]
            lost[lane] = sfx[f"{SILK_PLC_KEY[mode]}_lost"][j, :nf]
        out[mode] = dict(packets=packets + packets,
                         lost=np.concatenate([lost, lost]))
    others = [i for i in range(b) if i not in SIM_FX and base[i].any()]
    half = [i for i in others if i < SIM_LOSSGEN_LANES]
    rest = [i for i in others if i >= SIM_LOSSGEN_LANES]
    pick = half[::max(1, len(half) // 24)][:24] \
        + rest[::max(1, len(rest) // 24)][:24]
    out["cpu_lanes"] = np.asarray(sorted(list(SIM_FX) + pick))
    return out


def silk_plc_run(mode, packets, lost, device):
    """One mode's run: a BatchedLossDecoder of len(packets) lanes, the
    first half the plain loop, the second -inbandfec, through loss_run."""
    import numpy as np
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder
    b = len(packets)
    dec = BatchedLossDecoder(b, device=device, dred=False, mode=mode,
                             inbandfec=np.arange(b) >= b // 2)
    out = loss_run(dec, packets, lost)
    out["events"] = dec.events
    return out


def cpu_silk_plc(mode, packets, lost, lanes):
    """The silk_plc run of ``mode`` on the CPU over the lanes ``lanes`` of
    each half (plain, -inbandfec), in a worker process while the card
    runs."""
    t0 = time.time()
    b = len(packets) // 2
    sel = list(lanes) + [b + i for i in lanes]
    out = silk_plc_run(mode, [packets[i] for i in sel], lost[sel], "cpu")
    del out["events"]
    out["seconds"] = time.time() - t0
    return out


def phase_silk_plc(dev, sfx, inp, jobs):
    """opus_demo's loss loops over SILK-WB and FB hybrid streams as a user
    drives them on the card: per mode one BatchedLossDecoder of 2 x B_DNN
    lanes (the plain loop and -inbandfec on the same traffic) over
    SILK_PLC_TICKS ticks and flush(), the K1 / K2 / K4 counters reset just
    before and read just after; held to the CPU runs (``jobs``: futures
    of cpu_silk_plc, on ``cpu_lanes``) and to the JAX loops on the fixture
    lanes: slot kinds, final ranges and SILK loss counts equal, SILK int16
    equal, hybrid within CLASSIC_LSB."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir, lpc

    res = {}
    b = B_DNN
    lanes = inp["cpu_lanes"]
    for mode in ("silk", "hybrid"):
        t0 = time.time()
        torch.cuda.synchronize()
        CK.launches = iir.launches = lpc.launches = 0
        card = silk_plc_run(mode, inp[mode]["packets"], inp[mode]["lost"],
                            dev)
        torch.cuda.synchronize()
        counts = {"K1": CK.launches, "K2": iir.launches, "K4": lpc.launches}
        want = silk_plc_expected(card["events"], mode)
        if counts != want:
            fail(f"silk_plc {mode}: launches {counts}, expected {want}")
        if card["pending"].any():
            fail(f"silk_plc {mode}: samples pending after flush")
        card_s = time.time() - t0
        cpu = jobs[mode].result()
        sel = np.concatenate([lanes, b + lanes])
        e_cpu, _k = silk_plc_compare(card, cpu, mode, "card vs the CPU run",
                                     lanes=sel)
        e_jax = []
        for j, loop in enumerate(("plain", "fec")):
            e, _k = silk_plc_compare(card, silk_plc_fixture(
                sfx, mode, loop, SILK_PLC_TICKS), mode,
                f"{loop}: card vs the JAX loop",
                                     lanes=np.asarray(SIM_FX) + j * b)
            e_jax.append(e)
        k = card["kind"]
        by = {name: [int((k[h * b:(h + 1) * b] == v).sum()) for h in (0, 1)]
              for name, v in (("concealed", 1), ("LBRR", 4), ("DTX", 5),
                              ("zeros", 3))}
        print(f"silk_plc {mode} at B={b} plain + {b} -inbandfec over "
              f"{SILK_PLC_TICKS} ticks + flush: slots (plain, -inbandfec) "
              f"{by}; launches {counts}; card vs the CPU run on "
              f"{len(sel)} lanes: int16 within {e_cpu} LSB, kinds, ranges "
              f"and loss counts equal; fixture lanes vs JAX: int16 within "
              f"{e_jax} LSB; card ticks {1e3 * min(card['tick_s']):.1f}-"
              f"{1e3 * max(card['tick_s']):.1f} ms; card run {card_s:.1f} s; "
              f"the CPU run took {cpu['seconds']:.1f} s (worker process)")
        res[mode] = dict(counts=counts, e_cpu=e_cpu, e_jax=e_jax, by=by)
    return res


def silk_plc_times(dev, smi, inp):
    """CUDA event times (one call each; the decoders are warm) of a
    SILK-WB loss-loop tick at B_DNN (48 kHz out):
    with no lost lane; with every tenth lane's first loss (concealment and
    comfort noise); their second loss; and, in the -inbandfec loop, those
    lanes resuming through their packet's LBRR frame (the FEC call, then
    the decode).  Device operations and device time (device_profile): the
    no-loss tick traced whole; a loss tick is that tick's decode plus its
    one extra call (the concealment, or the FEC call), which alone is
    traced (the decode of a loss tick runs the same operations over its
    masked lanes; a tick traced whole costs ~35 s of profiler host time)."""
    import numpy as np
    import torch
    from opus_tpu_torch.tools.device_time import device_profile
    from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder, mode_frame

    b = B_DNN
    pk = inp["silk"]["packets"][:b]
    none = np.zeros(b, bool)
    some = np.zeros(b, bool)
    some[::10] = True
    decs = {fec: BatchedLossDecoder(b, device=dev, dred=False, mode="silk",
                                    inbandfec=fec) for fec in (False, True)}

    def snap(d):
        s = d.decoder
        return (s.state, s.rs, s.smid, s._rng, d._pending.copy(), d._rng)

    def restore(d, v):
        s = d.decoder
        s.state, s.rs, s.smid, s._rng, p, d._rng = v
        d._pending = p.copy()
        d.events = []
    for d in decs.values():
        for f in range(3):
            d.tick([p[f] for p in pk], none)
    s0 = snap(decs[False])
    decs[False].tick([p[3] for p in pk], some)
    s1 = snap(decs[False])
    decs[True].tick([p[3] for p in pk], some)
    sf = snap(decs[True])
    mt = torch.as_tensor(some, device=dev)
    buf4, lens4 = decs[True].decoder.pack([mode_frame(p[4], "silk")
                                           for p in pk])
    out = {}
    base = None
    for name, d, state, frame, flags, extra in (
            ("no lost lane", decs[False], s0, 3, none, None),
            (f"{int(some.sum())} lanes' first loss", decs[False], s0, 3,
             some, lambda d: d.decoder.conceal(mt)),
            ("their second loss", decs[False], s1, 4, some,
             lambda d: d.decoder.conceal(mt)),
            ("their resume through LBRR (-inbandfec)", decs[True], sf, 4,
             none, lambda d: d.decoder.decode_packed(buf4, lens4, active=mt,
                                                     fec=mt))):
        def setup(d=d, state=state):
            restore(d, state)

        def call(d=d, frame=frame, flags=flags):
            d.tick([p[frame] for p in pk], flags)
        setup()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        if extra is None:
            ops, dms = device_profile(lambda: (setup(), call()), reps=1,
                                      warmup=False)
            base = (ops, dms)
            how = "traced whole"
        else:
            xo, xd = device_profile(lambda: (setup(), extra(d)), reps=1,
                                    warmup=False)
            ops, dms = base[0] + xo, base[1] + xd
            how = f"its extra call {xo:.0f} operations, {xd:.3f} ms device"
        out[name] = (ms, ops, dms)
        print(f"silk_plc times [{smi}]: a SILK-WB tick at B={b}, {name}: "
              f"{ms:.3f} ms a call ({b * 20 / ms:.0f} realtime streams), "
              f"{ops:.0f} device operations, {dms:.3f} ms device (busy "
              f"{100 * dms / ms:.1f}%; {how})")
    return out


API_FIXTURE = os.path.join(REPO, "tests", "data", "torch_opus_api.npz")
API_TICKS = 12          # of the fixture streams' 20-27 packets
API_TIME_TICKS = 4      # of those, timed alone: 3 with CUDA events, 1 traced
API_FX = tuple(range(8))    # lanes carrying the fixture streams from packet 0
API_CPU_EXTRA = 48      # other lanes the card is held to the CPU run on
API_LOSS_SEED = 1600
API_OFFSET = 6          # the packet every other group of 8 lanes starts at
API_FEC_EVERY = 4       # every 4th lane past the fixture's recovers by FEC
API_CLIP_LANES = 256    # loud lanes the soft clip is held to the scalar on


def api_streams(afx):
    """The fixture's 8 streams: packets (bytes, or None where lost)."""
    plen, buf = afx["plen"], afx["packets"]
    return [[None if plen[s, t] == -1 else bytes(buf[s, t, :plen[s, t]])
             for t in range(plen.shape[1]) if plen[s, t] != -2]
            for s in range(plen.shape[0])]


def opus_api_inputs(dev, afx, b=B_DNN, nt=API_TICKS, offset=API_OFFSET,
                    extra=API_CPU_EXTRA):
    """b (B_DNN) lanes of mixed traffic over nt (API_TICKS) ticks: lane i
    carries stream i % 8, from packet 0 or, in every other group of 8
    lanes, from packet ``offset`` (API_OFFSET), so that each tick mixes
    CELT, SILK and hybrid lanes at two points of each stream, some in
    mid-transition (offset 0: every lane from packet 0); lanes API_FX under the
    fixture's own losses, the others losing a packet also where
    ``tools/loss.py``'s ``-loss 10`` flags (each lane its own seed, on the
    card) say so, so that their states part.  Every API_FEC_EVERY-th lane
    recovers a lost packet from the next one where that one has arrived,
    as a jitter buffer does: the tick decodes the next packet with
    ``decode_fec`` over the lost packet's duration (the default where the
    fixture lost it), and the next tick decodes it.  (More offsets put
    more (rate, 10/20 ms) groups in a tick, each a SILK symbol pass of
    ~1 s of host: 8 offsets took 9.8-13.4 s a tick on an NVIDIA H100
    80GB HBM3 at 700 W.)  ``cpu_lanes``: the fixture lanes and ``extra``
    (API_CPU_EXTRA) others.  ``size`` is in 48 kHz samples."""
    import numpy as np
    from opus_tpu_torch.bitstream.packet import packet_get_nb_samples
    from opus_tpu_torch.tools.loss import loss_flags
    streams = api_streams(afx)
    lost = loss_flags(nt, API_LOSS_SEED + np.arange(b),
                      loss_perc=SIM_LOSS_PERC, device=dev).cpu().numpy()
    packets = []
    fec = np.zeros((b, nt), bool)
    size = np.zeros((b, nt), np.int64)
    for i in range(b):
        st = streams[i % len(streams)]
        off = offset * ((i // len(streams)) % 2)
        sent = [st[(off + t) % len(st)] for t in range(nt)]
        row = list(sent)
        if i not in API_FX:
            row = [None if lost[i, t] else p for t, p in enumerate(row)]
            if i % API_FEC_EVERY == API_FEC_EVERY - 1:
                for t in range(nt - 1):
                    if row[t] is None and row[t + 1] is not None:
                        row[t], fec[i, t] = row[t + 1], True
                        if sent[t] is not None:
                            size[i, t] = packet_get_nb_samples(sent[t],
                                                               48000)
        packets.append(row)
    others = [i for i in range(b) if i not in API_FX]
    pick = others[::len(others) // extra][:extra]
    cpu_lanes = np.asarray(sorted(list(API_FX) + pick))
    if not fec[cpu_lanes].any() or not (cpu_lanes // 8 % 2).any():
        fail("opus_api: the CPU lanes hold no FEC call or no offset lane")
    return dict(packets=packets, fec=fec, size=size,
                lost_share=float(np.mean(
                    [p is None for row in packets for p in row])),
                fec_share=float(fec.mean()), cpu_lanes=cpu_lanes)


def opus_api_run(packets, device, keep=None, timed=False, fec=None,
                 size=None, channels=1, trace_last=False, fs=48000):
    """``BatchedOpusDecoder(fs=..., channels=...)`` over len(packets)
    lanes, one call a tick (``fec`` / ``size`` [B, T]: the lanes'
    ``decode_fec`` and ``frame_size`` at fs), and the int16 of
    ``decode_int16`` (the soft clip with each lane's and channel's
    memory).  Per tick and kept lane (``keep``, default all): float PCM
    ([L, W], or [L, W, 2] at two channels), int16, decode24's int32
    (below 48 kHz), sample count, final range, celt_used; the decoder's
    events and flags;
    with timed=True each tick's CUDA event time; with trace_last=True the
    last tick traced instead (``trace``: its device operations and device
    ms; its time is left out of tick_ms, the profiler's host cost in it)."""
    import numpy as np
    import torch
    from opus_tpu_torch.models.opus_decoder import (BatchedOpusDecoder,
                                                    to_int24)
    b = len(packets)
    keep = np.arange(b) if keep is None else np.asarray(keep)
    dec = BatchedOpusDecoder(b, fs=fs, channels=channels, device=device)
    out = dict(pcm=[], pcm16=[], pcm24=[], n=[], rng=[], celt=[],
               tick_ms=[])
    nt = len(packets[0])
    for t in range(nt):
        args = ([row[t] for row in packets],
                None if fec is None else fec[:, t],
                None if size is None else size[:, t])
        if trace_last and t == nt - 1:
            from opus_tpu_torch.tools.device_time import device_profile
            got = {}

            def tick():
                got["r"] = dec.decode(*args)
                got["c"] = dec.soft_clip_int16(*got["r"])
            out["trace"] = device_profile(tick, reps=1, warmup=False)
            (pcm, n), (pcm16, _n) = got["r"], got["c"]
        else:
            if timed:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            pcm, n = dec.decode(*args)
            pcm16, _n = dec.soft_clip_int16(pcm, n)
        if timed and not (trace_last and t == nt - 1):
            e1.record()
            torch.cuda.synchronize()
            out["tick_ms"].append(e0.elapsed_time(e1))
        k = torch.as_tensor(keep, device=pcm.device)
        out["pcm"].append(pcm.index_select(0, k).cpu().numpy())
        out["pcm16"].append(pcm16.index_select(0, k).cpu().numpy())
        if fs != 48000:
            out["pcm24"].append(to_int24(pcm.index_select(0, k)).cpu()
                                .numpy())
        out["n"].append(n[keep])
        out["rng"].append(dec.final_range.index_select(0, k).cpu().numpy())
        out["celt"].append(dec.celt_used[keep])
    out.update(events=dict(dec.events), flagged=dec.flagged[keep],
               decoder=dec)
    return out


def cpu_opus_api(packets, fec, size, lanes, channels=1, fs=48000):
    """The opus_api (or opus_stereo, or opus_rates) run on the CPU over
    ``lanes``, in a worker process while the card runs."""
    t0 = time.time()
    out = opus_api_run([packets[i] for i in lanes], "cpu", fec=fec[lanes],
                       size=size[lanes], channels=channels, fs=fs)
    del out["decoder"]
    out["seconds"] = time.time() - t0
    return out


def api_compare(got, ref, what, gl=None, rl=None, silk_exact=None):
    """Per tick and lane (got's rows gl, ref's rows rl): sample counts and
    final ranges equal; int16 equal where ``silk_exact`` [T, L] holds (no
    CELT contribution); elsewhere float PCM within PCM_ABS_TOL, or, on a
    concealed packet (``concealed`` [T, L]), int16 within CLASSIC_LSB; a
    row whose check is "skip" (a fixture stream past its end) is not
    compared.  Returns (max float err, max int16 err) over the checked
    packets."""
    import numpy as np
    e_f, e_i = 0.0, 0
    for t in range(len(ref["n"])):
        ga = slice(None) if gl is None else gl
        ra = slice(None) if rl is None else rl
        on = np.asarray([k != "skip" for k in ref["kind"][t]])
        n_g, n_r = got["n"][t][ga], ref["n"][t][ra]
        if not np.array_equal(n_g[on], n_r[on]):
            fail(f"opus_api {what}: tick {t}: sample counts differ")
        rg, rr = got["rng"][t][ga], ref["rng"][t][ra]
        if not np.array_equal(rg[on], rr[on]):
            bad = np.nonzero((rg != rr) & on)[0]
            fail(f"opus_api {what}: tick {t}: final ranges differ on "
                 f"rows {bad[:8].tolist()}")
        pg, pr = got["pcm"][t][ga], ref["pcm"][t][ra]
        ig, ir = got["pcm16"][t][ga], ref["pcm16"][t][ra]
        for j in range(len(n_r)):
            m = int(n_r[j])
            di = int(np.abs(ig[j, :m].astype(np.int64)
                            - ir[j, :m].astype(np.int64)).max(initial=0))
            df = float(np.abs(pg[j, :m] - pr[j, :m]).max(initial=0.0))
            kind = ref["kind"][t][j]
            if kind == "silk" and di != 0:
                fail(f"opus_api {what}: tick {t} row {j}: SILK int16 "
                     f"differs by {di} LSB")
            if kind == "concealed" and di > CLASSIC_LSB:
                fail(f"opus_api {what}: tick {t} row {j}: concealed int16 "
                     f"{di} LSB > {CLASSIC_LSB}")
            if kind == "celt" and not df <= PCM_ABS_TOL:
                fail(f"opus_api {what}: tick {t} row {j}: PCM err {df}")
            e_f = max(e_f, df if kind == "celt" else 0.0)
            e_i = max(e_i, di)
    return e_f, e_i


def api_kinds(run, packets_rows, fec_rows):
    """Each tick and row's check: "concealed" (a lost packet, or an FEC
    call the CELT decoder took part in: its concealment), "silk" (no CELT
    contribution: int16 exact), or "celt" (float PCM within
    PCM_ABS_TOL)."""
    return [["concealed" if packets_rows[j][t] is None
             or (fec_rows[j, t] and run["celt"][t][j])
             else ("celt" if run["celt"][t][j] else "silk")
             for j in range(len(packets_rows))]
            for t in range(len(run["n"]))]


def api_fixture_ref(afx, ticks: int):
    """The JAX scalar decoder's outputs on the fixture lanes (the stored
    float PCM, its int16 through the port's copy of the soft clip, one
    memory a stream), per tick, with each packet's check: SILK int16
    exact where the scalar CELT decoder did not run during it."""
    import numpy as np
    from opus_tpu_torch.utils.soft_clip import float2int16, pcm_soft_clip
    s_n = afx["plen"].shape[0]
    mem = np.zeros(s_n, np.float32)
    out = dict(pcm=[], pcm16=[], n=[], rng=[], kind=[])
    w = int(afx["nsamp"].max())
    for t in range(ticks):
        pcm = np.zeros((s_n, w), np.float32)
        pcm16 = np.zeros((s_n, w), np.int16)
        kinds = []
        for s in range(s_n):
            n = int(afx["nsamp"][s, t])
            o = int(afx["pcm_off"][s, t])
            x = afx["pcm"][o:o + n].astype(np.float32).copy()
            pcm[s, :n] = x
            m = mem[s:s + 1]
            pcm_soft_clip(x, 1, m)
            pcm16[s, :n] = float2int16(x)
            lost = afx["plen"][s, t] == -1
            kinds.append("concealed" if lost else (
                "silk" if afx["celt_calls"][s, t] == 0 else "celt"))
        out["pcm"].append(pcm)
        out["pcm16"].append(pcm16)
        out["n"].append(afx["nsamp"][:, t].copy())
        out["rng"].append(afx["rng"][:, t].copy())
        out["kind"].append(kinds)
    return out


def soft_clip_inputs(rng, b: int, w: int):
    """b lanes of w samples that reach each branch of the soft clip: loud
    noise, slow sines (segments across the frame boundary: the carried
    curve, a segment that starts the frame and its ramp), sparse spikes
    among zeros, values on a 0.25 grid (exact zeros, +-1, tied peaks),
    constant runs and the clamp at +-2."""
    import numpy as np
    t = np.arange(w)
    rows = []
    for i in range(b):
        k = i % 6
        if k == 0:
            x = rng.standard_normal(w) * rng.uniform(0.3, 3.0)
        elif k == 1:
            x = rng.uniform(0.9, 2.5) * np.sin(
                2 * np.pi * t / rng.uniform(60, 900) + rng.uniform(0, 6.3))
        elif k == 2:
            x = np.where(rng.random(w) < 0.05,
                         rng.standard_normal(w) * 2, 0.0)
        elif k == 3:
            x = np.round(rng.standard_normal(w) * 4) / 4
        elif k == 4:
            x = np.full(w, rng.choice([-1.5, 1.25, 0.5, 2.5]))
            x[:int(rng.integers(0, 4))] = 0.0
        else:
            x = np.clip(rng.standard_normal(w) * 3, -2.5, 2.5)
        rows.append(x)
    return np.asarray(rows, np.float32)


def k1_short_lanes(captured, rng):
    """K1's inputs captured on the card (per (lm, start, end): rows of
    (buf, lens, old_e, prevmin, seed) and, from the stereo instantiation,
    the coder state d0 or None): their rows tiled to B_MAIN lanes plus
    N_BAD garbage lanes (half the captured packets truncated, half random
    bytes), as (tabs, args, d0) with d0 None for mono rows and, for
    stereo rows, a coder state on every lane (a coder started on its
    packet where none was given); and the LM 0/1 start-0 bytes again at
    start 17 (a hybrid range at LM 0/1, which no decoder path reaches)."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import rc_kernel as K
    cases = {}
    for key, rows in captured.items():
        p = max(r[0].shape[1] for r in rows)
        buf = torch.cat([torch.nn.functional.pad(r[0], (0, p - r[0].shape[1]))
                         for r in rows])
        lens, old_e, pm, seed = (torch.cat([r[i] for r in rows])
                                 for i in range(1, 5))
        d0 = None
        if len(rows[0]) > 5:
            d0s = [r[5] if r[5] is not None else K.rk_init(
                r[0], r[1].clamp(0, r[0].shape[1])) for r in rows]
            d0 = {k: torch.cat([d[k] for d in d0s]) for k in d0s[0]}
        reps = -(-B_MAIN // buf.shape[0])

        def tile(x):
            return x.repeat((reps,) + (1,) * (x.dim() - 1))[:B_MAIN]
        t = [tile(x) for x in (buf, lens, old_e, pm, seed)]
        bad_buf = torch.zeros((N_BAD, p), dtype=torch.uint8,
                              device=buf.device)
        bad_len = torch.zeros(N_BAD, dtype=torch.int64, device=buf.device)
        for j in range(N_BAD):
            src = j % buf.shape[0]
            if j < N_BAD // 2:
                cut = int(rng.integers(0, int(lens[src]) + 1))
                bad_buf[j, :cut] = buf[src, :cut]
            else:
                cut = int(rng.integers(0, p + 1))
                bad_buf[j, :cut] = torch.as_tensor(
                    rng.integers(0, 256, cut), dtype=torch.uint8)
            bad_len[j] = cut
        args = (torch.cat([t[0], bad_buf]), torch.cat([t[1], bad_len]),
                torch.cat([t[2], t[2][:N_BAD]]),
                torch.cat([t[3], t[3][:N_BAD]]),
                torch.cat([t[4], t[4][:N_BAD]]))
        if d0 is not None:
            d0 = {k: torch.cat([tile(v), tile(v)[:N_BAD]])
                  for k, v in d0.items()}
        lm, start, end = key
        cases[key] = (CK.dec_tabs(48000, 120 << lm, start, end), args, d0)
        if start == 0 and lm <= 1:
            k17 = (lm, 17, 21)
            cases.setdefault(k17, (CK.dec_tabs(48000, 120 << lm, 17, 21),
                                   args, d0))
    return cases


def opus_api_card(dev, inp) -> dict:
    """The port's top-level decoder as a user drives it on the card (the
    second process runs this while the first runs the loss phases):
    ``BatchedOpusDecoder`` over B_DNN lanes of mixed traffic for
    API_TICKS calls, the K1 / K2 / K4 counters reset just before and read
    just after; the kept lanes' outputs for ``phase_opus_api``'s checks.
    Then (a): K1 at LM 0/1 against its plain version on the LM 0/1 inputs
    the run gave it (2.5 and 5 ms CELT frames, the redundant frames, the
    2.5 ms fade frames), tiled to B_MAIN lanes with N_BAD garbage lanes,
    and the same bytes at start 17; (b) the soft clip on loud lanes
    against its scalar copy.  Returns numpy and CPU tensors only."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir, lpc

    t0 = time.time()
    captured = {}
    orig = CK.decode_frame

    def spy(buf, lens, old_e, prevmin, seed, tabs=None, d0=None):
        if tabs.lm <= 1 and d0 is None:
            captured.setdefault((tabs.lm, tabs.start, tabs.end_band),
                                []).append(tuple(
                                    x.clone() for x in (buf, lens, old_e,
                                                        prevmin, seed)))
        return orig(buf, lens, old_e, prevmin, seed, tabs, d0)
    CK.decode_frame = spy
    try:
        torch.cuda.synchronize()
        CK.launches = iir.launches = lpc.launches = 0
        card = opus_api_run(inp["packets"], dev, keep=inp["cpu_lanes"],
                            fec=inp["fec"], size=inp["size"])
        torch.cuda.synchronize()
        counts = {"K1": CK.launches, "K2": iir.launches, "K4": lpc.launches}
    finally:
        CK.decode_frame = orig
    del card["decoder"]
    card_s = time.time() - t0
    for k, v in counts.items():
        if v == 0:
            fail(f"opus_api: kernel {k} launched no time")
    if card["flagged"].any():
        fail(f"opus_api: lanes flagged: "
             f"{np.nonzero(card['flagged'])[0].tolist()}")

    # (a) K1 at LM 0/1 against its plain version
    cases = k1_short_lanes(captured, np.random.default_rng(25))
    x_err, n_short = 0.0, {}
    for key, (tabs, args, _d0) in sorted(cases.items()):
        got = CK._decode_frame_cuda(*args, tabs)
        ref_k = CK.decode_frame_plain(*args, tabs)
        xe, _ee = compare_k1(got, ref_k, tabs)
        x_err = max(x_err, xe)
        n_short[key] = int(args[0].shape[0])
    if not any(k[0] == 0 for k in cases) or not any(k[0] == 1
                                                     for k in cases):
        fail(f"opus_api: K1 saw no LM 0 or no LM 1 frame: {sorted(cases)}")
    key1 = max(k for k in cases if k[0] == 1 and k[1] == 0)

    # (b) the soft clip on loud lanes against its scalar copy
    from opus_tpu_torch.utils.soft_clip import pcm_soft_clip, soft_clip_lanes
    rng = np.random.default_rng(26)
    mem = torch.zeros(API_CLIP_LANES, dtype=torch.float32, device=dev)
    ref_mem = np.zeros((API_CLIP_LANES, 1), np.float32)
    for call in range(3):
        x = soft_clip_inputs(rng, API_CLIP_LANES, 960)
        got, mem = soft_clip_lanes(torch.from_numpy(x).to(dev), mem)
        got = got.cpu().numpy()
        for i in range(API_CLIP_LANES):
            y = x[i].copy()
            pcm_soft_clip(y, 1, ref_mem[i])
            if not np.array_equal(got[i], y):
                fail(f"opus_api: soft clip call {call} lane {i} differs "
                     f"from the scalar")
        if not np.array_equal(mem.cpu().numpy(), ref_mem[:, 0]):
            fail(f"opus_api: soft clip memory differs on call {call}")
    return dict(card=card, counts=counts, card_s=card_s, x_err=x_err,
                n_short=n_short, k1_key=key1,
                k1_args=to_cpu(cases[key1][1]))


def phase_opus_api(dev, afx, inp, job, cr):
    """The checks of ``opus_api_card``'s run (``cr``): held to the CPU run
    (``job``: a future of cpu_opus_api on ``cpu_lanes``) and, on the
    fixture lanes, to the JAX scalar decoder's stored outputs.  Then its
    timing, alone on the card: a fresh decoder over the traffic's first
    API_TIME_TICKS ticks, CUDA events around each but the last, which is
    traced."""
    import numpy as np
    from opus_tpu_torch.models import celt_dec_kernel as CK

    card, counts = cr["card"], cr["counts"]
    lanes = inp["cpu_lanes"]
    rows = [inp["packets"][i] for i in lanes]
    cpu = job.result()
    cpu["kind"] = api_kinds(cpu, rows, inp["fec"][lanes])
    card_kind = api_kinds(card, rows, inp["fec"][lanes])
    if card_kind != cpu["kind"]:
        t, j = next((t, j) for t in range(len(card_kind))
                    for j in range(len(rows))
                    if card_kind[t][j] != cpu["kind"][t][j])
        fail(f"opus_api: tick {t} lane {int(lanes[j])}: the card's CELT "
             f"use ({card_kind[t][j]}) differs from the CPU run's "
             f"({cpu['kind'][t][j]})")
    e_cpu = api_compare(card, cpu, "card vs the CPU run")
    ref = api_fixture_ref(afx, API_TICKS)
    fx_rows = [int(np.nonzero(lanes == i)[0][0]) for i in API_FX]
    e_jax = api_compare(card, ref, "fixture lanes: card vs JAX", gl=fx_rows)
    ev = card["events"]
    if not ev.get("fec_frames"):
        fail("opus_api: no lane decoded an in-band FEC frame")
    nt = API_TIME_TICKS
    timing = opus_api_run([row[:nt] for row in inp["packets"]], dev,
                          keep=np.zeros(0, np.int64), timed=True,
                          fec=inp["fec"][:, :nt], size=inp["size"][:, :nt],
                          trace_last=True)
    print(f"opus_api at B={B_DNN} over {API_TICKS} ticks (lanes at packet "
          f"offsets 0 and {API_OFFSET}; {100 * inp['lost_share']:.1f}% of "
          f"packets lost, {100 * inp['fec_share']:.1f}% of calls in-band "
          f"FEC): launches {counts}; frames {ev}; card vs the "
          f"CPU run on {len(lanes)} lanes: ranges equal, PCM within "
          f"{e_cpu[0]:.3g}, int16 within {e_cpu[1]} LSB (SILK-only "
          f"exact); fixture lanes vs JAX: ranges equal, PCM within "
          f"{e_jax[0]:.3g}, int16 within {e_jax[1]} LSB; card run "
          f"{cr['card_s']:.1f} s (the second process), the CPU run "
          f"{cpu['seconds']:.1f} s (worker process); K1 at LM 0/1 vs plain "
          f"(integers exact, X within {cr['x_err']:.3g}) on "
          f"{ {str(k): v for k, v in cr['n_short'].items()} } lanes; the "
          f"soft clip on {API_CLIP_LANES} loud lanes x 3 calls bit for bit "
          f"with the scalar")
    lm, start, end = cr["k1_key"]
    k1_case = (CK.dec_tabs(48000, 120 << lm, start, end),
               to_device(cr["k1_args"], dev), None)
    return dict(counts=counts, x_err=cr["x_err"], e_cpu=e_cpu, e_jax=e_jax,
                events=ev, tick_ms=timing["tick_ms"], trace=timing["trace"],
                k1_case=k1_case)


def opus_api_times(dev, smi, api):
    """The opus_api timing run's ticks at B_DNN (CUDA events) and its last
    tick traced (device operations and time; the busy share over the
    median tick); K1 at LM 1 (the 5 ms frames and redundant frames) at B_MAIN +
    N_BAD lanes: its time, its plain version's and its bound; the soft
    clip on loud lanes."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.utils.soft_clip import soft_clip_lanes

    ms = float(np.median(api["tick_ms"]))
    ops, dms = api["trace"]
    tabs, args, _d0 = api["k1_case"]
    k1 = cuda_ms(lambda: CK._decode_frame_cuda(*args, tabs), 20)
    k1p = cuda_ms(lambda: CK.decode_frame_plain(*args, tabs), 1)
    out = CK._decode_frame_cuda(*args, tabs)
    bnd = k1_bound(tabs, args, out)
    b = args[0].shape[0]
    loud = torch.from_numpy(soft_clip_inputs(np.random.default_rng(27),
                                             B_DNN, 960)).to(dev)
    mem = torch.zeros(B_DNN, dtype=torch.float32, device=dev)
    clip = cuda_ms(lambda: soft_clip_lanes(loud, mem), 5)
    print(f"opus_api times [{smi}]: ticks at B={B_DNN} "
          f"{', '.join(f'{v:.0f}' for v in api['tick_ms'])} ms (median "
          f"{ms:.1f}); the last tick traced: {ops:.0f} device operations, "
          f"{dms:.2f} ms device (busy {100 * dms / ms:.1f}% of the median "
          f"tick); K1 at LM 1 (start 0, end {tabs.end_band}) at B={b}: "
          f"{k1:.4f} ms, plain {k1p:.2f} ms, bound {bnd[0]:.6f} ms "
          f"({bnd[1]}); the soft clip on {B_DNN} loud lanes x 960 "
          f"{clip:.3f} ms")
    return dict(tick_ms=ms, ops=ops, dev_ms=dms, k1_lm1=k1, k1_lm1p=k1p,
                k1_lm1_bound=bnd, soft_clip_ms=clip)


STEREO_FIXTURE = os.path.join(REPO, "tests", "data", "torch_opus_stereo.npz")
STEREO_TICKS = 4        # of the fixture streams' 7-21 steps: 3 timed, 1 traced
STEREO_MONO_TICKS = 1   # of those, the one-channel decoder's
# the step each fixture stream starts at in every other group of 8 lanes,
# so that the ticks hold 8 kHz SILK at 60 ms, 16 kHz mono SILK at 60 ms,
# CELT stereo at LM 0 and 1, stereo SILK at 40 and 60 ms, the hybrid at 10
# ms and the switch from stereo to mono SILK (steps 4-9); the groups from
# step 0 hold the rest (LM 2-3 CELT, mono CELT, the stereo SILK
# concealment)
STEREO_OFFSETS = (4, 3, 4, 6, 5, 6, 4, 6)
STEREO_CPU_EXTRA = 24   # other lanes the card is held to the CPU run on
STEREO_MONO_LANES = 256     # the one-channel decoder's lanes
# the two-channel run's events, as tests/test_torch_opus_stereo.py's over
# the whole fixture, and the stereo SILK concealment
STEREO_EVENTS = ("celt_lm0_start0_stereo", "celt_lm1_start0_stereo",
                 "celt_lm2_start0_stereo", "celt_lm3_start0_stereo",
                 "celt_lm3_start17_stereo", "silk_16k_60ms_stereo",
                 "silk_16k_40ms_stereo", "silk_8k_40ms", "silk_8k_60ms",
                 "silk_12k_60ms", "silk_16k_60ms", "celt_lm3_start0",
                 "silk_stereo_to_mono", "fec_frames",
                 "silk_conceal_16k_20ms_stereo")
# the one-channel run's: the downmix of stereo CELT and stereo SILK
STEREO_MONO_EVENTS = ("celt_lm3_start0_stereo", "silk_16k_20ms_stereo",
                      "celt_lm3_start17_stereo")


def stereo_steps(sfx):
    """The fixture's 8 streams: steps (packet or None, fec, frame_size)."""
    plen, buf = sfx["plen"], sfx["packets"]
    return [[(None if plen[s, t] == -1 else bytes(buf[s, t, :plen[s, t]]),
              bool(sfx["fec"][s, t]), int(sfx["fsize"][s, t]))
             for t in range(plen.shape[1]) if plen[s, t] != -2]
            for s in range(plen.shape[0])]


def stereo_ticks(c: int) -> int:
    """The opus_stereo run's calls at c output channels."""
    return STEREO_TICKS if c == 2 else STEREO_MONO_TICKS


def opus_stereo_inputs(sfx, b: int, offsets=STEREO_OFFSETS):
    """b lanes over STEREO_TICKS: lane i carries stream i % 8 from step 0
    or, in every other group of 8 lanes, from its ``offsets`` step (a
    stream's steps wrap), with the fixture's losses and in-band FEC calls;
    ``cpu_lanes``: the fixture lanes and STEREO_CPU_EXTRA others.
    ``size`` is in 48 kHz samples."""
    import numpy as np
    streams = stereo_steps(sfx)
    nt = STEREO_TICKS
    packets = []
    fec = np.zeros((b, nt), bool)
    size = np.zeros((b, nt), np.int64)
    for i in range(b):
        st = streams[i % len(streams)]
        off = offsets[i % len(streams)] * ((i // len(streams)) % 2)
        row = [st[(off + t) % len(st)] for t in range(nt)]
        packets.append([p for p, _f, _z in row])
        fec[i] = [f for _p, f, _z in row]
        size[i] = [z for _p, _f, z in row]
    others = list(range(8, b))
    pick = others[::max(1, len(others) // STEREO_CPU_EXTRA)][
        :STEREO_CPU_EXTRA]
    return dict(packets=packets, fec=fec, size=size,
                cpu_lanes=np.asarray(sorted(list(range(8)) + pick)))


def stereo_fixture_ref(sfx, ticks: int, c: int):
    """The JAX scalar decoder's outputs at c output channels on the
    fixture lanes (stored float PCM, its int16 through the port's copy of
    the soft clip, per channel), per tick, with each step's check."""
    import numpy as np
    from opus_tpu_torch.utils.soft_clip import float2int16, pcm_soft_clip
    s_n = sfx["plen"].shape[0]
    mem = np.zeros((s_n, c), np.float32)
    out = dict(pcm=[], pcm16=[], n=[], rng=[], kind=[])
    w = int(sfx[f"nsamp{c}"].max())
    for t in range(ticks):
        pcm = np.zeros((s_n, w, c), np.float32)
        pcm16 = np.zeros((s_n, w, c), np.int16)
        kinds = []
        for s in range(s_n):
            n = int(sfx[f"nsamp{c}"][s, t])
            o = int(sfx[f"off{c}"][s, t])
            x = sfx[f"pcm{c}"][o:o + n * c].astype(np.float32).copy()
            pcm[s, :n] = x.reshape(n, c)
            pcm_soft_clip(x, c, mem[s])
            pcm16[s, :n] = float2int16(x).reshape(n, c)
            celt = sfx[f"celt{c}"][s, t]
            lossy = sfx["plen"][s, t] == -1 or sfx["fec"][s, t]
            kinds.append("skip" if sfx["plen"][s, t] == -2 else (
                "silk" if celt == 0 else (
                    "concealed" if lossy else "celt")))
        out["pcm"].append(pcm if c == 2 else pcm[:, :, 0])
        out["pcm16"].append(pcm16 if c == 2 else pcm16[:, :, 0])
        out["n"].append(sfx[f"nsamp{c}"][:, t].copy())
        out["rng"].append(sfx[f"rng{c}"][:, t].copy())
        out["kind"].append(kinds)
    return out


def stereo_kinds(run, packets_rows, fec_rows):
    """Each tick and row's check, as api_kinds, but a step whose output no
    CELT frame touched is SILK's whatever it was."""
    return [["silk" if not run["celt"][t][j] else (
        "concealed" if packets_rows[j][t] is None or fec_rows[j, t]
        else "celt") for j in range(len(packets_rows))]
        for t in range(len(run["n"]))]


def cpu_k1_stereo(key, args, d0, invs):
    """K1 stereo's plain version on the CPU, in a worker process while the
    card runs: the case ``key`` (lm, start, end) on ``args`` and ``d0``
    (CPU tensors), once for each disable_inv of ``invs``."""
    from opus_tpu_torch.models import celt_dec_kernel as CK
    lm, start, end = key
    tabs = CK.dec_tabs(48000, 120 << lm, start, end)
    return {inv: CK.decode_frame2_plain(*args, tabs, d0, inv)
            for inv in invs}


def stereo_card_run(dev, inp, c: int) -> dict:
    """opus_stereo's decoder at c output channels on the card: over
    B_DNN lanes for STEREO_TICKS calls, the first timed and the last
    traced, at two channels; over STEREO_MONO_LANES for
    STEREO_MONO_TICKS, untimed (the second process runs it), at one.
    Returns the run (numpy), the K1 mono and stereo, K2 and K4 counters
    reset just before it and read just after, and its seconds."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir, lpc

    lanes_n = B_DNN if c == 2 else STEREO_MONO_LANES
    nt = stereo_ticks(c)
    keep = inp["cpu_lanes"][inp["cpu_lanes"] < lanes_n]
    torch.cuda.synchronize()
    CK.launches = CK.launches_stereo = iir.launches = lpc.launches = 0
    t0 = time.time()
    run = opus_api_run([row[:nt] for row in inp["packets"][:lanes_n]], dev,
                       keep=keep, timed=c == 2,
                       fec=inp["fec"][:lanes_n, :nt],
                       size=inp["size"][:lanes_n, :nt], channels=c,
                       trace_last=c == 2)
    torch.cuda.synchronize()
    del run["decoder"]
    return dict(run=run, seconds=time.time() - t0,
                counts={"K1": CK.launches, "K1 stereo": CK.launches_stereo,
                        "K2": iir.launches, "K4": lpc.launches})


def phase_opus_stereo(dev, sfx, inp, jobs, pool, one):
    """Stereo and 40/60 ms SILK through the top-level decoder on the card:
    ``BatchedOpusDecoder(channels=2)`` over B_DNN lanes of the stereo
    fixture's streams for STEREO_TICKS calls (the first ones timed, the
    last traced), the K1 (mono and stereo instantiations), K2 and K4
    counters reset just before and read just after, held to the CPU run
    (``jobs[2]``) and on the fixture lanes to the JAX scalar decoder's
    stored outputs, with STEREO_EVENTS among its events; ``channels=1``
    over STEREO_MONO_LANES of the same traffic (the downmix and
    disable_inv paths; ``one``, the second process's ``stereo_card_run``),
    held the same way (``jobs[1]``).  Then (a): K1's
    stereo instantiation against its plain version on the inputs the
    two-channel run gave it, one band range a (LM, start), tiled to B_MAIN
    lanes with N_BAD garbage lanes, with disable_inv 0 and 1: the plain
    version runs in the CPU workers of ``pool`` while the card runs,
    except on the 20 ms start-0 case, which the card runs twice (the
    reference, then its timed call)."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK

    captured = {}
    orig = CK.decode_frame2

    def spy(buf, lens, old_e, prevmin, seed, tabs, d0=None,
            disable_inv=False):
        captured.setdefault((tabs.lm, tabs.start, tabs.end_band), []).append(
            tuple(x.clone() for x in (buf, lens, old_e, prevmin, seed))
            + (None if d0 is None else {k: v.clone()
                                        for k, v in d0.items()},))
        return orig(buf, lens, old_e, prevmin, seed, tabs, d0, disable_inv)

    CK.decode_frame2 = spy
    try:
        two = stereo_card_run(dev, inp, 2)
    finally:
        CK.decode_frame2 = orig
    runs = {2: two["run"], 1: one["run"]}
    counts = {2: two["counts"], 1: one["counts"]}
    run_s = {2: two["seconds"], 1: one["seconds"]}

    # (a)'s cases: the run's inputs, and the fixture's stereo CELT-only
    # frames for an LM the run gave none; one band range a (LM, start),
    # the widest; their plain versions go to the CPU workers now
    for lm in range(4):
        if not any(k[:2] == (lm, 0) for k in captured):
            captured.update(fixture_k1_rows(sfx, lm, dev))
    cases = k1_short_lanes(captured, np.random.default_rng(28))
    widest = {}
    for key in sorted(cases):
        widest[key[:2]] = key
    cases = {k: cases[k] for k in widest.values()}
    for lm in range(4):
        for start in (0, 17):
            if (lm, start) not in widest:
                fail(f"opus_stereo: K1 stereo has no LM {lm} case at start "
                     f"{start}: {sorted(cases)}")
    timed_key = widest[(3, 0)]
    ref_jobs = {key: pool.submit(cpu_k1_stereo, key, to_cpu(args),
                                 to_cpu(d0), (True,) if key == timed_key
                                 else (False, True))
                for key, (_tabs, args, d0) in cases.items()}

    errs = {}
    for c, want in ((2, STEREO_EVENTS), (1, STEREO_MONO_EVENTS)):
        for k, v in counts[c].items():
            # the runs' few ticks need hold no mono CELT frame (every
            # other phase drives K1's mono instantiation)
            if v == 0 and k != "K1":
                fail(f"opus_stereo channels={c}: kernel {k} launched no "
                     f"time")
        run_c = runs[c]
        if run_c["flagged"].any():
            fail(f"opus_stereo channels={c}: lanes flagged")
        for k in want:
            if not run_c["events"].get(k):
                fail(f"opus_stereo channels={c}: no {k} in the run: "
                     f"{run_c['events']}")
        lanes_n = B_DNN if c == 2 else STEREO_MONO_LANES
        keep = inp["cpu_lanes"][inp["cpu_lanes"] < lanes_n]
        rows = [inp["packets"][i] for i in keep]
        cpu = jobs[c].result()
        cpu["kind"] = stereo_kinds(cpu, rows, inp["fec"][keep])
        if stereo_kinds(run_c, rows, inp["fec"][keep]) != cpu["kind"]:
            fail(f"opus_stereo channels={c}: the card's CELT use differs "
                 f"from the CPU run's")
        e_cpu = api_compare(run_c, cpu, f"stereo c={c}: card vs the CPU run")
        ref = stereo_fixture_ref(sfx, stereo_ticks(c), c)
        fx_rows = [int(np.nonzero(keep == i)[0][0]) for i in range(8)]
        e_jax = api_compare(run_c, ref, f"stereo c={c}: fixture lanes: card "
                            f"vs JAX", gl=fx_rows)
        errs[c] = (e_cpu, e_jax, cpu["seconds"])
    ev = runs[2]["events"]

    # (a) K1 stereo against its plain version: the timed case's reference
    # on the card (also the warm-up of its timed call), the others' from
    # the CPU workers
    t1 = time.time()
    x_err, n_cases = 0.0, {}
    for key, (tabs, args, d0) in sorted(cases.items()):
        refs = ref_jobs[key].result()
        if key == timed_key:
            refs[False] = CK.decode_frame2_plain(*args, tabs, d0, False)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            CK.decode_frame2_plain(*args, tabs, d0, False)
            e1.record()
            torch.cuda.synchronize()
            k1sp = e0.elapsed_time(e1)
            got = CK._decode_frame_cuda(*args, tabs, d0, channels=2)
            bnd = k1_bound(tabs, args, got)
            k1s = cuda_ms(lambda: CK._decode_frame_cuda(
                *args, tabs, d0, channels=2), 20)
        for inv, ref_k in sorted(refs.items()):
            got = CK._decode_frame_cuda(*args, tabs, d0, channels=2,
                                        disable_inv=inv)
            if ref_k["X"].device != got["X"].device:
                got = to_cpu(got)
            xe, _ee = compare_k1(got, ref_k, tabs, f" (stereo {key}, "
                                 f"disable_inv {int(inv)})")
            x_err = max(x_err, xe)
        n_cases[key] = int(args[0].shape[0])
    k1_s = time.time() - t1
    ops, dms = runs[2]["trace"]
    tick = float(np.median(runs[2]["tick_ms"]))
    g1, g2 = CK.geometry(160), CK.geometry(160, channels=2)
    print(f"opus_stereo at B={B_DNN} (two channels, {STEREO_TICKS} ticks) "
          f"and {STEREO_MONO_LANES} (one, {STEREO_MONO_TICKS} tick) (lanes "
          f"at step 0 and at steps {STEREO_OFFSETS}): launches {counts}; "
          f"frames {ev}; one channel's frames {runs[1]['events']}; "
          + "; ".join(
              f"channels={c}: card vs the CPU run on its lanes: ranges "
              f"equal, PCM within {e[0][0]:.3g}, int16 within {e[0][1]} LSB "
              f"(SILK-only exact); fixture lanes vs JAX: ranges equal, PCM "
              f"within {e[1][0]:.3g}, int16 within {e[1][1]} LSB; the CPU "
              f"run {e[2]:.1f} s" for c, e in errs.items())
          + f"; card runs {run_s[2]:.1f} s two channels, {run_s[1]:.1f} s "
          f"one (the second process); K1 stereo vs plain with disable_inv 0 "
          f"and 1 (integers exact, X within {x_err:.3g}) on "
          f"{ {str(k): v for k, v in n_cases.items()} } lanes, the plain "
          f"versions but the timed case's in CPU workers ({k1_s:.1f} s)")
    b = cases[timed_key][1][0].shape[0]
    print(f"opus_stereo times [{smi_line()}]: two-channel ticks at "
          f"B={B_DNN} {', '.join(f'{v:.1f}' for v in runs[2]['tick_ms'])} "
          f"ms (median {tick:.1f}); the last tick traced: {ops:.0f} device "
          f"operations, {dms:.2f} ms device (busy {100 * dms / tick:.1f}% "
          f"of the median tick); K1 stereo at 20 ms, start 0 {timed_key}, "
          f"B={b}: {k1s:.4f} ms, plain {k1sp:.2f} ms (its second call), "
          f"bound {bnd[0]:.6f} ms ({bnd[1]}); geometry at P=160: mono "
          f"{g1['registers']} registers, {g1['local_bytes']} bytes local, "
          f"{g1['smem_per_block']} bytes shared per block of "
          f"{g1['warps_per_block']} warps, {g1['warps_per_sm']} resident "
          f"warps per SM; stereo {g2['registers']} registers, "
          f"{g2['local_bytes']} bytes local, {g2['smem_per_block']} bytes "
          f"shared per block of {g2['warps_per_block']} warps, "
          f"{g2['warps_per_sm']} resident warps per SM")
    return dict(counts=counts, x_err=x_err, errs=errs, events=ev,
                tick_ms=tick, ops=ops, dev_ms=dms, k1s=k1s, k1sp=k1sp,
                k1s_bound=bnd)


def fixture_k1_rows(sfx, lm: int, dev) -> dict:
    """K1 stereo inputs from the stereo fixture's CELT-only stereo packets
    at LM ``lm`` (each frame of each packet, a fresh decoder's energy
    memory, seed 0, a coder started on the frame), keyed as the run's
    captures: {(lm, 0, end): [(buf, lens, old_e, prevmin, seed, None)]}."""
    import numpy as np
    import torch
    from opus_tpu_torch.bitstream import packet as pkt
    from opus_tpu_torch.models.opus_decoder import END_BAND
    frames = {}
    for p, _f, _z in (st for row in stereo_steps(sfx) for st in row):
        if p is None or not p[0] & 4 or p[0] >> 3 < 16:
            continue
        if pkt.packet_get_samples_per_frame(p, 48000) != 120 << lm:
            continue
        end = END_BAND[int(pkt.packet_get_bandwidth(p))]
        for f in pkt.packet_parse(p).frames:
            if len(f) > 1:
                frames.setdefault(end, []).append(f)
    out = {}
    for end, fs in frames.items():
        n = len(fs)
        w = max(len(f) for f in fs)
        buf = np.zeros((n, w), np.uint8)
        for i, f in enumerate(fs):
            buf[i, :len(f)] = np.frombuffer(f, np.uint8)
        lens = torch.tensor([len(f) for f in fs], device=dev)
        e = torch.zeros((n, 2, 21), dtype=torch.float32, device=dev)
        out[(lm, 0, end)] = [(torch.from_numpy(buf).to(dev), lens, e,
                              e - 28.0, torch.zeros(n, dtype=torch.int64,
                                                    device=dev), None)]
    return out


RATES_FIXTURE = os.path.join(REPO, "tests", "data", "torch_opus_rates.npz")
MS_FIXTURE = os.path.join(REPO, "tests", "data", "torch_opus_ms.npz")
RATES_FS = (8000, 12000, 16000, 24000)
RATES_LANES = 256       # the api traffic's lanes at each rate
RATES_TICKS = 6         # of the api streams' 15-20 packets
RATES_CPU_EXTRA = 48    # other lanes the card is held to the CPU run on
RATES_STEREO_FS = 24000
RATES_TIME_FS = 16000   # opus_api's traffic (B_DNN lanes) timed at this rate
RATES_TIME_TICKS = 3    # of its ticks: 2 timed with CUDA events, 1 traced
MS_LANES = 256          # 5.1 streams, and first-order ambisonic streams
MS_TICKS = 6
MS_KEEP = 32            # lanes whose outputs come back (all held to JAX)
MS_CPU_LANES = 4        # of those, the ones held to the port's CPU run
MS_TIME_TICKS = 3
MS_CASES = ("hi", "foa")    # torch_opus_ms.npz's 5.1 at 256 kb/s, FOA


def step_digest(x):
    """A step's output as 16 BLAKE2b bytes (little-endian samples), as
    tools/make_torch_opus_rates_fixture.py stores it."""
    import hashlib
    import numpy as np
    h = hashlib.blake2b(np.ascontiguousarray(x).astype(
        x.dtype.newbyteorder("<")).tobytes(), digest_size=16)
    return np.frombuffer(h.digest(), np.uint8)


def counted(fn):
    """fn() on the card with the K1 (mono and stereo), K2 and K4 counters
    reset just before and read just after -> (its result, the counts, its
    seconds)."""
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir, lpc
    torch.cuda.synchronize()
    CK.launches = CK.launches_stereo = iir.launches = lpc.launches = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, {"K1": CK.launches, "K1 stereo": CK.launches_stereo,
                 "K2": iir.launches, "K4": lpc.launches}, time.time() - t0


def rates_inputs(dev, afx, sfx):
    """opus_rates' traffic (gateways and speech recognition decoding at
    8-24 kHz): the api fixture's 8 streams over RATES_LANES lanes from
    packet 0, the lanes past the fixture's with ``-loss 10`` and every
    API_FEC_EVERY-th recovering by in-band FEC (``opus_api_inputs``); the
    stereo fixture's 8 streams over RATES_LANES lanes from step 0
    (``opus_stereo_inputs``).  Frame sizes in 48 kHz samples."""
    return (opus_api_inputs(dev, afx, b=RATES_LANES, nt=RATES_TICKS,
                            offset=0, extra=RATES_CPU_EXTRA),
            opus_stereo_inputs(sfx, RATES_LANES, offsets=(0,) * 8))


def rates_run(inp, device, fs, channels, lanes=None, **kw):
    """``opus_api_run`` at fs over ``inp``'s traffic (``lanes``: the rows
    it runs, default all), its frame sizes scaled to fs."""
    import numpy as np
    rows = np.arange(len(inp["packets"])) if lanes is None else lanes
    return opus_api_run([inp["packets"][i] for i in rows], device,
                        fec=inp["fec"][rows],
                        size=inp["size"][rows] * fs // 48000,
                        channels=channels, fs=fs, **kw)


def cpu_rates(inp, fs, channels):
    """A rates run on the CPU over ``inp``'s cpu_lanes, in a worker
    process while the card runs."""
    t0 = time.time()
    out = rates_run(inp, "cpu", fs, channels, lanes=inp["cpu_lanes"])
    del out["decoder"]
    out["seconds"] = time.time() - t0
    return out


def rates_card(dev, api, st) -> dict:
    """opus_rates' card runs (the third process): the api traffic at each
    rate of RATES_FS, one channel, RATES_TICKS calls; the stereo traffic
    at RATES_STEREO_FS, two channels, STEREO_TICKS calls; each with the
    kernel counters reset around it.  Returns numpy only."""
    out = {}
    for key, inp, fs, c in ([(fs, api, fs, 1) for fs in RATES_FS]
                            + [("stereo", st, RATES_STEREO_FS, 2)]):
        run, counts, sec = counted(lambda: rates_run(
            inp, dev, fs, c, keep=inp["cpu_lanes"]))
        del run["decoder"]
        out[key] = dict(run=run, counts=counts, seconds=sec)
    return out


def rates_fixture_compare(got, rfx, key, rows, packets_rows, fec_rows,
                          what):
    """The card's run on the fixture lanes (got's rows ``rows``) against
    the JAX scalar decoder at the case's rate (torch_opus_rates.npz
    ``key``): per tick sample counts and final ranges equal; where the
    scalar CELT decoder took no part, decode_int16's and decode24's
    output equal by their digests; elsewhere float PCM within PCM_ABS_TOL
    of decode24 / 2^23, or on a lost or FEC step within CLASSIC_LSB /
    32768.  Returns (max float err, steps held exactly)."""
    import numpy as np
    e_f, exact = 0.0, 0
    for t in range(len(got["n"])):
        for s, j in enumerate(rows):
            n = int(rfx[key + "_n"][s, t])
            if n < 0:
                continue
            if got["n"][t][j] != n or got["rng"][t][j] != rfx[key + "_rng"][
                    s, t]:
                fail(f"{what}: tick {t} stream {s}: sample count or final "
                     f"range differs from JAX")
            x16 = got["pcm16"][t][j, :n].reshape(-1)
            x24 = got["pcm24"][t][j, :n].reshape(-1)
            if rfx[key + "_celt"][s, t] == 0:
                if not (np.array_equal(step_digest(x16),
                                       rfx[key + "_d16"][s, t])
                        and np.array_equal(step_digest(x24),
                                           rfx[key + "_d24"][s, t])):
                    fail(f"{what}: tick {t} stream {s}: SILK int16 or "
                         f"decode24 differs from JAX")
                exact += 1
                continue
            o = rfx[key + "_off"][s, t]
            ref = rfx[key + "_pcm24"][o:o + len(x24)] / 2.0 ** 23
            e = float(np.abs(got["pcm"][t][j, :n].reshape(-1) - ref).max(
                initial=0.0))
            lossy = packets_rows[j][t] is None or fec_rows[j, t]
            lim = (CLASSIC_LSB / 32768 if lossy else PCM_ABS_TOL) + 2.0 ** -24
            if not e <= lim:
                fail(f"{what}: tick {t} stream {s}: PCM err {e} > {lim}")
            e_f = max(e_f, e)
    return e_f, exact


def d24_compare(got, ref, what):
    """decode24 card vs the CPU run: equal on "silk" rows, elsewhere
    within the float bound in 24-bit steps (+1 for the rounding)."""
    import numpy as np
    for t in range(len(ref["n"])):
        for j, kind in enumerate(ref["kind"][t]):
            m = int(ref["n"][t][j])
            d = int(np.abs(got["pcm24"][t][j, :m].astype(np.int64)
                           - ref["pcm24"][t][j, :m]).max(initial=0))
            lim = {"silk": 0, "celt": int(PCM_ABS_TOL * 2 ** 23) + 1,
                   "concealed": CLASSIC_LSB * 256 + 1}.get(kind)
            if lim is not None and d > lim:
                fail(f"{what}: tick {t} row {j}: decode24 differs by {d}")


def phase_opus_rates(rfx, api, st, cr, jobs):
    """opus_rates' checks (gateways and speech recognition front ends
    that decode at 8-24 kHz): the third process's card runs (``cr``) held
    to the port's CPU runs (``jobs``: futures of cpu_rates on the
    cpu_lanes) and, on the fixture lanes, to the JAX decoder at the same
    rate (torch_opus_rates.npz); K1, K2 and K4 launched in each run."""
    import numpy as np
    report = []
    for key, inp, fs, c in ([(fs, api, fs, 1) for fs in RATES_FS]
                            + [("stereo", st, RATES_STEREO_FS, 2)]):
        card, counts = cr[key]["run"], cr[key]["counts"]
        what = f"opus_rates {fs} Hz, {c} channel{'s' * (c == 2)}"
        for k in ("K1 stereo" if c == 2 else "K1", "K2", "K4"):
            if counts[k] == 0:
                fail(f"{what}: kernel {k} launched no time")
        if card["flagged"].any():
            fail(f"{what}: lanes flagged")
        lanes = inp["cpu_lanes"]
        rows = [inp["packets"][i] for i in lanes]
        cpu = jobs[key].result()
        kinds = api_kinds if c == 1 else stereo_kinds
        cpu["kind"] = kinds(cpu, rows, inp["fec"][lanes])
        if kinds(card, rows, inp["fec"][lanes]) != cpu["kind"]:
            fail(f"{what}: the card's CELT use differs from the CPU run's")
        e_cpu = api_compare(card, cpu, f"{what}: card vs the CPU run")
        d24_compare(card, cpu, f"{what}: card vs the CPU run")
        fx_rows = [int(np.nonzero(lanes == i)[0][0]) for i in range(8)]
        e_jax = rates_fixture_compare(
            card, rfx, f"{'st' if c == 2 else 'api'}{fs // 1000}_{c}",
            fx_rows, rows, inp["fec"][lanes], f"{what}: fixture lanes")
        report.append(f"{fs // 1000} kHz x{c}: launches {counts}, card "
                      f"{cr[key]['seconds']:.1f} s, CPU {cpu['seconds']:.1f}"
                      f" s; vs CPU PCM {e_cpu[0]:.3g}, int16 {e_cpu[1]} "
                      f"LSB; vs JAX PCM {e_jax[0]:.3g}, {e_jax[1]} steps "
                      f"exact")
    print(f"opus_rates at {RATES_LANES} lanes ({RATES_TICKS} ticks of the "
          f"api traffic a rate, {STEREO_TICKS} of the stereo one at "
          f"{RATES_STEREO_FS} Hz; ranges equal, SILK int16 and decode24 "
          f"exact, card vs the CPU run on {len(api['cpu_lanes'])} / "
          f"{len(st['cpu_lanes'])} lanes and vs JAX on the 8 fixture "
          f"lanes): " + "; ".join(report))
    return {key: cr[key]["counts"] for key in cr}


def ms_inputs(mfx):
    """opus_ms' traffic (a mixer or transcoder terminating surround and
    ambisonic streams): per case of MS_CASES MS_LANES lanes over MS_TICKS,
    lane i carrying the fixture's stream i % 2."""
    out = {}
    for case in MS_CASES:
        plen, buf = mfx[case + "_plen"], mfx[case + "_packets"]
        n = plen.shape[0]
        out[case] = [[bytes(buf[i % n, t, :plen[i % n, t]])
                      for t in range(MS_TICKS)] for i in range(MS_LANES)]
    return out


def ms_layout(mfx, case):
    ch, streams, coupled = (int(v) for v in mfx[case + "_layout"])
    return ch, streams, coupled, [int(m) for m in mfx[case + "_mapping"]]


def ms_run(mfx, case, packets, device, keep=None, timed=False):
    """``BatchedOpusMSDecoder`` (case "hi") or
    ``BatchedOpusProjectionDecoder`` ("foa") at 48 kHz over len(packets)
    lanes, one call a tick.  Per tick and kept lane: float PCM [L, W, C],
    int16 (5.1: FLOAT2INT16, no soft clip; projection: the Q15 demix of
    the internal channels' int16), decode24, n, the elementary decoders'
    ranges [L, streams]; tick_ms with timed=True."""
    import numpy as np
    import torch
    from opus_tpu_torch.models.multistream import BatchedOpusMSDecoder
    from opus_tpu_torch.models.opus_decoder import to_int24
    from opus_tpu_torch.models.projection import BatchedOpusProjectionDecoder
    from opus_tpu_torch.utils.soft_clip import float2int16_lanes
    ch, streams, coupled, mapping = ms_layout(mfx, case)
    b = len(packets)
    keep = np.arange(b) if keep is None else np.asarray(keep)
    if case == "foa":
        dec = BatchedOpusProjectionDecoder(
            b, 48000, ch, streams, coupled, mfx[case + "_matrix"].tobytes(),
            device=device)
        ms = dec.ms
    else:
        dec = ms = BatchedOpusMSDecoder(b, 48000, ch, streams, coupled,
                                        mapping, device=device)
    out = dict(pcm=[], pcm16=[], pcm24=[], n=[], rng=[], tick_ms=[])
    k = torch.as_tensor(keep, device=ms.device)
    for t in range(len(packets[0])):
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        x, n = ms.decode([row[t] for row in packets])
        if case == "foa":
            pcm = torch.matmul(x, dec.demix)
            pcm16 = dec.demix_int16(float2int16_lanes(x))
        else:
            pcm, pcm16 = x, float2int16_lanes(x)
        pcm24 = to_int24(pcm)
        if timed:
            e1.record()
            torch.cuda.synchronize()
            out["tick_ms"].append(e0.elapsed_time(e1))
        if ms.status.any():
            fail(f"opus_ms {case}: lanes refused: {ms.status.tolist()[:8]}")
        out["pcm"].append(pcm.index_select(0, k).cpu().numpy())
        out["pcm16"].append(pcm16.index_select(0, k).cpu().numpy())
        out["pcm24"].append(pcm24.index_select(0, k).cpu().numpy())
        out["n"].append(n[keep])
        out["rng"].append(ms.final_range.index_select(0, k).cpu().numpy())
    out["demix"] = dec.demix_q15.cpu().numpy() if case == "foa" else None
    return out


def cpu_ms(case, packets):
    """An opus_ms run on the CPU over ``packets``' lanes, in a worker
    process while the card runs."""
    import numpy as np
    t0 = time.time()
    out = ms_run(dict(np.load(MS_FIXTURE)), case, packets, "cpu")
    out["seconds"] = time.time() - t0
    return out


def ms_card(dev, mfx, ms_in) -> dict:
    """opus_ms' card runs (the third process): each case of MS_CASES over
    MS_LANES lanes for MS_TICKS calls, the kernel counters reset around
    it; the first MS_KEEP lanes' outputs returned (numpy)."""
    out = {}
    for case in MS_CASES:
        run, counts, sec = counted(lambda: ms_run(
            mfx, case, ms_in[case], dev, keep=range(MS_KEEP)))
        out[case] = dict(run=run, counts=counts, seconds=sec)
    return out


def phase_opus_ms(dev, mfx, cr, jobs):
    """opus_ms' checks: the third process's card runs (``cr``) held on
    every kept lane to the JAX decoders (torch_opus_ms.npz: the elementary
    decoders' final ranges, float PCM within PCM_ABS_TOL of decode24 /
    2^23 (the projection's scaled by its demixing matrix's largest row
    sum), decode24 and int16 exact on the channels of SILK-only streams;
    the projection's Q15 demix fed JAX's internal int16 equal to JAX's
    decode_int16) and on MS_CPU_LANES lanes to the port's CPU run
    (``jobs``); the kernels each case runs launched."""
    import numpy as np
    import torch
    from opus_tpu_torch.models.projection import BatchedOpusProjectionDecoder
    report = []
    for case in MS_CASES:
        card, counts = cr[case]["run"], cr[case]["counts"]
        what = f"opus_ms {case}"
        need = ("K1 stereo", "K2") + (("K1", "K4") if case == "hi" else ())
        for k in need:
            if counts[k] == 0:
                fail(f"{what}: kernel {k} launched no time")
        ch, streams, coupled, mapping = ms_layout(mfx, case)
        n_fx = mfx[case + "_plen"].shape[0]
        gain = 1.0
        if case == "foa":
            gain = np.abs(card["demix"]).sum(axis=1).max() / 32768.0
        modes = mfx[case + "_modes"]
        e_jax, exact = 0.0, 0
        for t in range(MS_TICKS):
            for j in range(MS_KEEP):
                s = j % n_fx
                ref24 = mfx[case + "_pcm24"][s, t]
                if card["n"][t][j] != ref24.shape[0] or not np.array_equal(
                        card["rng"][t][j], mfx[case + "_rng"][s, t]):
                    fail(f"{what}: tick {t} lane {j}: sample count or "
                         f"final ranges differ from JAX")
                e = float(np.abs(card["pcm"][t][j] - ref24 / 2.0 ** 23).max())
                if not e <= PCM_ABS_TOL * gain + 2.0 ** -24:
                    fail(f"{what}: tick {t} lane {j}: PCM err {e}")
                e_jax = max(e_jax, e)
                for c, m in enumerate(mapping):
                    if m == 255:
                        continue
                    st = m // 2 if m < 2 * coupled else m - coupled
                    if case != "foa" and (modes[s, :t + 1, st]
                                          == 1000).all():
                        want16 = np.clip(np.round(ref24[:, c] / 256.0),
                                         -32768, 32767)
                        if not (np.array_equal(card["pcm24"][t][j][:, c],
                                               ref24[:, c])
                                and np.array_equal(card["pcm16"][t][j][:, c],
                                                   want16)):
                            fail(f"{what}: tick {t} lane {j} channel {c}: "
                                 f"SILK output differs from JAX")
                        exact += 1
        cpu = jobs[case].result()
        e_cpu = 0.0
        for t in range(MS_TICKS):
            for j in range(MS_CPU_LANES):
                if not np.array_equal(card["rng"][t][j], cpu["rng"][t][j]):
                    fail(f"{what}: tick {t} lane {j}: ranges differ from the "
                         f"CPU run")
                e_cpu = max(e_cpu, float(np.abs(card["pcm"][t][j]
                                                - cpu["pcm"][t][j]).max()))
        if not e_cpu <= PCM_ABS_TOL * gain:
            fail(f"{what}: card vs the CPU run: PCM err {e_cpu}")
        extra = ""
        if case == "foa":
            dec = BatchedOpusProjectionDecoder(
                1, 48000, ch, streams, coupled,
                mfx[case + "_matrix"].tobytes(), device=dev)
            x16 = torch.as_tensor(mfx[case + "_internal16"], device=dev)
            got = dec.demix_int16(x16.flatten(0, 1)).cpu().numpy()
            if not np.array_equal(got.reshape(mfx[case + "_pcm16"].shape),
                                  mfx[case + "_pcm16"]):
                fail(f"{what}: the Q15 demix of JAX's internal int16 "
                     f"differs from JAX's decode_int16")
            d16 = max(int(np.abs(card["pcm16"][t][j].astype(np.int64)
                                 - mfx[case + "_pcm16"][j % n_fx, t]).max())
                      for t in range(MS_TICKS) for j in range(MS_KEEP))
            extra = (f", the card's Q15 demix of JAX's internal int16 "
                     f"equal to JAX's int16, its own int16 within {d16} LSB")
        report.append(f"{case} ({ch} channels, {streams} streams, "
                      f"{coupled} coupled): launches {counts}, card "
                      f"{cr[case]['seconds']:.1f} s, CPU {cpu['seconds']:.1f}"
                      f" s; PCM vs JAX {e_jax:.3g}, vs CPU {e_cpu:.3g}; "
                      f"{exact} SILK channel-ticks exact{extra}")
    print(f"opus_ms at {MS_LANES} lanes x {MS_TICKS} ticks (the first "
          f"{MS_KEEP} held to JAX, {MS_CPU_LANES} to the CPU run): "
          + "; ".join(report))
    return {case: cr[case]["counts"] for case in MS_CASES}


def opus_rates_times(dev, smi, api_in):
    """opus_api's traffic (B_DNN lanes, lanes at two packet offsets) at
    RATES_TIME_FS for RATES_TIME_TICKS calls: CUDA event times of all but
    the last, which is traced (device operations, device ms, busy share
    of the median tick)."""
    import numpy as np
    nt = RATES_TIME_TICKS
    inp = dict(api_in, packets=[row[:nt] for row in api_in["packets"]],
               fec=api_in["fec"][:, :nt], size=api_in["size"][:, :nt])
    run = rates_run(inp, dev, RATES_TIME_FS, 1, keep=np.zeros(0, np.int64),
                    timed=True, trace_last=True)
    ms = float(np.median(run["tick_ms"]))
    ops, dms = run["trace"]
    print(f"opus_rates times [{smi}]: opus_api's traffic at "
          f"{RATES_TIME_FS} Hz, B={B_DNN}: ticks "
          f"{', '.join(f'{v:.0f}' for v in run['tick_ms'])} ms (median "
          f"{ms:.1f}); the last tick traced: {ops:.0f} device operations, "
          f"{dms:.2f} ms device (busy {100 * dms / ms:.1f}% of the median "
          f"tick)")
    return dict(tick_ms=ms, ops=ops, dev_ms=dms)


def opus_ms_times(dev, smi, mfx, ms_in):
    """The 5.1 cell (MS_LANES lanes) for MS_TIME_TICKS calls, a fresh
    decoder, CUDA event times of each."""
    import numpy as np
    run = ms_run(mfx, "hi", [row[:MS_TIME_TICKS] for row in ms_in["hi"]],
                 dev, keep=np.zeros(0, np.int64), timed=True)
    ms = float(np.median(run["tick_ms"]))
    print(f"opus_ms times [{smi}]: 5.1 at 256 kb/s, {MS_LANES} streams "
          f"({MS_LANES * 2} stereo + {MS_LANES * 2} mono elementary "
          f"lanes): ticks {', '.join(f'{v:.1f}' for v in run['tick_ms'])} "
          f"ms (median {ms:.1f})")
    return dict(tick_ms=ms)


def third_phases(api_r, st_r, ms_in) -> dict:
    """The phases a third process on the card runs beside the first two
    processes' early phases: opus_rates' and opus_ms' card runs, untimed;
    the first process checks them."""
    return _second(_rates_ms_phases, api_r, st_r, ms_in)


def _rates_ms_phases(dev, res, api_r, st_r, ms_in):
    import numpy as np
    t_start = time.time()
    where = " (third process)"
    t0 = time.time()
    res["rates"] = rates_card(dev, api_r, st_r)
    phase_done(res["phase_s"], "opus_rates_card", t0, t_start, where)
    t0 = time.time()
    res["ms"] = ms_card(dev, dict(np.load(MS_FIXTURE)), ms_in)
    phase_done(res["phase_s"], "opus_ms_card", t0, t_start, where)


def phase_done(phase_s: dict, name: str, t0: float, t_start: float,
               where: str = "") -> None:
    """Record phase ``name``'s seconds since t0 and print them with the
    seconds since t_start."""
    phase_s[name] = time.time() - t0
    print(f"phase {name}: {phase_s[name]:.1f} s, "
          f"{time.time() - t_start:.0f} s in{where}", flush=True)


def to_cpu(tree):
    """Tensors of a tree of tuples, lists and dicts moved to the CPU (to
    pass between processes)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def to_device(tree, dev):
    """``to_cpu``'s inverse: the tree's tensors on ``dev``."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree


def second_process():
    """One more process on the card, for the phases of ``second_phases``
    (the script is host-bound: its card is busy a few percent of a
    phase, so two processes share it)."""
    import concurrent.futures
    import multiprocessing
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_second_init)


def _second_init():
    sys.path.insert(0, REPO)


def _second(body, *args) -> dict:
    """``body(dev, res, *args)`` in the second process, its printed log
    captured: returns ``res`` with ``phase_s`` (the seconds of each phase
    it ran), ``log`` and ``fail`` (None, or the failed check's message)."""
    import contextlib
    import io
    import traceback
    import torch

    log = io.StringIO()
    res = dict(phase_s={}, fail=None)
    try:
        with contextlib.redirect_stdout(log):
            from opus_tpu_torch import cuda_build
            cuda_build.library()
            body(torch.device("cuda", 0), res, *args)
    except SystemExit as e:
        res["fail"] = str(e)
    except Exception:
        res["fail"] = traceback.format_exc()
    res["log"] = log.getvalue()
    return res


def second_phases() -> dict:
    """The phases the second process runs while the first runs its early
    ones: the encoder and duplex (K3), 10 ms CELT, SILK (K4) and the FB
    and SWB hybrid decodes, each as the first process would run it.  None
    of them times anything; their timing phases run later in the first
    process, alone on the card, on the lanes and kernel inputs returned
    here (numpy, numbers, CPU tensors)."""
    return _second(_early_phases)


def _early_phases(dev, res):
    import numpy as np
    from opus_tpu_torch.models import celt_dec_kernel as CK

    t_start = time.time()
    where = " (second process)"
    ps = res["phase_s"]
    t0 = time.time()
    efx = dict(np.load(ENC_FIXTURE))
    enc_lanes = make_enc_lanes(efx, np.random.default_rng(21))
    k3_err = phase_k3_vs_plain(enc_lanes, dev)
    ecounts, enc_outs = phase_encode(enc_lanes, dev)
    dcounts = phase_duplex(enc_lanes, efx, dev, enc_outs)
    k3_err = max(k3_err, phase_encode_rate(enc_lanes, dev, 320)[0])
    res.update(k3_err=k3_err, ecounts=ecounts, dcounts=dcounts,
               enc_lanes=enc_lanes)
    phase_done(ps, "celt_encode_duplex", t0, t_start, where)

    t0 = time.time()
    c10 = phase_celt10ms(dev)
    c10["tabs"] = None
    res["c10"] = c10
    phase_done(ps, "celt_10ms", t0, t_start, where)

    t0 = time.time()
    sfx = dict(np.load(SILK_FIXTURE))
    slanes, sstream = make_lanes(sfx, np.random.default_rng(22))
    phase_silk_fixed(dev)
    splain, k4_in, scov, k4_err = phase_silk_k4_vs_plain(slanes,
                                                         dev)
    print(f"SILK coverage (lane-frames of {B_MAIN * NFRAMES}): "
          f"{scov}")
    k4_count = phase_silk_end_to_end(slanes, sstream, sfx, dev,
                                     splain)
    res.update(slanes=slanes, k4_in=to_cpu(k4_in), k4_err=k4_err,
               k4_count=k4_count)
    phase_done(ps, "silk", t0, t_start, where)

    t0 = time.time()
    htabs = CK.dec_tabs(48000, 960, 17, 21)
    hfx = dict(np.load(HYB_FIXTURE))
    hlanes, hstream = make_lanes(hfx, np.random.default_rng(23))
    hplain, k1h_in, hcov, k1h_err = phase_hybrid_k1_vs_plain(
        hlanes, dev, htabs)
    print(f"hybrid coverage (lane-frames of {B_MAIN * NFRAMES}; "
          f"bands 18-20 with no bits are band-lane-frames, filled "
          f"by folding or noise): {hcov}")
    hpcm_err, hcounts = phase_hybrid_end_to_end(hlanes, hstream,
                                                hfx, dev, hplain)
    res.update(hlanes=hlanes, k1h_err=k1h_err, hpcm_err=hpcm_err,
               hcounts=hcounts,
               k1h_in=to_cpu(k1h_in[:5] + (None,) + k1h_in[6:]))
    phase_done(ps, "hybrid", t0, t_start, where)

    t0 = time.time()
    stabs = CK.dec_tabs(48000, 960, 17, 19)
    swfx = dict(np.load(SWB_FIXTURE))
    swlanes, swstream = make_lanes(swfx, np.random.default_rng(24))
    swplain, _k1s_in, swcov, k1s_err = phase_hybrid_k1_vs_plain(
        swlanes, dev, stabs)
    print(f"SWB hybrid coverage (lane-frames of "
          f"{B_MAIN * NFRAMES}): {swcov}")
    swpcm_err, swcounts = phase_hybrid_end_to_end(
        swlanes, swstream, swfx, dev, swplain, end=19)
    res.update(k1s_err=k1s_err, swpcm_err=swpcm_err,
               swcounts=swcounts)
    phase_done(ps, "hybrid_swb", t0, t_start, where)

def second_late(api_in, st_in) -> dict:
    """The phases the second process runs while the first runs the loss
    phases: opus_api's card run (``opus_api_card``) and opus_stereo's
    one-channel run (``stereo_card_run``), untimed; the first process
    checks them (``phase_opus_api``, ``phase_opus_stereo``)."""
    return _second(_late_phases, api_in, st_in)


def _late_phases(dev, res, api_in, st_in):
    t_start = time.time()
    where = " (second process)"
    t0 = time.time()
    res["api"] = opus_api_card(dev, api_in)
    phase_done(res["phase_s"], "opus_api_card", t0, t_start, where)
    t0 = time.time()
    res["stereo_one"] = stereo_card_run(dev, st_in, 1)
    phase_done(res["phase_s"], "opus_stereo_one_channel", t0, t_start,
               where)


def kernel_line(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    for path in (FIXTURE, ENC_FIXTURE, SILK_FIXTURE, HYB_FIXTURE,
                 SWB_FIXTURE, DRED_FIXTURE, PLC_FIXTURE, OSCE_FIXTURE,
                 FIXTURE10, ENC_FIXTURE10, DRED_ENC_FIXTURE, BBWE_FIXTURE,
                 SIM_FIXTURE, CELT_PLC_FIXTURE, SILK_PLC_FIXTURE,
                 API_FIXTURE, STEREO_FIXTURE, RATES_FIXTURE, MS_FIXTURE):
        if not os.path.exists(path):
            print(f"chip_smoke: missing {path}", file=sys.stderr)
            return 1
    sys.path.insert(0, REPO)
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK

    t_main = time.time()
    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    t0 = time.time()
    cuda_build.library()
    print(f"build: {time.time() - t0:.1f} s ({cuda_build.library_path().name})")
    for line in cuda_build.ptxas_log.splitlines():
        if "Compiling" in line or "Used" in line or "stack frame" in line:
            print("ptxas:", line.strip())
    for c in (1, 2):
        g = CK.geometry(160, channels=c)
        print(f"ptxas: K1 celt_dec_frame_kernel<{c}> ({c} channel"
              f"{'s' if c == 2 else ''}) at P=160: {g['registers']} "
              f"registers, {g['local_bytes']} bytes local memory per thread; "
              f"{g['smem_per_block']} bytes dynamic shared memory per block "
              f"of {g['warps_per_block']} warps; {g['blocks_per_sm']} blocks "
              f"= {g['warps_per_sm']} resident warps per SM")

    for nbytes in (160, 320):
        g = EK.geometry(nbytes)
        print(f"ptxas: K3 celt_enc_frame_kernel at nbytes={nbytes}: "
              f"{g['registers']} registers, {g['local_bytes']} bytes local "
              f"memory per thread; {g['smem_per_block']} bytes dynamic "
              f"shared memory per block of {g['warps_per_block']} warps; "
              f"{g['blocks_per_sm']} blocks = {g['warps_per_sm']} resident "
              f"warps per SM")

    k4_geometry()

    phase_s = {}
    tabs = CK.dec_tabs(48000, 960)
    fx = dict(np.load(FIXTURE))
    lanes, stream = make_lanes(fx, np.random.default_rng(20))

    # a second process on the card runs the encoder, 10 ms CELT, SILK and
    # both hybrid phases while this one runs the others, then opus_api's
    # and opus_stereo's untimed card runs while this one runs the loss
    # phases; a third runs opus_rates' and opus_ms' untimed card runs from
    # the start, their CPU references in two workers beside it; every
    # timing phase runs after all have finished, alone on the card
    afx = dict(np.load(API_FIXTURE))
    stfx = dict(np.load(STEREO_FIXTURE))
    rfx = dict(np.load(RATES_FIXTURE))
    mfx = dict(np.load(MS_FIXTURE))
    api_r, st_r = rates_inputs(dev, afx, stfx)
    ms_in = ms_inputs(mfx)
    with second_process() as second, second_process() as third, \
            cpu_pool(2) as rpool:
        second_job = second.submit(second_phases)
        third_job = third.submit(third_phases, api_r, st_r, ms_in)
        rates_jobs = {key: rpool.submit(cpu_rates, inp, fs, c)
                      for key, inp, fs, c in (
                          [(fs, api_r, fs, 1) for fs in RATES_FS]
                          + [("stereo", st_r, RATES_STEREO_FS, 2)])}
        ms_jobs = {case: rpool.submit(cpu_ms, case,
                                      ms_in[case][:MS_CPU_LANES])
                   for case in MS_CASES}
        t0 = time.time()
        plain_outs, x_err, e_err, k2_err, k2_in = phase_kernel_vs_plain(
            lanes, dev, tabs)
        pcm_err, counts = phase_end_to_end(lanes, stream, fx, dev,
                                           plain_outs)
        phase_done(phase_s, "celt_decode", t0, t_main)

        t0 = time.time()
        dred = phase_dred(dev, dict(np.load(DRED_FIXTURE)))
        phase_done(phase_s, "dred", t0, t_main)

        t0 = time.time()
        plc = phase_deep_plc(dev, dict(np.load(DRED_FIXTURE)),
                             dict(np.load(PLC_FIXTURE)), dred)
        phase_done(phase_s, "deep_plc", t0, t_main)

        t0 = time.time()
        sfx = dict(np.load(SILK_FIXTURE))
        ofx = dict(np.load(OSCE_FIXTURE))
        osce = phase_osce(dev, sfx, ofx)
        phase_done(phase_s, "osce", t0, t_main)

        t0 = time.time()
        bfx = dict(np.load(BBWE_FIXTURE))
        bb = phase_bbwe(dev, sfx, bfx, ofx)
        phase_done(phase_s, "bbwe", t0, t_main)
        t0 = time.time()
        oh = phase_osce_hybrid(dev, bfx)
        phase_done(phase_s, "osce_hybrid", t0, t_main)

        t0 = time.time()
        chain = phase_dred_chain(dev, dict(np.load(DRED_ENC_FIXTURE)))
        phase_done(phase_s, "dred_chain", t0, t_main)

        t0 = time.time()
        sp2 = second_job.result()
        print(sp2["log"], end="")
        if sp2["fail"]:
            fail(f"the second process: {sp2['fail']}")
        phase_s.update(sp2["phase_s"])
        phase_done(phase_s, "second_process_wait", t0, t_main)
        k3_err, ecounts, dcounts = (sp2["k3_err"], sp2["ecounts"],
                                    sp2["dcounts"])
        enc_lanes, c10 = sp2["enc_lanes"], sp2["c10"]
        c10["tabs"] = CK.dec_tabs(48000, 480)
        slanes, k4_count, k4_err = (sp2["slanes"], sp2["k4_count"],
                                    sp2["k4_err"])
        k4_in = to_device(sp2["k4_in"], dev)
        htabs = CK.dec_tabs(48000, 960, 17, 21)
        hlanes, k1h_err = sp2["hlanes"], sp2["k1h_err"]
        k1h_in = to_device(sp2["k1h_in"], dev)
        hpcm_err, hcounts = sp2["hpcm_err"], sp2["hcounts"]
        k1s_err, swpcm_err, swcounts = (sp2["k1s_err"], sp2["swpcm_err"],
                                        sp2["swcounts"])

        # the loss phases: their CPU reference runs go to worker processes
        # as soon as their inputs exist and run while the card works
        simfx = dict(np.load(SIM_FIXTURE))
        t0 = time.time()
        with cpu_pool() as pool:
            pl_in = plc_lanes_inputs(dev, simfx)
            pr_job = pool.submit(cpu_plc_rates, plc["cpu_dreds"],
                                 plc["hist"], plc["off48"])
            sl_in = sim_loss_inputs(dev, simfx)
            sl_job = pool.submit(cpu_sim_loss, sl_in["packets"],
                                 sl_in["lost"])
            api_in = opus_api_inputs(dev, afx)
            st_in = opus_stereo_inputs(stfx, B_DNN)
            late_job = second.submit(second_late, api_in, st_in)
            phase_done(phase_s, "loss_inputs", t0, t_main)
            t0 = time.time()
            pl = phase_plc_lanes(dev, simfx, pl_in, pool)
            phase_done(phase_s, "plc_lanes", t0, t_main)
            # the classic loops' CPU references queue behind plc_lanes' own
            cfx = dict(np.load(CELT_PLC_FIXTURE))
            cl_in = classic_inputs(sl_in, cfx)
            cl_jobs = {"plain": pool.submit(cpu_classic, cl_in["packets"],
                                            cl_in["lost"], False),
                       "dred": pool.submit(cpu_classic, cl_in["dred_packets"],
                                           cl_in["dred_lost"], True)}
            spfx = dict(np.load(SILK_PLC_FIXTURE))
            sp_in = silk_plc_inputs(sl_in, spfx)
            sp_jobs = {m: pool.submit(cpu_silk_plc, m, sp_in[m]["packets"],
                                      sp_in[m]["lost"], sp_in["cpu_lanes"])
                       for m in ("silk", "hybrid")}
            api_job = pool.submit(cpu_opus_api, api_in["packets"],
                                  api_in["fec"], api_in["size"],
                                  api_in["cpu_lanes"])
            st_jobs = {}
            for c, n_l in ((2, B_DNN), (1, STEREO_MONO_LANES)):
                keep = st_in["cpu_lanes"][st_in["cpu_lanes"] < n_l]
                nt = stereo_ticks(c)
                st_jobs[c] = pool.submit(
                    cpu_opus_api, [row[:nt] for row in st_in["packets"]],
                    st_in["fec"][:, :nt], st_in["size"][:, :nt], keep, c)
            t0 = time.time()
            sl = phase_sim_loss(dev, simfx, sl_in, sl_job)
            phase_done(phase_s, "sim_loss", t0, t_main)
            t0 = time.time()
            pr = phase_plc_rates(dev, simfx, plc, pr_job)
            phase_done(phase_s, "plc_rates", t0, t_main)
            t0 = time.time()
            cl = phase_celt_plc(dev, cfx, cl_in, cl_jobs)
            phase_done(phase_s, "celt_plc", t0, t_main)
            t0 = time.time()
            sp = phase_silk_plc(dev, spfx, sp_in, sp_jobs)
            phase_done(phase_s, "silk_plc", t0, t_main)

            t0 = time.time()
            late = late_job.result()
            print(late["log"], end="")
            if late["fail"]:
                fail(f"the second process: {late['fail']}")
            phase_s.update(late["phase_s"])
            phase_done(phase_s, "second_process_wait_late", t0, t_main)
            t0 = time.time()
            api = phase_opus_api(dev, afx, api_in, api_job, late["api"])
            phase_done(phase_s, "opus_api", t0, t_main)
            t0 = time.time()
            st = phase_opus_stereo(dev, stfx, st_in, st_jobs, pool,
                                   late["stereo_one"])
            phase_done(phase_s, "opus_stereo", t0, t_main)

        t0 = time.time()
        sp3 = third_job.result()
        print(sp3["log"], end="")
        if sp3["fail"]:
            fail(f"the third process: {sp3['fail']}")
        phase_s.update(sp3["phase_s"])
        phase_done(phase_s, "third_process_wait", t0, t_main)
        t0 = time.time()
        rates = phase_opus_rates(rfx, api_r, st_r, sp3["rates"], rates_jobs)
        phase_done(phase_s, "opus_rates", t0, t_main)
        t0 = time.time()
        ms = phase_opus_ms(dev, mfx, sp3["ms"], ms_jobs)
        phase_done(phase_s, "opus_ms", t0, t_main)

    t0 = time.time()
    t = phase_times(lanes, dev, tabs, k2_in, smi)
    t = phase_enc_times(enc_lanes, dev, smi, t)
    t = phase_silk_times(slanes, dev, smi, k4_in, t)
    t = phase_hybrid_times(hlanes, dev, smi, htabs, k1h_in, t)
    t.update(phase_dnn_times(dev, smi, dred))
    t.update(phase_plc_times(dev, smi, plc))
    t.update(phase_celt10ms_times(dev, smi, c10))
    phase_done(phase_s, "times", t0, t_main)
    t0 = time.time()
    t.update(phase_osce_times(dev, smi, osce))
    phase_done(phase_s, "osce_times", t0, t_main)
    t0 = time.time()
    t.update(phase_bbwe_times(dev, smi, bb, oh))
    phase_done(phase_s, "bbwe_times", t0, t_main)
    t0 = time.time()
    t.update(phase_dred_chain_times(dev, smi, chain))
    phase_done(phase_s, "dred_chain_times", t0, t_main)
    t0 = time.time()
    lt = loss_times(dev, smi, sl, pl, plc)
    phase_done(phase_s, "loss_times", t0, t_main)
    t0 = time.time()
    ct = celt_plc_times(dev, smi, cl_in)
    phase_done(phase_s, "celt_plc_times", t0, t_main)
    t0 = time.time()
    spt = silk_plc_times(dev, smi, sp_in)
    phase_done(phase_s, "silk_plc_times", t0, t_main)
    t0 = time.time()
    apt = opus_api_times(dev, smi, api)
    phase_done(phase_s, "opus_api_times", t0, t_main)
    t0 = time.time()
    rt = opus_rates_times(dev, smi, api_in)
    phase_done(phase_s, "opus_rates_times", t0, t_main)
    t0 = time.time()
    mt = opus_ms_times(dev, smi, mfx, ms_in)
    phase_done(phase_s, "opus_ms_times", t0, t_main)

    t0 = time.time()
    k5 = phase_k5(dev, smi)
    phase_done(phase_s, "k5", t0, t_main)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phase_s.items()))

    # launches: each path's counters, reset just before it and read just
    # after, summed over the paths that run the kernel
    per_path = {"celt decode": counts, "celt encode": ecounts,
                "duplex": dcounts,
                "silk": {"K4": k4_count}, "hybrid": hcounts,
                "hybrid swb": swcounts, "dred": {"K2": dred["k2"]},
                "deep plc": {"K2": plc["k2"]},
                "osce lace": osce["counts"]["LACE"],
                "osce nolace": osce["counts"]["NoLACE"],
                **{"silk 48 kHz " + k: v for k, v in bb["counts"].items()},
                **{k.replace("_", " "): v
                   for k, v in oh["counts"].items()},
                "celt decode 10 ms": c10["dcounts"],
                "celt encode + decode 10 ms": c10["ecounts"],
                "dred chain": chain["counts"],
                "dred chain recovery": chain["rcounts"],
                "sim loss": sl["counts"], "plc lanes": pl["counts"],
                "plc rates": pr["counts"],
                "celt plc": cl["plain"]["counts"],
                "celt plc dred": cl["dred"]["counts"],
                "silk plc silk": sp["silk"]["counts"],
                "silk plc hybrid": sp["hybrid"]["counts"],
                "opus api": api["counts"],
                "opus stereo two channels": st["counts"][2],
                "opus stereo one channel": st["counts"][1],
                **{f"opus rates {k}" + (" Hz" if k != "stereo" else
                                        f" {RATES_STEREO_FS} Hz"): v
                   for k, v in rates.items()},
                **{f"opus ms {k}": v for k, v in ms.items()}}
    print(f"launches per path ({NFRAMES} frames; the DRED chain "
          f"{CHAIN_FRAMES}): {per_path}")

    def total(k):
        return sum(c.get(k, 0) for c in per_path.values())

    kernels = {"kernels": [
        kernel_line("celt_dec_frame", "opus_tpu_torch/csrc/celt_dec_frame.cu",
                    "opus_tpu/models/celt_dec_kernel.py:656", total("K1"),
                    max(x_err, k1h_err, k1s_err, c10["x_err"],
                        api["x_err"]), t["k1"],
                    t["k1p"],
                    t["k1_bound"]),
        kernel_line("celt_dec_frame_stereo",
                    "opus_tpu_torch/csrc/celt_dec_frame.cu",
                    "opus_tpu/models/celt_dec_kernel.py:656",
                    total("K1 stereo"), st["x_err"], st["k1s"],
                    st["k1sp"], st["k1s_bound"]),
        kernel_line("deemphasis", "opus_tpu_torch/csrc/deemphasis.cu",
                    "opus_tpu/ops/iir_pallas.py:47", total("K2"),
                    max(k2_err, dred["k2_err"], plc["k2_err"],
                        osce["k2_err"], c10["k2_err"], oh["k2_err"]), t["k2"],
                    t["k2p"],
                    t["k2_bound"]),
        kernel_line("celt_enc_frame", "opus_tpu_torch/csrc/celt_enc_frame.cu",
                    "opus_tpu/models/celt_enc_kernel.py:798", total("K3"),
                    max(k3_err, c10["k3_err"]), t["k3"], t["k3p"],
                    t["k3_bound"]),
        kernel_line("silk_lpc", "opus_tpu_torch/csrc/silk_lpc.cu",
                    "opus_tpu/ops/lpc_pallas.py:67", total("K4"), k4_err,
                    t["k4"], t["k4p"], t["k4_bound"]),
        kernel_line("kbench_ops", "opus_tpu_torch/csrc/kbench_ops.cu",
                    "tools/kbench_ops.py:35", k5["launches"], 0.0, k5["ms"],
                    k5["plain_ms"], k5["bound"]),
    ]}
    print(f"decode step {t['dec_step']:.4f} ms/frame; encode step "
          f"{t['enc_step']:.4f} ms/frame; duplex step {t['duplex']:.4f} "
          f"ms/frame; SILK step {t['silk_step']:.4f} ms/frame (symbol pass "
          f"{t['silk_sym']:.4f}); hybrid step {t['hyb_step']:.4f} ms/frame "
          f"(K1 at start 17 {t['k1h']:.4f}); K1 at {4 * B_MAIN} streams "
          f"{t['k1_big']:.4f} ms; K3 at {4 * B_MAIN} streams "
          f"{t['k3_big']:.4f} ms, at 320 bytes {t['k3_320']:.4f} ms; PCM "
          f"max err vs scalar "
          f"{pcm_err:.3g} (CELT), {hpcm_err:.3g} (hybrid), {swpcm_err:.3g} "
          f"(SWB hybrid); K1 energies max err {e_err:.3g}; "
          f"fargan_batch_step {t['fargan_step']:.4f} ms, DRED recover "
          f"{t['recover']:.4f} ms at B={B_DNN} (PCM max err {dred['e_cpu']:.3g} "
          f"vs the CPU run, {dred['e_jax']:.3g} vs JAX); deep PLC "
          f"dred_decode {t['plc_dred']:.4f} ms, conceal "
          f"{t['plc_conceal']:.4f} ms at B={B_DNN} (16 kHz PCM within "
          f"{plc['e_cpu']['pcm16']:.0f} LSB of the CPU run, "
          f"{plc['e_jax']['pcm16']:.0f} of JAX); SILK decode at B={B_DNN} "
          f"{t['osce_none']:.4f} ms, with LACE {t['osce_LACE']:.4f} ms, "
          f"with NoLACE {t['osce_NoLACE']:.4f} ms (enhancer alone "
          f"{t['osce_LACE enhancer']:.4f} / "
          f"{t['osce_NoLACE enhancer']:.4f} ms; enhanced PCM within "
          f"{osce['LACE']['e_fx'][0]}/{osce['NoLACE']['e_fx'][0]} LSB of "
          f"the scalar decoder); BBWE frame at B={B_DNN} "
          f"{t['bbwe_frame']:.3f} ms, SILK 48 kHz decode "
          f"{t['silk48_plain']:.3f} ms ({t['silk48_bbwe']:.3f} with BBWE), "
          f"FB hybrid decode with NoLACE {t['hyb_nolace']:.3f} ms "
          f"({t['hyb_nolace_bbwe']:.3f} with NoLACE + BBWE); "
          f"10 ms: K1 {t['k1_10']:.4f} ms, K3 "
          f"{t['k3_10']:.4f} ms, decode step {t['dec_step_10']:.3f} ms, "
          f"encode step {t['enc_step_10']:.3f} ms; DRED chain at B={B_DNN}: "
          f"compute_latents {t['chain_parts']['compute_latents'][0]:.3f} ms, "
          f"host coder {t['chain_coder']:.1f} ms, attach "
          f"{t['chain_attach']:.1f} ms, chain frame {t['chain_frame']:.1f} "
          f"ms ({t['chain_frame_dred']:.1f} with DRED); loss chain at "
          f"B={B_DNN}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in
                                     lt.items()) + f"; classic loss at "
          f"B={B_DNN}: " + "; ".join(f"tick, {k} {v:.3f} ms" for k, v in
                                     ct.items()) + f"; SILK-WB loss at "
          f"B={B_DNN}: " + "; ".join(f"tick, {k} {v[0]:.3f} ms" for k, v in
                                     spt.items()) + f"; opus_api tick at "
          f"B={B_DNN} {apt['tick_ms']:.1f} ms (busy "
          f"{100 * apt['dev_ms'] / apt['tick_ms']:.1f}%), K1 at LM 1 "
          f"{apt['k1_lm1']:.4f} ms (bound {apt['k1_lm1_bound'][0]:.6f} ms); "
          f"opus_stereo two-channel tick at B={B_DNN} {st['tick_ms']:.1f} "
          f"ms (busy {100 * st['dev_ms'] / st['tick_ms']:.1f}%), K1 stereo "
          f"at 20 ms {st['k1s']:.4f} ms (bound {st['k1s_bound'][0]:.6f} "
          f"ms) beside the mono instantiation's {t['k1']:.4f} ms; "
          f"opus_rates tick at {RATES_TIME_FS} Hz, B={B_DNN} "
          f"{rt['tick_ms']:.1f} ms (busy "
          f"{100 * rt['dev_ms'] / rt['tick_ms']:.1f}%); opus_ms 5.1 tick at "
          f"B={MS_LANES} {mt['tick_ms']:.1f} ms")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
