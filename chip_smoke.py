#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path, the 20 ms mono CELT decoder at 64 kb/s CBR
(packets -> PCM, ``opus_tpu_torch.models.celt_dec_kernel.
KernelCeltDecoder``), over 4096 streams plus 32 garbage/truncated ones,
for 8 consecutive frames:

1. requires CUDA and prints the card's name and power limit;
2. builds the kernels from ``opus_tpu_torch/csrc`` (nvcc, sm_90a);
3. holds kernel K1 (the symbol pass) and K2 (de-emphasis) against their
   plain torch versions on the card, frame by frame with state carried;
4. runs the decoder end to end with the launch counters reset, and checks
   it against the scalar decoder's outputs stored in
   ``tests/data/torch_celt20ms_64k.npz`` (final range, PCM, error lanes);
5. times K1, K2, their plain versions and the whole decode step with
   CUDA events.

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


def make_lanes(fx, rng):
    """[NFRAMES] of (buf [B, 160] uint8, lens [B]) numpy, plus the fixture
    stream index of each main lane.  Lanes >= B_MAIN: 16 truncated
    fixture packets, then 16 of random bytes."""
    import numpy as np
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    b = B_MAIN + N_BAD
    stream = np.arange(B_MAIN) % ns
    out = []
    for f in range(NFRAMES):
        buf = np.zeros((b, p), np.uint8)
        ln = np.zeros(b, np.int64)
        buf[:B_MAIN] = frames[stream, f]
        ln[:B_MAIN] = lens[stream, f]
        for j in range(N_BAD):
            lane = B_MAIN + j
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


def compare_k1(got, ref, tabs):
    """Integer outputs identical; X and energies within tolerance."""
    import torch
    from opus_tpu_torch.models.celt_dec_kernel import INT_KEYS
    for k in INT_KEYS:
        if not torch.equal(got[k], ref[k]):
            bad = (got[k] != ref[k]).nonzero()[:5, 0].tolist()
            fail(f"K1 vs plain: {k} differs at lanes {bad}")
    e_err = (got["energies"] - ref["energies"]).abs().max().item()
    if not e_err <= E_ABS_TOL:
        fail(f"K1 vs plain: energies err {e_err}")
    if not torch.equal(got["pf_gain"], ref["pf_gain"]):
        fail("K1 vs plain: pf_gain differs")
    x_err = 0.0
    m, eb = tabs.M, tabs.eBands
    for i in range(tabs.nb):
        a, c = m * int(eb[i]), m * int(eb[i + 1])
        xr, xg = ref["X"][:, a:c], got["X"][:, a:c]
        scale = xr.abs().amax(dim=1)
        diff = (xg - xr).abs().amax(dim=1)
        if not bool((diff <= X_REL_TOL * scale).all()):
            lane = int((diff - X_REL_TOL * scale).argmax())
            fail(f"K1 vs plain: X band {i} lane {lane} err "
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


def phase_end_to_end(lanes, stream, fx, dev, plain_outs):
    """The decoder as a user drives it, counters reset around the run."""
    import numpy as np
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.ops import iir

    b = lanes[0][0].shape[0]
    bufs = [(torch.from_numpy(bu).to(dev), torch.from_numpy(ln).to(dev))
            for bu, ln in lanes]
    dec = CK.KernelCeltDecoder(b, device=dev, max_payload=160)
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


def phase_times(lanes, dev, tabs, k2_in, smi):
    import torch
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state
    from opus_tpu_torch.ops import iir

    buf = torch.from_numpy(lanes[0][0][:B_MAIN]).to(dev)
    ln = torch.from_numpy(lanes[0][1][:B_MAIN]).to(dev)
    st = fused_celt_init_state(B_MAIN, tabs, dev)
    pm = torch.minimum(st["prev1"], st["prev2"])
    args = (buf, ln, st["old_e"], pm, st["seed"], tabs)
    k1 = cuda_ms(lambda: CK.decode_frame(*args), 20)
    k1p = cuda_ms(lambda: CK.decode_frame_plain(*args), 1)
    x, mem = k2_in[0][:B_MAIN], k2_in[1][:B_MAIN]
    coef = float(tabs.mode.preemph[0])
    k2 = cuda_ms(lambda: iir.deemphasis(x, mem, coef), 50)
    k2p = cuda_ms(lambda: iir.deemphasis_plain(x, mem, coef), 50)
    dec = CK.KernelCeltDecoder(B_MAIN, device=dev, max_payload=160)
    step = cuda_ms(lambda: dec.decode_packed(buf, ln), 10)
    streams = B_MAIN * 20.0 / step
    print(f"times at B={B_MAIN} [{smi}]: K1 {k1:.4f} ms/frame, plain "
          f"{k1p:.2f} ms; K2 {k2:.4f} ms, plain {k2p:.4f} ms; decode step "
          f"{step:.3f} ms/frame -> {streams:.0f} realtime 20 ms streams")
    return k1, k1p, k2, k2p, step


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.exists(FIXTURE):
        print(f"chip_smoke: missing {FIXTURE}", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.models import celt_dec_kernel as CK

    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    t0 = time.time()
    cuda_build.library()
    print(f"build: {time.time() - t0:.1f} s ({cuda_build.library_path().name})")
    for line in cuda_build.ptxas_log.splitlines():
        if "Used" in line or "stack frame" in line:
            print("ptxas:", line.strip())

    tabs = CK.dec_tabs(48000, 960)
    fx = dict(np.load(FIXTURE))
    lanes, stream = make_lanes(fx, np.random.default_rng(20))

    t0 = time.time()
    plain_outs, x_err, e_err, k2_err, k2_in = phase_kernel_vs_plain(
        lanes, dev, tabs)
    print(f"kernel vs plain: {time.time() - t0:.1f} s")
    pcm_err, counts = phase_end_to_end(lanes, stream, fx, dev, plain_outs)
    k1, k1p, k2, k2p, step = phase_times(lanes, dev, tabs, k2_in, smi)

    kernels = {"kernels": [
        dict(name="celt_dec_frame", route="cuda",
             source="opus_tpu_torch/csrc/celt_dec_frame.cu",
             replaces="opus_tpu/models/celt_dec_kernel.py:656",
             launches=counts["K1"], max_abs_err=x_err, ms=k1,
             plain_ms=k1p),
        dict(name="deemphasis", route="cuda",
             source="opus_tpu_torch/csrc/deemphasis.cu",
             replaces="opus_tpu/ops/iir_pallas.py:47",
             launches=counts["K2"], max_abs_err=k2_err, ms=k2,
             plain_ms=k2p),
    ]}
    print(f"decode step {step:.4f} ms/frame; PCM max err vs scalar "
          f"{pcm_err:.3g}; K1 energies max err {e_err:.3g}")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
