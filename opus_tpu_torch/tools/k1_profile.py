"""Where kernel K1's time goes, by phase, on the card.

Builds K1's source (``csrc/celt_dec_frame.cu``) alone with
``-DK1_PROFILE``: lane 0 of every warp then adds the SM clock cycles
(``clock64``) of each phase of the symbol pass into a device counter; the
port's own build compiles none of it.  The CELT decoder (start band 0)
and the hybrid decoder (start band 17, continuing SILK's range decoder)
run the decode and hybrid fixtures' 8 frames tiled over ``--batch``
streams on the card, state carried; on every frame the profile build is
launched on the same inputs as the port's K1, its outputs must equal K1's
exactly, and its cycles are summed.  Prints the SM cycles per stream and
frame of each phase, averaged over the 8 frames, and, last, one JSON line.

    python -m opus_tpu_torch.tools.k1_profile [--batch 4096]

Run from the repository root on a machine with the card.  A block holds
``K1_WARPS`` (16) streams and one block runs per SM, so ``--batch 8``
runs 2 warps on each of one SM's 4 schedulers and ``--batch 16`` 4, as
every SM has at 4096: the chain's length against the warps sharing a
scheduler.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# K1_PROFILE's slots (PROF_ADD in the source); the indented ones are
# parts of the band loop: the band tree is its split nodes (theta), its
# leaves' symbols, then the leaves built (cwrsi and the float passes,
# exp_rotation among them)
PHASES = ("setup", "header+coarse", "tf/spread/dynalloc/trim",
          "allocation", "fine", "band loop", "finalise+anti-collapse",
          "outputs", "  leaves built", "    exp_rotation",
          "  leaf symbols", "  theta nodes", "  band tree (all)", "",
          "kernel total")
NPROF = 16


def build_profile():
    """``celt_dec_frame.cu`` alone with -DK1_PROFILE -> (ctypes library
    with K1's argument types set, nvcc's ptxas lines for the kernel)."""
    from opus_tpu_torch import cuda_build

    src = cuda_build.CSRC / "celt_dec_frame.cu"
    out = cuda_build.BUILD_DIR / "k1_profile.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build._nvcc(), *cuda_build.FLAGS, "-shared", "-DK1_PROFILE",
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stderr}")
    lib = cuda_build.bind_celt_dec_frame(ctypes.CDLL(str(out)))
    lib.opus_celt_dec_frame_profile.argtypes = [ctypes.c_void_p]
    lib.opus_celt_dec_frame_profile.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in proc.stderr.splitlines()
             if "Used" in ln or "stack frame" in ln]
    return lib, ptxas


def profile_path(lib, batch: int, start: int, dev) -> tuple:
    """One 8-frame chain at ``start`` (0: CELT decode, 17: hybrid) ->
    (cycle sums per slot over all frames and streams, frames)."""
    import numpy as np
    import torch

    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import hybrid_dec_fused as PH
    from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state

    name = "torch_celt20ms_64k" if start == 0 else "torch_hybrid_fb20ms"
    fx = np.load(REPO / "tests" / "data" / f"{name}.npz")
    frames, lens = fx["frames"], fx["lens"]         # [ns, F, P], [ns, F]
    idx = np.arange(batch) % frames.shape[0]
    sums = np.zeros(NPROF, np.float64)
    counts = (ctypes.c_ulonglong * NPROF)()

    def frame_fn(*args):
        ref = CK.decode_frame(*args)
        torch.cuda.synchronize()
        lib.opus_celt_dec_frame_profile(counts)        # zero the counters
        got = CK._decode_frame_cuda(*args, lib=lib)
        torch.cuda.synchronize()
        if lib.opus_celt_dec_frame_profile(counts) != 0:
            raise RuntimeError("reading K1's profile counters failed")
        for k, v in ref.items():
            if not torch.equal(got[k], v):
                raise RuntimeError(f"profile build differs from K1: {k}")
        sums[:] += np.asarray(list(counts), np.float64)
        return ref

    if start == 0:
        tabs = CK.dec_tabs(48000, 960)
        state = fused_celt_init_state(batch, tabs, dev)
    else:
        tabs = CK.dec_tabs(48000, 960, 17, 21)
        state = PH.hybrid_init_state(batch, tabs, dev)
    for f in range(frames.shape[1]):
        buf = torch.from_numpy(frames[idx, f]).to(dev)
        ln = torch.from_numpy(lens[idx, f]).to(dev)
        if start == 0:
            _pcm, state, _err = CK.kernel_celt_decode_to_pcm(
                buf, ln, state, tabs, frame_fn)
        else:
            _pcm, state, _err = PH.fused_hybrid_decode(buf, ln, state, tabs,
                                                       frame_fn)
    return sums, frames.shape[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k1_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.models import celt_dec_kernel as CK

    dev = torch.device("cuda", 0)
    cuda_build.library()
    lib, ptxas = build_profile()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    geo = CK.geometry(160)
    print(f"card: {smi}; K1 geometry {geo}; profile build ptxas: "
          + " | ".join(ptxas))
    result = {"card": smi, "batch": args.batch, "geometry": geo}
    for start in (0, 17):
        sums, nf = profile_path(lib, args.batch, start, dev)
        per = {p.strip(): sums[i] / (args.batch * nf)
               for i, p in enumerate(PHASES) if p}
        result[f"start {start}"] = per
        print(f"K1 start {start}, B={args.batch}, {nf} frames [{smi}]: SM "
              "cycles per stream and frame: " + ", ".join(
                  f"{p} {v:.0f}" for p, v in per.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
