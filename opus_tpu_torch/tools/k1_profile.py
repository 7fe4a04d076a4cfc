"""Where kernel K1's (or K3's) time goes, by phase, on the card.

Builds the kernel's source alone with its profile macro (``-DK1_PROFILE``
for ``csrc/celt_dec_frame.cu``, ``-DK3_PROFILE`` for
``csrc/celt_enc_frame.cu``): lane 0 of every warp then adds the SM clock
cycles (``clock64``) of each phase of the symbol pass into a device
counter; the port's own build compiles none of it.  K1: the CELT decoder
(start band 0) and the hybrid decoder (start band 17, continuing SILK's
range decoder) run the decode and hybrid fixtures' 8 frames; K3: the
encoder runs the encode fixture's 8 frames at ``--nbytes``.  The
fixture's streams are tiled over ``--batch`` streams on the card, state
carried; on every frame the profile build is launched on the same inputs
as the port's kernel, its outputs must equal the kernel's exactly, and
its cycles are summed.  Prints the SM cycles per stream and frame of
each phase, averaged over the 8 frames, and, last, one JSON line.

    python -m opus_tpu_torch.tools.k1_profile [--kernel k1|k3]
        [--batch 4096] [--nbytes 160]

Run from the repository root on a machine with the card.  A block holds
16 streams (``K1_WARPS``, ``K3_WARPS``) and one block runs per SM, so
``--batch 8`` runs 2 warps on each of one SM's 4 schedulers and
``--batch 16`` 4, as every SM has at 4096: the chain's length against
the warps sharing a scheduler.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the PROF_ADD slots of each source; the indented ones are parts of the
# band loop.  K1: the band tree is its split nodes (theta), its leaves'
# symbols, then the leaves built (cwrsi and the float passes,
# exp_rotation among them).  K3: the theta nodes (their tree sums, theta
# and the swap), each leaf's rotation, pulse search and CWRS index, and
# the band's wrap taps
PHASES = {
    "k1": ("setup", "header+coarse", "tf/spread/dynalloc/trim",
           "allocation", "fine", "band loop", "finalise+anti-collapse",
           "outputs", "  leaves built", "    exp_rotation",
           "  leaf symbols", "  theta nodes", "  band tree (all)", "",
           "kernel total"),
    "k3": ("setup", "header+coarse", "tf/spread/dynalloc/trim",
           "allocation", "fine", "band loop", "finalise+carry",
           "outputs", "  theta nodes", "  rotation", "  PVQ search",
           "  encode_pulses", "  band setup (wrap)", "", "kernel total"),
}
NPROF = 16
SOURCES = {"k1": ("celt_dec_frame", "K1_PROFILE"),
           "k3": ("celt_enc_frame", "K3_PROFILE")}


def build_profile(kernel: str = "k1"):
    """The kernel's source alone with its profile macro -> (ctypes library
    with the kernel's argument types and its profile reader set, nvcc's
    ptxas lines for the kernel)."""
    from opus_tpu_torch import cuda_build

    name, macro = SOURCES[kernel]
    src = cuda_build.CSRC / f"{name}.cu"
    out = cuda_build.BUILD_DIR / f"{kernel}_profile.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build._nvcc(), *cuda_build.FLAGS, "-shared", f"-D{macro}",
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stderr}")
    bind = getattr(cuda_build, f"bind_{name}")
    lib = bind(ctypes.CDLL(str(out)))
    reader = getattr(lib, f"opus_{name}_profile")
    reader.argtypes = [ctypes.c_void_p]
    reader.restype = ctypes.c_int
    ptxas = [ln.strip() for ln in proc.stderr.splitlines()
             if "Used" in ln or "stack frame" in ln]
    return lib, reader, ptxas


def _profiled(run_kernel, run_profile, reader, sums):
    """A frame function: the port's kernel, then the profile build on the
    same inputs with its counters zeroed before and read after; the
    build's outputs must equal the kernel's."""
    import numpy as np
    import torch

    counts = (ctypes.c_ulonglong * NPROF)()

    def frame_fn(*args):
        ref = run_kernel(*args)
        torch.cuda.synchronize()
        reader(counts)                                 # zero the counters
        got = run_profile(*args)
        torch.cuda.synchronize()
        if reader(counts) != 0:
            raise RuntimeError("reading the profile counters failed")
        for k, v in ref.items():
            if not torch.equal(got[k], v):
                raise RuntimeError(f"profile build differs from the "
                                   f"kernel: {k}")
        sums[:] += np.asarray(list(counts), np.float64)
        return ref

    return frame_fn


def profile_path(lib, reader, batch: int, start: int, dev) -> tuple:
    """K1: one 8-frame chain at ``start`` (0: CELT decode, 17: hybrid) ->
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
    frame_fn = _profiled(CK.decode_frame, lambda *a: CK._decode_frame_cuda(
        *a, lib=lib), reader, sums)
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


def profile_encode(lib, reader, batch: int, nbytes: int, dev) -> tuple:
    """K3: the encoder over the encode fixture's 8 frames at ``nbytes`` ->
    (cycle sums per slot over all frames and streams, frames)."""
    import numpy as np
    import torch

    from opus_tpu_torch.models import celt_enc_kernel as EK
    from opus_tpu_torch.models.celt_enc_fused import fused_celt_enc_init

    fx = np.load(REPO / "tests" / "data" / "torch_celt20ms_64k_enc.npz")
    pcm = fx["pcm"]                                 # [ns, F, 960]
    idx = np.arange(batch) % pcm.shape[0]
    sums = np.zeros(NPROF, np.float64)
    frame_fn = _profiled(EK.encode_frame, lambda *a: EK._encode_frame_cuda(
        *a, lib=lib), reader, sums)
    tabs = EK.enc_tabs()
    state = fused_celt_enc_init(batch, tabs, dev)
    for f in range(pcm.shape[1]):
        x = torch.from_numpy(pcm[idx, f]).to(dev)
        _p, _r, _e, state = EK.kernel_celt_encode_frame(x, state, tabs,
                                                        nbytes, frame_fn)
    return sums, pcm.shape[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="k1")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--nbytes", type=int, default=160,
                    help="K3's bytes a frame")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k1_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models import celt_enc_kernel as EK

    dev = torch.device("cuda", 0)
    cuda_build.library()
    lib, reader, ptxas = build_profile(args.kernel)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    name = args.kernel.upper()
    geo = CK.geometry(160) if args.kernel == "k1" else \
        EK.geometry(args.nbytes)
    print(f"card: {smi}; {name} geometry {geo}; profile build ptxas: "
          + " | ".join(ptxas))
    result = {"card": smi, "kernel": name, "batch": args.batch,
              "geometry": geo}
    if args.kernel == "k1":
        runs = [(f"start {start}", lambda start=start: profile_path(
            lib, reader, args.batch, start, dev)) for start in (0, 17)]
    else:
        runs = [(f"nbytes {args.nbytes}", lambda: profile_encode(
            lib, reader, args.batch, args.nbytes, dev))]
    for label, run in runs:
        sums, nf = run()
        per = {p.strip(): sums[i] / (args.batch * nf)
               for i, p in enumerate(PHASES[args.kernel]) if p}
        result[label] = per
        print(f"{name} {label}, B={args.batch}, {nf} frames [{smi}]: SM "
              "cycles per stream and frame: " + ", ".join(
                  f"{p} {v:.0f}" for p, v in per.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
