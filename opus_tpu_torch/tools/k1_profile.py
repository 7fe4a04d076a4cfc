"""Where kernel K1's, K3's or K4's time goes, by phase, on the card.

Builds the kernel's source alone with its profile macro (``-DK1_PROFILE``
for ``csrc/celt_dec_frame.cu``, ``-DK3_PROFILE`` for
``csrc/celt_enc_frame.cu``, ``-DK4_PROFILE`` for ``csrc/silk_lpc.cu``):
lane 0 of every warp then adds the SM clock cycles (``clock64``) of each
phase into a device counter; the port's own build compiles none of it.
K1: the CELT decoder (start band 0) and the hybrid decoder (start band
17, continuing SILK's range decoder) run the decode and hybrid fixtures'
8 frames; K3: the encoder runs the encode fixture's 8 frames at
``--nbytes``; K4: the SILK decoder runs the SILK fixture's 8 frames (4
subframes of 80 samples each).  The fixture's streams are tiled over
``--batch`` streams on the card, state carried; on every launch the
profile build runs on the same inputs as the port's kernel, its outputs
must equal the kernel's exactly, and its cycles are summed.  Prints the
SM cycles per stream and frame (K4: per stream and launch, and per
sample of the recursion) of each phase, and, last, one JSON line.

K4 also gets, at ``--batch`` and 4 x ``--batch`` streams on the first
main-path subframe: the device time (``tools/device_time.py``) of builds
at 32, 64 and 128 threads a block (``-DK4_THREADS``) and of ``--baseline``
(other sources of the same entry point, e.g. an earlier commit's), each
held to the port's outputs; and, from ``cuobjdump -sass`` of the sf-80
kernel, the instructions per sample of the recursion loop and the
longest dependency chain from one sample's stored v to the next (the
SASS goes to ``.torch_build/k4_sass_sf80.txt``).

    python -m opus_tpu_torch.tools.k1_profile [--kernel k1|k3|k4]
        [--batch 4096] [--nbytes 160] [--baseline SRC ...]

Run from the repository root on a machine with the card.  A K1/K3 block
holds 16 streams (``K1_WARPS``, ``K3_WARPS``) and one block runs per SM,
so ``--batch 8`` runs 2 warps on each of one SM's 4 schedulers and
``--batch 16`` 4, as every SM has at 4096: the chain's length against
the warps sharing a scheduler.  K4 runs one thread per stream, so
``--batch 16`` is one warp alone on the card, as every warp is alone on
its scheduler at 4096.
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
    "k4": ("staging in", "recursion", "write-back", "kernel total"),
}
NPROF = 16
SOURCES = {"k1": ("celt_dec_frame", "K1_PROFILE"),
           "k3": ("celt_enc_frame", "K3_PROFILE"),
           "k4": ("silk_lpc", "K4_PROFILE")}
K4_THREADS = (32, 64, 128)


def build_alone(src, tag: str, defines=()) -> tuple:
    """One CUDA source alone as a shared library -> (its path, nvcc's
    ptxas lines)."""
    from opus_tpu_torch import cuda_build

    out = cuda_build.BUILD_DIR / f"{tag}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build._nvcc(), *cuda_build.FLAGS, "-shared",
           *(f"-D{d}" for d in defines), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stderr}")
    ptxas = [ln.strip() for ln in proc.stderr.splitlines()
             if "Used" in ln or "stack frame" in ln]
    return out, ptxas


def build_profile(kernel: str = "k1"):
    """The kernel's source alone with its profile macro -> (ctypes library
    with the kernel's argument types and its profile reader set, nvcc's
    ptxas lines for the kernel)."""
    from opus_tpu_torch import cuda_build

    name, macro = SOURCES[kernel]
    out, ptxas = build_alone(cuda_build.CSRC / f"{name}.cu",
                             f"{kernel}_profile", [macro])
    bind = getattr(cuda_build, f"bind_{name}")
    lib = bind(ctypes.CDLL(str(out)))
    reader = getattr(lib, f"opus_{name}_profile")
    reader.argtypes = [ctypes.c_void_p]
    reader.restype = ctypes.c_int
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
        pairs = ref.items() if isinstance(ref, dict) else enumerate(ref)
        for k, v in pairs:
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


def profile_silk(lib, reader, batch: int, dev) -> tuple:
    """K4: the SILK decoder over the SILK fixture's 8 frames -> (cycle sums
    per slot over all launches and warps, launches, subframe length, the
    first launch's inputs)."""
    import numpy as np
    import torch

    from opus_tpu_torch.models import batched_silk as BS
    from opus_tpu_torch.models import fused_silk_dec as PF
    from opus_tpu_torch.ops import lpc

    fx = np.load(REPO / "tests" / "data" / "torch_silk16k_24k.npz")
    frames, lens = fx["frames"], fx["lens"]         # [ns, F, P], [ns, F]
    idx = np.arange(batch) % frames.shape[0]
    sums = np.zeros(NPROF, np.float64)
    run = _profiled(lpc.lpc_subframe, lambda *a: lpc._lpc_subframe_cuda(
        *a, lib=lib), reader, sums)
    first, sfs = [], []

    def spy(slpc, res, a_rev, order_half):
        if not first:
            first.append((slpc.clone(), res.clone(), a_rev.clone(),
                          order_half))
        sfs.append(res.shape[1])
        return run(slpc, res, a_rev, order_half)

    dec = PF.FusedSilkDecoder(batch, device=dev,
                              max_payload=frames.shape[2])
    saved = BS.lpc_subframe
    BS.lpc_subframe = spy
    try:
        for f in range(frames.shape[1]):
            dec.decode_packed(torch.from_numpy(frames[idx, f]).to(dev),
                              torch.from_numpy(lens[idx, f]).to(dev))
    finally:
        BS.lpc_subframe = saved
    return sums, len(sfs), sfs[0], first[0]


def k4_sweep(inputs, baseline, dev) -> dict:
    """K4's device time at B and 4 x B streams on ``inputs`` (slpc, res,
    a_rev, order_half) for a build at each of K4_THREADS threads a block
    and for each ``baseline`` source; every build's outputs must equal the
    port's kernel's."""
    import torch

    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.ops import lpc
    from opus_tpu_torch.tools.device_time import device_ms

    slpc, res, a_rev, oh = inputs
    big = tuple(x.repeat(4, 1) for x in (slpc, res, a_rev))
    builds = {f"T={t}": (cuda_build.CSRC / "silk_lpc.cu", [f"K4_THREADS={t}"])
              for t in K4_THREADS}
    for i, src in enumerate(baseline or ()):
        builds[f"baseline {i}"] = (Path(src), [])
    out = {}
    for label, (src, defines) in builds.items():
        path, ptxas = build_alone(
            src, "k4_" + label.replace("=", "").replace(" ", ""), defines)
        lib = cuda_build.bind_silk_lpc(ctypes.CDLL(str(path)))
        row = {"ptxas": ptxas}
        for name, args in (("B", (slpc, res, a_rev)), ("4B", big)):
            want = lpc.lpc_subframe(*args, oh)
            got = lpc._lpc_subframe_cuda(*args, oh, lib=lib)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"K4 build {label} differs from the port's "
                                   f"kernel at {name}")
            row[f"ms_{name}"] = device_ms(
                lambda: lpc._lpc_subframe_cuda(*args, oh, lib=lib),
                "silk_lpc_kernel")
        out[label] = row
    return out


def _sass_ops(text: str) -> list:
    """cuobjdump -sass text -> [(opcode, dest registers, source registers,
    index of the branch target, stall cycles)] in program order;
    predicates count as registers.  The stall is the count of cycles the compiler
    schedules before the warp's next instruction, from the instruction's
    control bits (bits 41-44 of its second word, printed on the line
    below it)."""
    import re

    reg = re.compile(r"(?<![\w.])!?(R\d+|P\d|UR\d+|UP\d)(?![\w])")
    stores = ("ST", "RED", "BRA", "BAR", "EXIT", "NOP", "RET", "CALL",
              "MEMBAR", "DEPBAR", "WARPSYNC", "BSYNC", "BSSY")
    ops, labels, addrs = [], {}, {}
    stall = []
    for line in text.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ops)
            continue
        ctl = re.fullmatch(r"\s*/\* (0x[0-9a-f]{16}) \*/\s*", line)
        if ctl and len(stall) == len(ops) - 1:
            stall.append((int(ctl.group(1), 16) >> 41) & 0xF)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if not m:
            continue
        addrs[int(m.group(1), 16)] = len(ops)
        ins = m.group(2).strip()
        guard = []
        if ins.startswith("@"):
            g, ins = ins.split(None, 1)
            guard = [g.lstrip("@!")]
        op, _, rest = ins.partition(" ")
        args = [a.strip() for a in rest.split(",")] if rest else []
        ndest = 0 if op.split(".")[0].startswith(stores) else (
            2 if op.startswith(("ISETP", "PLOP3", "FSETP")) else 1)
        if ndest == 1:      # a carry or predicate written beside the result
            while ndest < len(args) and re.fullmatch(r"P\d|PT",
                                                     args[ndest]):
                ndest += 1
        dests = [r for a in args[:ndest] for r in reg.findall(a)]
        srcs = guard + [r for a in args[ndest:] for r in reg.findall(a)]
        tgt = re.search(r"\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", rest) \
            if op.startswith("BRA") else None
        ops.append((op, dests, srcs,
                    tgt and (tgt.group(1) or int(tgt.group(2), 16))))
    index = {**labels, **addrs}
    stall += [0] * (len(ops) - len(stall))
    return [(o, d, s_, index.get(t), st)
            for (o, d, s_, t), st in zip(ops, stall)]


def k4_sass(lib_path, unroll: int = 20) -> dict:
    """The sf-80 kernel's recursion loop in the SASS of ``lib_path``:
    instructions and IMAD.HI per sample, and per pair of consecutive
    samples the longest chain of dependent instructions from the one
    that makes v[n-1] (the value its STS stores) to the one that makes
    v[n]."""
    import re

    from opus_tpu_torch import cuda_build

    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if f.startswith("_Z")
                and "silk_lpc_kernelILi80" in f.split("\n", 1)[0])
    (cuda_build.BUILD_DIR / "k4_sass_sf80.txt").write_text(body)
    return sass_chain(body, unroll)


def sass_chain(body: str, unroll: int) -> dict:
    ops = _sass_ops(body)
    # the sample loop: the backward branch whose body holds `unroll` STS
    loop = None
    for i, (op, _d, _s, tgt, _st) in enumerate(ops):
        if op.startswith("BRA") and tgt is not None and tgt < i and sum(
                o[0].startswith("STS") for o in ops[tgt:i]) == unroll:
            loop = (tgt, i)
    if loop is None:
        return {"error": "no loop with one STS per sample found"}
    seg = ops[loop[0]:loop[1] + 1]
    last, v_def = {}, []
    for i, (op, dests, srcs, _t, _st) in enumerate(seg):
        if op.startswith("STS"):
            v_def.append(last.get(srcs[-1]))
        for r in dests:
            last[r] = i
    chains = []
    for a, b in zip(v_def, v_def[1:]):
        if a is None or b is None:
            continue
        dist, defs = {a: 0}, {}
        for i, (op, dests, srcs, _t, _st) in enumerate(seg):
            if i > a:
                d = [dist[defs[r]] for r in srcs
                     if r in defs and defs[r] in dist]
                if d:
                    dist[i] = max(d) + 1
            for r in dests:
                defs[r] = i
        chains.append(dist.get(b))
    return {"instructions_per_sample": len(seg) / unroll,
            "scheduled_cycles_per_sample": sum(o[4] for o in seg) / unroll,
            "imad_hi_per_sample": sum(o[0].startswith("IMAD.HI")
                                      for o in seg) / unroll,
            "chain_per_sample": chains,
            "opcodes_per_sample": _histogram([o[0] for o in seg], unroll)}


def _histogram(names, per: int) -> dict:
    out = {}
    for n in names:
        out[n] = out.get(n, 0) + 1
    return {k: v / per for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def main_k4(args, dev, smi) -> int:
    from opus_tpu_torch import cuda_build
    from opus_tpu_torch.ops import lpc

    lib, reader, ptxas = build_profile("k4")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip()
    max_mhz = float(clocks.split(",")[1])
    geo = lpc.geometry(80)
    print(f"card: {smi}; SM clock now, max (MHz): {clocks}; K4 geometry at "
          f"sf 80 {geo}; profile build ptxas: " + " | ".join(ptxas))
    result = {"card": smi, "kernel": "K4", "clocks_mhz": clocks,
              "geometry": geo}
    for batch in (16, args.batch):
        sums, n, sf, first = profile_silk(lib, reader, batch, dev)
        warps = (batch + 31) // 32
        per = {p: sums[i] / (warps * n)
               for i, p in enumerate(PHASES["k4"])}
        per["recursion per sample"] = per["recursion"] / sf
        # the recursion alone at the card's top SM clock: the floor that
        # the per-sample work sets, beside the bytes bound
        per["recursion us at max clock"] = per["recursion"] / max_mhz
        result[f"B={batch}"] = per
        print(f"K4 B={batch}, {n} launches of sf {sf} [{smi}]: SM cycles per "
              "stream and launch: " + ", ".join(f"{p} {v:.1f}"
                                                 for p, v in per.items()))
    result["sweep"] = k4_sweep(first, args.baseline, dev)
    for label, row in result["sweep"].items():
        print(f"K4 {label}: device time {row['ms_B']:.5f} ms at "
              f"B={args.batch}, {row['ms_4B']:.5f} ms at B={4 * args.batch} "
              f"[{smi}]; ptxas: " + " | ".join(row["ptxas"]))
    result["sass"] = k4_sass(cuda_build.library_path())
    print(f"K4 SASS (sf 80, the port's build): {result['sass']}")
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="k1")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--nbytes", type=int, default=160,
                    help="K3's bytes a frame")
    ap.add_argument("--baseline", nargs="*", default=[],
                    help="K4: other sources of its entry point to time")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.kernel == "k4":
        return main_k4(args, dev, smi)
    lib, reader, ptxas = build_profile(args.kernel)
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
