"""Op-cost microbenchmarks on the card: kernel K5 and its plain versions.

Port of ``tools/kbench_ops.py`` (the Mosaic op-cost microbenchmarks of
the TPU): each case applies one op class ``body(acc, t)`` UNROLL times
per trip for TRIPS trips to every lane's ``acc`` and reports ns per op.
The thirteen cases are those of the TPU tool: add, mul_i32, mul_u32,
div_u32, div_u32_const, select, cmp_add, shift_var, f32_mad, clz,
dyn_read8, page_sweep40 and switch5 (400 nodes, 5 branches of 32 adds).

``run_case`` is the wrapper of kernel K5 (``opus_tpu_torch/csrc/
kbench_ops.cu``, one thread per lane): a CPU tensor runs the case's plain
torch version, a CUDA tensor the kernel or a raise.  The plain versions
hold int32 values in int64 tensors with the int32 wrap made explicit
(``ops/silk_fixed.w32``) and the uint32 views of the TPU cases as
``& 0xFFFFFFFF``, so they equal the kernel exactly.

Two geometries are timed: the TPU's tile (1024 lanes in one block) and
the main path's (4096 lanes in 64-thread blocks, as kernel K1 runs).

Run on the card:  python -m opus_tpu_torch.tools.kbench_ops [case ...]
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..ops.device_cache import const
from ..ops.silk_fixed import M32, clz32, w32

TRIPS = 256
SWITCH_NODES = 400
SWITCH_ADDS = 32
CASES = ("add", "mul_i32", "mul_u32", "div_u32", "div_u32_const", "select",
         "cmp_add", "shift_var", "f32_mad", "clz", "dyn_read8",
         "page_sweep40", "switch5")
# ops per body as tools/kbench_ops.py counts them (its n_ops_per_unroll)
N_OPS = dict(add=1, mul_i32=1, mul_u32=2, div_u32=1, div_u32_const=1,
             select=2, cmp_add=2, shift_var=3, f32_mad=3, clz=2,
             dyn_read8=1, page_sweep40=80)
UNROLL = {c: 64 for c in CASES[:10]}
UNROLL.update(dyn_read8=16, page_sweep40=4)
# (lanes, threads per block): the TPU's [8, 128] tile in one block, and
# the main path's batch in K1's 64-thread blocks
GEOMETRIES = ((1024, 1024), (4096, 64))
# SASS signature of each case: (opcode regex, count expected in the
# kernel when no op of a trip is folded away: one per unrolled body;
# page_sweep40 one compare per page after the first, switch5 one add per
# branch step).  The kernel's trip loop is not unrolled, so the count is
# that of one trip.  An integer add shows as IADD3, VIADD, IMAD or LEA
# (ptxas spreads adds over the ALU and FMA pipes); a division by a
# constant as a high or wide multiply.
_ADD = r"\b(?:IADD3|VIADD|IADD|IMAD|LEA)(?=\s)"
SASS_SIG = dict(
    add=(_ADD, 64), mul_i32=(r"\bIMAD(?=\s)", 64),
    mul_u32=(r"\bIMAD(?=\s)", 64),
    div_u32=(r"\bIMAD\.HI\.U32\b", 64),
    div_u32_const=(r"\bIMAD\.(?:HI|WIDE)(?:\.U32)?\b", 64),
    select=(r"\bISETP\.", 64), cmp_add=(r"\bISETP\.", 64),
    shift_var=(r"\bSHF\.R\.U32\.HI\b", 64), f32_mad=(r"\bFMUL\b", 64),
    clz=(r"\bFLO\.U32\b", 64), dyn_read8=(r"\bLDS\b", 16),
    page_sweep40=(r"\bISETP\.", 4 * 39),
    switch5=(_ADD, 5 * SWITCH_ADDS))

# launches of kernel K5 (counted where the kernel is launched, only there)
launches = 0


def _f32(v: float, dev):
    return const(("kb_f32", v), lambda: np.asarray(v, np.float32), dev)


def _body(case: str, acc, t: int):
    """One op of the case on int32-valued int64 lanes (the TPU case's
    jnp expression, tools/kbench_ops.py:75-133)."""
    if case == "add":
        return w32(acc + 1)
    if case == "mul_i32":
        return w32(acc * 3)
    if case == "mul_u32":
        return w32(acc * 2654435761)
    if case == "div_u32":
        return w32((acc & M32) // (t + 3) + acc)
    if case == "div_u32_const":
        return w32((acc & M32) // 77 + acc)
    if case == "select":
        return torch.where(acc > t, acc, w32(acc + 1))
    if case == "cmp_add":
        return w32(acc + (acc > t).to(torch.int64))
    if case == "shift_var":
        return w32(((acc & M32) >> (acc & 7)) + 1)
    if case == "f32_mad":
        dev = acc.device
        y = acc.to(torch.float32) * _f32(1.0001, dev) + _f32(1.0, dev)
        return y.to(torch.int32).to(torch.int64)
    if case == "clz":
        return w32(clz32(acc) + acc)
    raise ValueError(f"unknown case {case}")


def run_case_plain(case: str, x0, aux=None, trips: int = TRIPS):
    """The plain torch version of one case: x0 [L] int32 lanes; aux [64, L]
    (dyn_read8), [40, L] (page_sweep40) or the [400] node table (switch5).
    Returns the final acc [L] int32."""
    acc = x0.to(torch.int64)
    if case == "switch5":
        # jax.lax.switch over the node table, 32 adds of (branch + 1)
        for j in aux.tolist()[:SWITCH_NODES]:
            for _ in range(SWITCH_ADDS):
                acc = w32(acc + (j + 1))
        return acc.to(torch.int32)
    aux = None if aux is None else aux.to(torch.int64)
    for t in range(trips):
        for _ in range(UNROLL[case]):
            if case == "dyn_read8":
                acc = w32(acc + aux[t % 50])
            elif case == "page_sweep40":
                idx = acc & 31
                out = aux[0]
                for w in range(1, 40):
                    out = torch.where(idx == w, aux[w], out)
                acc = w32(acc + out)
            else:
                acc = _body(case, acc, t)
    return acc.to(torch.int32)


def run_case(case: str, x0, aux=None, threads: int = 64,
             trips: int = TRIPS):
    """One run of a case over the lanes of x0 (kernel K5 on the card, in
    blocks of ``threads``)."""
    if x0.device.type == "cpu":
        return run_case_plain(case, x0, aux, trips)
    return _run_case_cuda(case, x0, aux, threads, trips)


def _run_case_cuda(case, x0, aux, threads, trips):
    import ctypes

    from ..cuda_build import check_launch, library

    global launches
    dev = x0.device
    if not x0.is_cuda or (aux is not None and aux.device != dev):
        raise ValueError("run_case: all inputs on one CUDA device")
    if trips != TRIPS:
        raise ValueError(f"run_case: the kernel runs {TRIPS} trips")
    lanes = x0.shape[0]
    need = dict(dyn_read8=(64, lanes), page_sweep40=(40, lanes),
                switch5=(SWITCH_NODES,)).get(case)
    if need is not None and (aux is None or tuple(aux.shape) != need):
        raise ValueError(f"run_case: {case} takes aux {need}")
    x0 = x0.to(torch.int32).contiguous()
    aux = x0 if aux is None else aux.to(torch.int32).contiguous()
    out = torch.empty_like(x0)
    vp = ctypes.c_void_p
    rc = library().opus_kbench_launch(
        CASES.index(case), vp(x0.data_ptr()), vp(aux.data_ptr()),
        vp(out.data_ptr()), lanes, threads,
        vp(torch.cuda.current_stream(dev).cuda_stream))
    check_launch(rc, f"kbench_ops/{case}")
    launches += 1
    return out


def make_inputs(case: str, lanes: int, seed: int = 0, device="cpu"):
    """Seeded inputs: x0 [L] int32 in [-2**20, 2**20) (small enough that
    f32_mad's chain stays exact in int32), aux full-range int32 pages or
    rows, or switch5's node table arange(400) % 5."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(-2 ** 20, 2 ** 20, lanes).astype(np.int32)
    aux = None
    if case == "dyn_read8":
        aux = rng.integers(-2 ** 31, 2 ** 31, (64, lanes)).astype(np.int32)
    elif case == "page_sweep40":
        aux = rng.integers(-2 ** 31, 2 ** 31, (40, lanes)).astype(np.int32)
    elif case == "switch5":
        aux = (np.arange(SWITCH_NODES) % 5).astype(np.int32)
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return t(x0), t(aux)


def ops_per_lane(case: str) -> int:
    """Ops one lane performs in a run, counted as the TPU tool counts."""
    if case == "switch5":
        return SWITCH_NODES * SWITCH_ADDS
    return TRIPS * UNROLL[case] * N_OPS[case]


def dependent_ops(case: str) -> int:
    """Length of one lane's dependent chain in a run (bodies applied)."""
    if case == "switch5":
        return SWITCH_NODES * SWITCH_ADDS
    return TRIPS * UNROLL[case]


def time_case(case: str, x0, aux, threads: int, reps: int = 20) -> float:
    """Milliseconds per launch, CUDA events around ``reps`` launches after
    a warm-up."""
    run_case(case, x0, aux, threads)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        run_case(case, x0, aux, threads)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def table(cases=CASES, device="cuda", reps: int = 20, seed: int = 0):
    """Every case at both geometries on the card: the kernel's output
    against the plain version (exact), and both times.  Returns one dict
    per (case, geometry): case, lanes, threads, ms, ns_per_op (per
    dependent body on one lane), ns_per_counted_op (per op as the TPU tool
    counts), lane_ops_per_s, plain_ms, equal."""
    rows = []
    for case in cases:
        for lanes, threads in GEOMETRIES:
            x0, aux = make_inputs(case, lanes, seed, device)
            got = run_case(case, x0, aux, threads)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            want = run_case_plain(case, x0, aux)
            t1.record()
            torch.cuda.synchronize()
            ms = time_case(case, x0, aux, threads, reps)
            dep = dependent_ops(case)
            rows.append(dict(
                case=case, lanes=lanes, threads=threads, ms=ms,
                ns_per_op=ms * 1e6 / dep,
                ns_per_counted_op=ms * 1e6 / ops_per_lane(case),
                lane_ops_per_s=lanes * ops_per_lane(case) / (ms * 1e-3),
                plain_ms=t0.elapsed_time(t1),
                equal=bool(torch.equal(got, want))))
    return rows


def sass_counts(lib_path) -> dict:
    """Each case's signature instructions in K5's SASS (cuobjdump -sass of
    the built library): {case: (count, expected, its 6 most frequent
    opcodes with their counts)}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    out = {}
    for f in funcs[1:]:
        m = re.match(r"\S*kbench_kernelILi(\d+)E", f)
        if m is None:
            continue
        case = CASES[int(m.group(1))]
        pat, want = SASS_SIG[case]
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", f)
        top = sorted({o: ops.count(o) for o in set(ops)}.items(),
                     key=lambda kv: -kv[1])[:6]
        out[case] = (len(re.findall(pat, f)), want, top)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kbench_ops: no CUDA device", file=sys.stderr)
        return 1
    cases = [c for c in CASES if not argv or c in argv]
    print(f"{torch.cuda.get_device_name(0)}; {TRIPS} trips")
    for r in table(cases):
        print(f"{r['case']:14s} {r['lanes']:5d} lanes / {r['threads']:4d} "
              f"threads: {r['ms']:.4f} ms, {r['ns_per_op']:.3f} ns per "
              f"dependent op, {r['lane_ops_per_s']:.4g} lane-ops/s, "
              f"{'== plain' if r['equal'] else 'DIFFERS from plain'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
