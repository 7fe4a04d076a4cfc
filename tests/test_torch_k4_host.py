"""Kernel K4's CUDA source (opus_tpu_torch/csrc/silk_lpc.cu) compiled as
host C++ and run on the CPU, against the plain torch version
(ops/lpc.py:lpc_subframe_plain) on the same inputs: random coefficients,
states and residuals at sf 40, 60 and 80 (orders 10 and 16), and
saturating residuals and states.

The shim header of tests/test_torch_k1_host.py defines the CUDA qualifiers
away (plus __mulhi in host terms); the extern "C" launch section is left
out and the kernel is called per block.  K4 stages a block's streams
through shared memory, so the block's threads exchange data: the main
build runs blocks of one thread (-DK4_THREADS=1), a second one blocks of
the card's width, one host thread per CUDA thread with __syncthreads as a
barrier and the dynamic shared memory a host array, so the transposing
loads and stores of several threads (and a ragged last block) run on the
CPU too.  -ffp-contract=off mirrors nvcc's -fmad=false.  The card runs
the same source in chip_smoke.py; these tests catch logic errors in it
where there is no card.  Outputs and state must be identical.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from opus_tpu_torch.ops.lpc import lpc_subframe_plain
from opus_tpu_torch.ops.silk_fixed import add_sat32, lshift_sat32, smulwb
from tests.test_torch_k1_host import SHIM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "silk_lpc.cu")
# the card's block width: the source's default K4_THREADS
CARD_THREADS = int(re.search(r"#define K4_THREADS (\d+)",
                             open(SRC).read()).group(1))

K4_SHIM = SHIM + r"""
static inline int __mulhi(int a, int b) {
  return (int)(((long long)a * b) >> 32);
}
"""

HARNESS = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
#include <thread>
__attribute__((aligned(16))) int32_t k4_smem[(80 + 32) * (K4_THREADS + 1)];
extern "C" void run_blocks(const int32_t *res, const int32_t *a_rev,
    const int32_t *slpc, int32_t *v, int32_t *slpc_out, int B, int sf,
    int order_half) {
  auto run = [=] {
    if (sf == 40)
      silk_lpc_kernel<40>(res, a_rev, slpc, v, slpc_out, B, order_half);
    else if (sf == 60)
      silk_lpc_kernel<60>(res, a_rev, slpc, v, slpc_out, B, order_half);
    else
      silk_lpc_kernel<80>(res, a_rev, slpc, v, slpc_out, B, order_half);
  };
  blockDim.x = K4_THREADS;
  for (int blk = 0; blk * K4_THREADS < B; blk++) {
    blockIdx.x = blk;
#if K4_THREADS == 1
    threadIdx.x = 0;
    run();
#else
    std::thread th[K4_THREADS];
    for (int t = 0; t < K4_THREADS; t++)
      th[t] = std::thread([=] { threadIdx.x = t; run(); });
    for (auto &x : th) x.join();
#endif
  }
}
extern "C" void smulwb_by_mulhi(const int32_t *s, const int32_t *a,
                                int32_t *out, int n) {
  for (int i = 0; i < n; i++) out[i] = (int32_t)smlawb(0u, s[i], coef16(a[i]));
}
extern "C" void add_sat_lshift4_n(const int32_t *r, const int32_t *x,
                                  int32_t *out, int n) {
  for (int i = 0; i < n; i++) out[i] = add_sat_lshift4(r[i], (uint32_t)x[i]);
}
"""


def _build(tmp, threads):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to compile the CUDA source")
    src = open(SRC).read()
    body = src[:src.index("}  // namespace")]
    for name, text in (("cuda_runtime.h", K4_SHIM), ("body.inc", body),
                       ("harness.cpp", HARNESS)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    out = os.path.join(tmp, "libk4host.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-Wno-unknown-pragmas", f"-DWARP_LANES={threads}",
         f"-DK4_THREADS={threads}", "-I", tmp, "-o", out,
         os.path.join(tmp, "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(out)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _build(str(tmp_path_factory.mktemp("k4host")), 1)


@pytest.fixture(scope="module")
def lib_block(tmp_path_factory):
    return _build(str(tmp_path_factory.mktemp("k4block")), CARD_THREADS)


def _ptr(x):
    return x.ctypes.data_as(ctypes.c_void_p)


def _run(lib, slpc, res, a_rev, order_half):
    b, sf = res.shape
    res32, a32, s32 = (np.ascontiguousarray(x, np.int32)
                       for x in (res, a_rev, slpc))
    v = np.zeros((b, sf), np.int32)
    s_out = np.zeros((b, 16), np.int32)
    lib.run_blocks(_ptr(res32), _ptr(a32), _ptr(s32), _ptr(v), _ptr(s_out),
                   b, sf, order_half)
    return v, s_out


def _random(sf, order, seed, b):
    rng = np.random.default_rng(seed)
    res = rng.integers(-1 << 24, 1 << 24, size=(b, sf))
    a = rng.integers(-32768, 32768, size=(b, 16))
    a[:, :16 - order] = 0                     # reversed: the tail is zero
    slpc = rng.integers(-1 << 27, 1 << 27, size=(b, 16))
    return slpc, res, a


def _saturating(sf, seed, b):
    rng = np.random.default_rng(seed)
    res = rng.choice(np.array([2**31 - 1, -2**31, 0, 12345, -1], np.int64),
                     size=(b, sf))
    a = rng.integers(-32768, 32768, size=(b, 16))
    slpc = rng.choice(np.array([2**31 - 1, -2**31, 2**30, -2**30, 7],
                               np.int64), size=(b, 16))
    return slpc, res, a


def _check(lib, slpc, res, a, order_half):
    v, s = _run(lib, slpc, res, a, order_half)
    vp, sp = lpc_subframe_plain(torch.from_numpy(slpc),
                                torch.from_numpy(res),
                                torch.from_numpy(a), order_half)
    assert np.array_equal(v, vp.numpy())
    assert np.array_equal(s, sp.numpy())
    return v


@pytest.mark.parametrize("sf,order", [(40, 10), (60, 10), (80, 16),
                                      (60, 16)])
def test_torch_k4_source_on_host_matches_plain(lib, sf, order):
    _check(lib, *_random(sf, order, sf + order, 37), order >> 1)


@pytest.mark.parametrize("sf", [40, 60, 80])
def test_torch_k4_source_on_host_saturation(lib, sf):
    v = _check(lib, *_saturating(sf, 100 + sf, 16), 8)
    assert (v == 2**31 - 1).any() and (v == -2**31).any()


@pytest.mark.parametrize("sf,order", [(40, 10), (60, 16), (80, 16),
                                      (80, 10)])
def test_torch_k4_source_on_host_threads_matches_plain(lib_block, sf, order):
    """Blocks of the card's width, one host thread per CUDA thread; B is
    not a multiple of the width, so the last block is ragged."""
    b = 2 * CARD_THREADS + 5
    _check(lib_block, *_random(sf, order, 7 * sf + order, b), order >> 1)


@pytest.mark.parametrize("sf", [40, 60, 80])
def test_torch_k4_source_on_host_threads_saturation(lib_block, sf):
    v = _check(lib_block, *_saturating(sf, 200 + sf, CARD_THREADS + 3), 8)
    assert (v == 2**31 - 1).any() and (v == -2**31).any()


EDGES32 = np.array([-2**31, -2**31 + 1, -2**31 + 2, -2**16 - 1, -2**16,
                    -2**15 - 1, -2**15, -2**15 + 1, -2, -1, 0, 1, 2,
                    2**15 - 1, 2**15, 2**15 + 1, 2**16, 2**16 + 1,
                    2**27 - 1, 2**27, -2**27, -2**27 - 1, 2**31 - 2,
                    2**31 - 1], np.int64)


def test_torch_k4_smulwb_as_high_multiply_on_edge_values(lib):
    """SMULWB(s, a) = __mulhi(s, a << 16) for every pair of edge values
    (s at and beside +-2^31, +-2^15, +-2^16, 0; a at and beside +-2^15,
    +-1, 0) and 4096 random pairs: the identity the kernel's taps use."""
    a_edges = np.array([-32768, -32767, -16384, -2, -1, 0, 1, 2, 16384,
                        32766, 32767], np.int64)
    s, a = (x.reshape(-1) for x in np.meshgrid(EDGES32, a_edges))
    rng = np.random.default_rng(5)
    s = np.concatenate([s, rng.integers(-2**31, 2**31, 4096)])
    a = np.concatenate([a, rng.integers(-32768, 32768, 4096)])
    want = smulwb(torch.from_numpy(s), torch.from_numpy(a)).numpy()
    assert np.array_equal(want, (s * a) >> 16)
    s32, a32 = s.astype(np.int32), a.astype(np.int32)
    got = np.zeros(len(s), np.int32)
    lib.smulwb_by_mulhi(_ptr(s32), _ptr(a32), _ptr(got), len(s))
    assert np.array_equal(got, want)


def test_torch_k4_saturations_on_edge_values(lib):
    """The kernel's recast ADD_SAT32(r, LSHIFT_SAT32(x, 4)) equals the
    plain helpers' on every pair of edge values (the shift's limits
    +-2^27 and their neighbours, where LSHIFT_SAT32 gives INT32_MAX and
    not the clamped value shifted, and the sum's overflow at +-2^31)."""
    r, x = (v.reshape(-1) for v in np.meshgrid(EDGES32, EDGES32))
    rng = np.random.default_rng(6)
    r = np.concatenate([r, rng.integers(-2**31, 2**31, 4096)])
    x = np.concatenate([x, rng.integers(-2**28, 2**28, 4096)])
    rt, xt = torch.from_numpy(r), torch.from_numpy(x)
    want = add_sat32(rt, lshift_sat32(xt, 4)).numpy()
    r32, x32 = r.astype(np.int32), x.astype(np.int32)
    got = np.zeros(len(r), np.int32)
    lib.add_sat_lshift4_n(_ptr(r32), _ptr(x32), _ptr(got), len(r))
    assert np.array_equal(got, want)


SASS = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
.L_x_3:
        /*0100*/                   LDS R20, [R3] ;          /* 0x0000000003147984 */
                                                            /* 0x000e220000000800 */
        /*0110*/                   IMAD.HI R4, R11, R8, RZ ; /* 0x0000000000000000 */
                                                            /* 0x0000080000000000 */
        /*0120*/                   IMAD.HI R5, R10, R9, R4 ; /* 0x0000000000000000 */
                                                            /* 0x0000060000000000 */
        /*0130*/                   LEA R7, R5, R20, 0x4 ;   /* 0x0000000000000000 */
                                                            /* 0x0000020000000000 */
        /*0140*/                   IADD3 R12, R5, 0x8000000, RZ ; /* 0x0 */
                                                            /* 0x0000020000000000 */
        /*0150*/                   ISETP.GE.U32.AND P1, PT, R12, 0x10000000, PT ;
                                                            /* 0x0000020000000000 */
        /*0160*/               @!P1 SEL R10, R13, R7, P1 ; /* 0x0000000000000000 */
                                                            /* 0x0000020000000000 */
        /*0170*/                   STS [R3], R10 ;          /* 0x0000000000000000 */
                                                            /* 0x0000020000000000 */
        /*0180*/                   IMAD.HI R5, R10, R9, R4 ; /* 0x0000000000000000 */
                                                            /* 0x0000080000000000 */
        /*0190*/                   SEL R10, R13, R5, P1 ;   /* 0x0000000000000000 */
                                                            /* 0x0000020000000000 */
        /*01a0*/                   STS [R3+0x84], R10 ;     /* 0x0000000000000000 */
                                                            /* 0x0000020000000000 */
        /*01b0*/                   BRA `(.L_x_3) ;          /* 0x0000000000000000 */
                                                            /* 0x0000020000000000 */
"""


def test_torch_k4_sass_reader_counts_the_sample_chain():
    """The profile tool's SASS reader on a two-sample loop: per sample
    instructions, IMAD.HI, the stall cycles of the control words, and the
    dependency chain from the first stored v (SEL R10) to the second
    (IMAD.HI R5 -> SEL R10: 2 instructions)."""
    from opus_tpu_torch.tools.k1_profile import sass_chain

    got = sass_chain(SASS, 2)
    assert got["instructions_per_sample"] == 6.0     # LDS .. BRA: 12
    assert got["imad_hi_per_sample"] == 1.5
    # stall fields (bits 41-44): 0x...080... = 4, 0x...060... = 3, else 1
    assert got["scheduled_cycles_per_sample"] == (4 + 3 + 4 + 1 * 9) / 2
    assert got["chain_per_sample"] == [2]
