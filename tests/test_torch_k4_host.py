"""Kernel K4's CUDA source (opus_tpu_torch/csrc/silk_lpc.cu) compiled as
host C++ and run one lane at a time on the CPU, against the plain torch
version (ops/lpc.py:lpc_subframe_plain) on the same inputs: random
coefficients, states and residuals at sf 40, 60 and 80 (orders 10 and
16), and saturating residuals and states.

A shim header defines the CUDA qualifiers away; the extern "C" launch
section is left out and the kernel body is called once per lane.
-ffp-contract=off mirrors nvcc's -fmad=false.  The card runs the same
source in chip_smoke.py; this test catches logic errors in it where there
is no card.  Outputs and state must be identical.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from opus_tpu_torch.ops.lpc import lpc_subframe_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "silk_lpc.cu")

SHIM = r"""
#pragma once
#include <stdint.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
struct Dim3 { int x; };
static Dim3 blockIdx, blockDim, threadIdx;
"""

HARNESS = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
extern "C" void run_lanes(const int32_t *res, const int32_t *a_rev,
    const int32_t *slpc, int32_t *v, int32_t *slpc_out, int B, int sf,
    int order_half) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int l = 0; l < B; l++) {
    blockIdx.x = l;
    silk_lpc_kernel(res, a_rev, slpc, v, slpc_out, B, sf, order_half);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to compile the CUDA source")
    tmp = str(tmp_path_factory.mktemp("k4host"))
    src = open(SRC).read()
    body = src[:src.index("}  // namespace")]
    for name, text in (("cuda_runtime.h", SHIM), ("body.inc", body),
                       ("harness.cpp", HARNESS)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    out = os.path.join(tmp, "libk4host.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", tmp, "-o", out,
         os.path.join(tmp, "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(out)


def _run(lib, slpc, res, a_rev, order_half):
    b, sf = res.shape
    res32, a32, s32 = (np.ascontiguousarray(x, np.int32)
                       for x in (res, a_rev, slpc))
    v = np.zeros((b, sf), np.int32)
    s_out = np.zeros((b, 16), np.int32)
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
    lib.run_lanes(ptr(res32), ptr(a32), ptr(s32), ptr(v), ptr(s_out),
                  b, sf, order_half)
    return v, s_out


@pytest.mark.parametrize("sf,order", [(40, 10), (60, 10), (80, 16),
                                      (60, 16)])
def test_torch_k4_source_on_host_matches_plain(lib, sf, order):
    rng = np.random.default_rng(sf + order)
    b = 37
    res = rng.integers(-1 << 24, 1 << 24, size=(b, sf))
    a = rng.integers(-32768, 32768, size=(b, 16))
    a[:, :16 - order] = 0                     # reversed: the tail is zero
    slpc = rng.integers(-1 << 27, 1 << 27, size=(b, 16))
    v, s = _run(lib, slpc, res, a, order >> 1)
    vp, sp = lpc_subframe_plain(torch.from_numpy(slpc),
                                torch.from_numpy(res),
                                torch.from_numpy(a), order >> 1)
    assert np.array_equal(v, vp.numpy())
    assert np.array_equal(s, sp.numpy())


@pytest.mark.parametrize("sf", [40, 60, 80])
def test_torch_k4_source_on_host_saturation(lib, sf):
    rng = np.random.default_rng(100 + sf)
    b = 16
    res = rng.choice(np.array([2**31 - 1, -2**31, 0, 12345, -1], np.int64),
                     size=(b, sf))
    a = rng.integers(-32768, 32768, size=(b, 16))
    slpc = rng.choice(np.array([2**31 - 1, -2**31, 2**30, -2**30, 7],
                               np.int64), size=(b, 16))
    v, s = _run(lib, slpc, res, a, 8)
    vp, sp = lpc_subframe_plain(torch.from_numpy(slpc),
                                torch.from_numpy(res),
                                torch.from_numpy(a), 8)
    assert np.array_equal(v, vp.numpy())
    assert np.array_equal(s, sp.numpy())
    assert (v == 2**31 - 1).any() and (v == -2**31).any()
