"""Kernel K2's CUDA source (opus_tpu_torch/csrc/deemphasis.cu) compiled as
host C++ with K1's shim (tests/test_torch_k1_host.py) and run on the CPU,
each stream a warp of 32 host threads whose shuffles meet at a barrier,
against the plain de-emphasis (ops/iir.deemphasis_plain) on the same
inputs: every frame length the decoders use (120, 240, 480 and 960
samples) and a ragged one, with full-scale and garbage-sized samples.
The tolerance is chip_smoke.py's K2_REL_TOL bound per stream, 1e-5 *
max|x| / (1 - coef), with max|x| taken over the carried-in memory too
(a stream of zeros after a loud one).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import K2_REL_TOL
from opus_tpu_torch.ops.iir import deemphasis_plain
from tests.test_torch_k1_host import SHIM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "deemphasis.cu")
COEF = 0.85000610

HARNESS = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
__attribute__((aligned(16))) float k2_smem[1 << 14];
extern "C" void run_streams(const float *x, const float *mem, float *y,
                            float *mem_out, int B, int N, float coef) {
  blockDim.x = K2_WARPS * LANES;
  for (int b = 0; b < B; b++) {
    blockIdx.x = b / K2_WARPS;
    std::thread lanes[LANES];
    for (int t = 0; t < LANES; t++)
      lanes[t] = std::thread([=] {
        threadIdx.x = (b % K2_WARPS) * LANES + t;
        deemphasis_kernel(x, mem, y, mem_out, B, N, coef);
      });
    for (auto &th : lanes) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def k2_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to compile the CUDA source")
    tmp = str(tmp_path_factory.mktemp("k2host"))
    src = open(SRC).read()
    body = src[:src.index("}  // namespace")]
    for name, text in (("cuda_runtime.h", SHIM), ("body.inc", body),
                       ("harness.cpp", HARNESS)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    lib = os.path.join(tmp, "libk2host.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-DWARP_LANES=32", "-I", tmp, "-o", lib,
         os.path.join(tmp, "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


@pytest.mark.parametrize("n", [120, 240, 480, 960, 100])
def test_torch_k2_source_on_host_matches_plain(k2_lib, n):
    rng = np.random.default_rng(n)
    b = 10
    x = rng.uniform(-32768, 32768, (b, n)).astype(np.float32)
    x[3] *= 1e4                                   # garbage-lane scale
    x[4] = 0.0
    mem = rng.uniform(-32768, 32768, b).astype(np.float32)
    y = np.zeros_like(x)
    mem_out = np.zeros_like(mem)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
    k2_lib.run_streams(ptr(x), ptr(mem), ptr(y), ptr(mem_out), b, n,
                       ctypes.c_float(COEF))
    y_p, m_p = deemphasis_plain(torch.from_numpy(x), torch.from_numpy(mem),
                                COEF)
    tol = K2_REL_TOL * np.maximum(np.abs(x).max(axis=1),
                                  np.abs(mem)) / (1.0 - COEF)
    assert (np.abs(y - y_p.numpy()).max(axis=1) <= tol).all()
    assert (np.abs(mem_out - m_p.numpy()) <= tol).all()
    assert np.array_equal(mem_out, y[:, -1])
