"""Kernel K1's CUDA source (opus_tpu_torch/csrc/celt_dec_frame.cu) compiled
as host C++ and run one lane at a time on the CPU, against the plain torch
symbol pass (decode_frame_plain) on the same inputs: real 20 ms fixture
packets with random energy memory and seeds, truncated packets and random
bytes.

A shim header defines the CUDA qualifiers away and gives __clz, __ldg and
rsqrtf host meanings; the extern "C" launch section is left out and the
kernel body is called once per lane.  -ffp-contract=off mirrors nvcc's
-fmad=false.  The card runs the same source in chip_smoke.py; this test
catches logic errors in it where there is no card.  Integer outputs must
be identical; X within 1e-5 of each band's maximum and energies within
1e-5 (f32 sums in another order and libm vs torch cos/exp2, a few ULPs).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from opus_tpu_torch.models.celt_dec_kernel import (INT_KEYS, dec_tabs,
                                                   decode_frame_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "celt_dec_frame.cu")
FIXTURE = os.path.join(REPO, "tests", "data", "torch_celt20ms_64k.npz")

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__ static
#define __launch_bounds__(x)
#define __restrict__
struct Dim3 { int x; };
static Dim3 blockIdx, blockDim, threadIdx;
static inline uint32_t __ldg(const uint32_t *p) { return *p; }
static inline int __clz(uint32_t v) { return v ? __builtin_clz(v) : 32; }
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
"""

DRIVER = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
extern "C" void run_lanes(const void *buf, int P, const void *lens,
    const void *old_e, const void *prevmin, const void *seed,
    const void *tab, void *X_t, void *energies, void *ints, void *pf_gain,
    int B, int nx) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int l = 0; l < B; l++) {
    blockIdx.x = l;
    celt_dec_frame_kernel((const uint8_t *)buf, P, (const int32_t *)lens,
        (const float *)old_e, (const float *)prevmin, (const int64_t *)seed,
        (const int32_t *)tab, (float *)X_t, (float *)energies,
        (int32_t *)ints, (float *)pf_gain, B, nx);
  }
}
"""


def _build(tmp):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to compile the CUDA source")
    src = open(SRC).read()
    body = src[:src.index("}  // namespace")]
    for name, text in (("cuda_runtime.h", SHIM), ("body.inc", body),
                       ("driver.cpp", DRIVER)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    lib = os.path.join(tmp, "libk1host.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(tmp), "-o", lib, os.path.join(tmp, "driver.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


def _lanes(rng):
    fx = np.load(FIXTURE)
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    buf = np.zeros((48, p), np.uint8)
    ln = np.zeros(48, np.int64)
    for j in range(48):
        s, f = j % ns, (j // ns) % nf
        if j < 24:                               # real packets
            buf[j], ln[j] = frames[s, f], lens[s, f]
        elif j < 36:                             # truncated packets
            cut = int(rng.integers(0, lens[s, f]))
            buf[j, :cut], ln[j] = frames[s, f, :cut], cut
        else:                                    # random bytes
            cut = int(rng.integers(0, p + 1))
            buf[j, :cut], ln[j] = rng.integers(0, 256, cut), cut
    return buf, ln


def test_torch_k1_source_on_host_matches_plain(tmp_path):
    lib = _build(str(tmp_path))
    tabs = dec_tabs(48000, 960)
    rng = np.random.default_rng(7)
    buf, ln = _lanes(rng)
    b, p = buf.shape
    nb, nx = tabs.nb, tabs.nx
    old_e = rng.normal(0, 4, (b, nb)).astype(np.float32)
    prevmin = rng.normal(0, 4, (b, nb)).astype(np.float32)
    seed = rng.integers(0, 2 ** 32, b).astype(np.int64)
    ref = decode_frame_plain(torch.from_numpy(buf), torch.from_numpy(ln),
                             torch.from_numpy(old_e),
                             torch.from_numpy(prevmin),
                             torch.from_numpy(seed), tabs)
    tab = tabs.kernel_table()
    lens32 = ln.astype(np.int32)
    x_t = np.zeros((nx, b), np.float32)
    energies = np.zeros((b, nb), np.float32)
    ints = np.zeros((b, 9), np.int32)
    pf_gain = np.zeros(b, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
    lib.run_lanes(ptr(buf), p, ptr(lens32), ptr(old_e), ptr(prevmin),
                  ptr(seed), ptr(tab), ptr(x_t), ptr(energies), ptr(ints),
                  ptr(pf_gain), b, nx)
    for j, key in enumerate(INT_KEYS):
        got = ints[:, j].astype(np.int64)
        if key == "rng":
            got &= 0xFFFFFFFF
        assert got.tolist() == ref[key].tolist(), key
    assert np.array_equal(pf_gain, ref["pf_gain"].numpy())
    assert np.abs(energies - ref["energies"].numpy()).max() <= 1e-5
    x, xr = x_t.T, ref["X"].numpy()
    m, eb = tabs.M, tabs.eBands
    for i in range(nb):
        a, c = m * int(eb[i]), m * int(eb[i + 1])
        scale = np.abs(xr[:, a:c]).max(axis=1)
        err = np.abs(x[:, a:c] - xr[:, a:c]).max(axis=1)
        assert (err <= 1e-5 * scale).all(), (i, err.max())
