"""Kernel K5 (the op-cost microbenchmarks) and its plain versions.

- Each plain case of opus_tpu_torch/tools/kbench_ops.py equals the TPU
  tool's case body (tools/kbench_ops.py, imported by path) run under
  jax.lax.fori_loop on the CPU, on seeded int32 lanes, at a few trips with
  the full unroll.  dyn_read8 and page_sweep40 are defined inside the
  tool's main(), so their bodies are restated here from it (:169-190);
  switch5 is held to its closed form (each 5-node round adds 32 x 15).
- K5's CUDA source compiled as host C++ (a shim header defines the CUDA
  qualifiers away, as tests/test_torch_k1_host.py does; -ffp-contract=off
  mirrors -fmad=false) equals the plain version of every case at the full
  trip count.  Both are exact: no tolerance.
"""

import ctypes
import importlib.util
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_tpu_torch.tools import kbench_ops as KB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "kbench_ops.cu")
LANES = 24

# the TPU tool's module-level case bodies, by the port's case names
JAX_CASES = dict(add="case_add", mul_i32="case_mul_i32",
                 mul_u32="case_mul_u32", div_u32="case_div_u32",
                 div_u32_const="case_div_u32_by_const",
                 select="case_select", cmp_add="case_cmp_add",
                 shift_var="case_shift_var", f32_mad="case_f32_mad",
                 clz="case_clz")


@pytest.fixture(scope="module")
def tpu_tool():
    """tools/kbench_ops.py, imported by path; it sets the JAX compilation
    cache directory when imported, so the old value is put back."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "tpu_kbench_ops", os.path.join(REPO, "tools", "kbench_ops.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    return mod


def _jax_body(tool, case, aux):
    if case in JAX_CASES:
        return getattr(tool, JAX_CASES[case])(None)
    if case == "dyn_read8":                         # tools/kbench_ops.py:170
        def body(acc, t):
            w = jax.lax.dynamic_slice_in_dim(aux, jnp.minimum(t % 50, 50),
                                             8, axis=0)
            return acc + w[0]
        return body
    pages = [aux[w] for w in range(40)]             # tools/kbench_ops.py:182

    def body(acc, t):
        idx = acc & 31
        out = pages[0]
        for w in range(1, 40):
            out = jnp.where(idx == w, pages[w], out)
        return acc + out
    return body


@pytest.mark.parametrize("case", [c for c in KB.CASES if c != "switch5"])
def test_torch_kbench_plain_equals_jax_case(tpu_tool, case):
    trips = 60 if case == "dyn_read8" else 3     # dyn_read8 wraps t % 50
    x0, aux = KB.make_inputs(case, LANES, seed=5)
    got = KB.run_case_plain(case, x0, aux, trips=trips)
    aux_j = None if aux is None else jnp.asarray(aux.numpy())
    body = _jax_body(tpu_tool, case, aux_j)
    unroll = KB.UNROLL[case]

    def loop(t, acc):
        for _ in range(unroll):
            acc = body(acc, t)
        return acc
    want = jax.jit(lambda x: jax.lax.fori_loop(0, trips, loop, x))(
        jnp.asarray(x0.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want)), case


def test_torch_kbench_switch5_closed_form():
    x0, nodes = KB.make_inputs("switch5", LANES, seed=6)
    got = KB.run_case_plain("switch5", x0, nodes)
    # 80 rounds over the 5 branches, each adding 32 x (1+2+3+4+5)
    assert np.array_equal(got.numpy(), x0.numpy() + 80 * 32 * 15)
    ones = torch.ones(LANES, dtype=torch.int32)
    assert (KB.run_case_plain("switch5", ones, nodes) == 38401).all()


SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __restrict__
struct Dim3 { unsigned x; };
static Dim3 blockIdx, blockDim, threadIdx;
static inline void __syncthreads() {}
static inline int __clz(uint32_t v) { return v ? __builtin_clz(v) : 32; }
static inline float __int2float_rn(int x) { return (float)x; }
static inline int __float2int_rz(float x) { return (int)truncf(x); }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
"""

HARNESS = r"""
#include "cuda_runtime.h"
#include "body.inc"
uint32_t smem[64 * 1024];
}
extern "C" void run_lanes(int which, const int32_t *x0, const int32_t *aux,
                          int32_t *out, int lanes) {
  const Args a = {1u, 3u, 2654435761u, 31u, 1u, 1u, 1.0001f, 1.0f};
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int l = 0; l < lanes; l++) {
    blockIdx.x = l;
    switch (which) {
#define CASE(c) case c: kbench_kernel<c>(x0, aux, out, lanes, a); break;
      CASE(ADD) CASE(MUL_I32) CASE(MUL_U32) CASE(DIV_U32)
      CASE(DIV_U32_CONST) CASE(SELECT) CASE(CMP_ADD) CASE(SHIFT_VAR)
      CASE(F32_MAD) CASE(CLZ) CASE(DYN_READ8) CASE(PAGE_SWEEP40)
      CASE(SWITCH5)
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to compile the CUDA source")
    tmp = str(tmp_path_factory.mktemp("k5host"))
    src = open(SRC).read()
    body = src[:src.index("}  // namespace")]
    for name, text in (("cuda_runtime.h", SHIM), ("body.inc", body),
                       ("harness.cpp", HARNESS)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    lib = os.path.join(tmp, "libk5host.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", tmp, "-o", lib, os.path.join(tmp, "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


@pytest.mark.parametrize("case", KB.CASES)
def test_torch_kbench_source_on_host_matches_plain(host_lib, case):
    x0, aux = KB.make_inputs(case, 16, seed=9)
    want = KB.run_case_plain(case, x0, aux)
    xn = np.ascontiguousarray(x0.numpy())
    an = xn if aux is None else np.ascontiguousarray(aux.numpy())
    out = np.zeros_like(xn)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
    host_lib.run_lanes(KB.CASES.index(case), ptr(xn), ptr(an), ptr(out),
                       len(xn))
    assert np.array_equal(out, want.numpy()), case
