"""Kernel K3's CUDA source (opus_tpu_torch/csrc/celt_enc_frame.cu) compiled
as host C++ and run one lane at a time on the CPU, against the plain torch
symbol pass (encode_frame_plain) on the same inputs: the stored JAX front
end outputs of the encoder fixture (8 streams x 8 frames) and hard lanes
from the port's own front end (digital silence, full-scale white noise,
clipped input up to |x| = 4, a DC step, impulses, 1e-7-level noise;
chip_smoke.hard_signals, the hard lanes of the on-card check).

A shim header defines the CUDA qualifiers away and gives __clz a host
meaning; the extern "C" launch section is left out and the kernel body is
called once per lane.  -ffp-contract=off mirrors nvcc's -fmad=false (the
wrap taps use explicit fmaf, as on the card).  Payload bytes, final range,
error flag and every integer output must be identical; the float outputs
(energy memory, energy error, delayed_intra) are the same f32 operations
in the same order, so they must be identical too.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import hard_signals
from opus_tpu_torch.models import celt_enc_fused as EF
from opus_tpu_torch.models import celt_enc_kernel as CK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "celt_enc_frame.cu")
FIXTURE = os.path.join(REPO, "tests", "data", "torch_celt20ms_64k_enc.npz")

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
static inline int __clz(uint32_t v) { return v ? __builtin_clz(v) : 32; }
"""

HARNESS = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
extern "C" void run_lanes(const void *X_t, const void *fin, const void *iin,
    const void *itab, const void *ftab, void *payload, void *fout,
    void *iout, int B, int nbytes) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int l = 0; l < B; l++) {
    blockIdx.x = l;
    celt_enc_frame_kernel((const float *)X_t, (const float *)fin,
        (const int32_t *)iin, (const int32_t *)itab, (const float *)ftab,
        (uint8_t *)payload, (float *)fout, (int32_t *)iout, B, nbytes);
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
                       ("harness.cpp", HARNESS)):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    lib = os.path.join(tmp, "libk3host.so")
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(tmp), "-o", lib, os.path.join(tmp, "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


def fixture_inputs(f: int):
    """The JAX front end's outputs of fixture frame f: (X, ins)."""
    fx = np.load(FIXTURE)
    ins = {k: torch.as_tensor(fx["in_" + k][f]) for k in CK.FIN_KEYS}
    for k in CK.IIN_KEYS[1:]:
        ins[k] = torch.as_tensor(fx["in_" + k][f]).to(torch.int64)
    ins["silence"] = torch.as_tensor(fx["fr_silence"][f]).to(torch.int64)
    return torch.as_tensor(fx["X"][f]), ins


def hard_inputs(n_lanes: int, seed: int = 5, nframes: int = 2):
    """(X, ins) of the hard lanes' last frame from the port's front end
    (state carried by the plain chain)."""
    tabs = CK.enc_tabs()
    sig = torch.as_tensor(hard_signals(n_lanes, nframes,
                                       np.random.default_rng(seed)))
    state = EF.fused_celt_enc_init(n_lanes, tabs, "cpu")
    for f in range(nframes):
        ins, X, front = CK._front_end(sig[:, f * 960:(f + 1) * 960], state,
                                      tabs, 160)
        if f + 1 < nframes:
            out = CK.encode_frame_plain(X, ins, tabs, 160)
            state = CK._assemble_state(state, front, out)
    return X, ins


def run_k3_host(lib, X, ins, nbytes=160):
    tabs = CK.enc_tabs()
    b = X.shape[0]
    itab, ftab = tabs.kernel_tables()
    x_t = np.ascontiguousarray(X.numpy().T, np.float32)
    fin = np.ascontiguousarray(np.concatenate(
        [ins[k].reshape(b, -1).numpy().astype(np.float32)
         for k in CK.FIN_KEYS], axis=1).T)
    iin = np.ascontiguousarray(np.concatenate(
        [ins[k].reshape(b, -1).numpy().astype(np.int32)
         for k in CK.IIN_KEYS], axis=1).T)
    payload = np.zeros((b, nbytes), np.uint8)
    fout = np.zeros((2 * tabs.nb + 1, b), np.float32)
    iout = np.zeros((len(CK.INT_OUT) + 3, b), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
    lib.run_lanes(ptr(x_t), ptr(fin), ptr(iin), ptr(itab), ptr(ftab),
                  ptr(payload), ptr(fout), ptr(iout), b, nbytes)
    nb = tabs.nb
    res = {k: iout[j].astype(np.int64) for j, k in enumerate(CK.INT_OUT)}
    k = len(CK.INT_OUT)
    res.update(payload=payload, rng=iout[k].astype(np.int64) & 0xFFFFFFFF,
               err=iout[k + 1].astype(np.int64), old_e=fout[:nb].T,
               error=fout[nb:2 * nb].T, delayed_intra=fout[2 * nb])
    return res


def _check(got, ref):
    for k in ("payload", "rng", "err") + CK.INT_OUT + (
            "old_e", "error", "delayed_intra"):
        r = ref[k].numpy()
        bad = np.nonzero((got[k] != r).reshape(len(r), -1).any(axis=1))[0]
        assert bad.size == 0, (k, bad[:8].tolist())


def test_torch_k3_source_on_host_matches_plain(tmp_path):
    lib = _build(str(tmp_path))
    tabs = CK.enc_tabs()
    for f in (0, 3, 6):
        X, ins = fixture_inputs(f)
        _check(run_k3_host(lib, X, ins),
               CK.encode_frame_plain(X, ins, tabs, 160))
    X, ins = hard_inputs(24)
    ref = CK.encode_frame_plain(X, ins, tabs, 160)
    _check(run_k3_host(lib, X, ins), ref)
    assert ins["silence"].any() and (ins["is_transient"] != 0).any()
