"""Kernel K3's CUDA source (opus_tpu_torch/csrc/celt_enc_frame.cu) compiled
as host C++ and run on the CPU, against the plain torch symbol pass
(encode_frame_plain) on the same inputs: the stored JAX front end outputs
of the 20 ms and 10 ms (LM 2) encoder fixtures (8 streams x 8 frames, 160
and 80 bytes) and hard lanes from the
port's own front end (digital silence, full-scale white noise, clipped
input up to |x| = 4, a DC step, impulses, 1e-7-level noise;
chip_smoke.hard_signals, the hard lanes of the on-card check), at 160
and at 320 bytes a frame.

K3 runs one warp per stream; its lane width is the macro K3_LANES (32 on
the card).  The builds use K1's shim (tests/test_torch_k1_host.py): at
K3_LANES 1 the CUDA qualifiers are defined away and the warp primitives
are those of a one-lane warp, the kernel called once per stream; at 4 and
32 lanes each lane is a host thread and the primitives meet at a barrier,
so the cross-lane passes (tree sums, the warp argmax of the pulse search,
the CWRS suffix scan, the rotation chains, the carry scan) run on the CPU
too.  The extern "C" launch section is left out.  -ffp-contract=off
mirrors nvcc's -fmad=false (the wrap taps use explicit fmaf, as on the
card).  Payload bytes, final range, error flag and every integer output
must be identical; the float outputs (energy memory, energy error,
delayed_intra) are the same f32 operations in the same order, so they
must be identical too.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import hard_signals
from opus_tpu_torch.celt.modes import get_pulses
from opus_tpu_torch.models import celt_enc_fused as EF
from opus_tpu_torch.models import celt_enc_kernel as CK
from tests.test_torch_k1_host import SHIM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "celt_enc_frame.cu")
FIXTURES = {n: os.path.join(REPO, "tests", "data",
                            f"torch_celt{ms}_64k_enc.npz")
            for n, ms in ((960, "20ms"), (480, "10ms"))}
NBYTES = {960: 160, 480: 80}         # 64 kb/s

HARNESS = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
__attribute__((aligned(16))) unsigned char k3_smem[1 << 16];
extern "C" void run_lanes(const void *X, const void *fin, const void *iin,
    const void *itab, const void *ftab, void *payload, void *fout,
    void *iout, int B, int nbytes) {
  auto run = [=] {
    celt_enc_frame_kernel((const float *)X, (const float *)fin,
        (const int32_t *)iin, (const int32_t *)itab, (const float *)ftab,
        (uint8_t *)payload, (float *)fout, (int32_t *)iout, B, nbytes);
  };
  blockDim.x = K3_LANES;
  for (int l = 0; l < B; l++) {
    blockIdx.x = l;
#if K3_LANES == 1
    threadIdx.x = 0;
    run();
#else
    std::thread lanes[K3_LANES];
    for (int t = 0; t < K3_LANES; t++)
      lanes[t] = std::thread([=] { threadIdx.x = t; run(); });
    for (auto &th : lanes) th.join();
#endif
  }
}
"""


def _build(tmp, lanes=1):
    """K3's source as a host library at lane width ``lanes`` (1: the
    kernel once per stream; more: that many threads per stream)."""
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
         "-pthread", f"-DWARP_LANES={lanes}", f"-DK3_LANES={lanes}",
         "-DK3_WARPS=1", "-I", str(tmp), "-o", lib,
         os.path.join(tmp, "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def k3_lib(tmp_path_factory):
    return _build(str(tmp_path_factory.mktemp("k3host")))


def fixture_inputs(f: int, frame_size: int = 960):
    """The JAX front end's outputs of fixture frame f (64 kb/s): (X,
    ins)."""
    fx = np.load(FIXTURES[frame_size])
    ins = {k: torch.as_tensor(fx["in_" + k][f]) for k in CK.FIN_KEYS}
    for k in CK.IIN_KEYS[1:]:
        ins[k] = torch.as_tensor(fx["in_" + k][f]).to(torch.int64)
    ins["silence"] = torch.as_tensor(fx["fr_silence"][f]).to(torch.int64)
    return torch.as_tensor(fx["X"][f]), ins


def front_inputs(sig, nbytes: int, nframes: int = 2, frame_size: int = 960):
    """(X, ins) of the last of ``nframes`` frames of sig [B, >= nframes *
    frame_size] from the port's front end at ``nbytes``, state carried by
    the plain chain."""
    tabs = CK.enc_tabs(48000, frame_size)
    sig = torch.as_tensor(np.asarray(sig, np.float32))
    state = EF.fused_celt_enc_init(sig.shape[0], tabs, "cpu")
    n = frame_size
    for f in range(nframes):
        ins, X, front = CK._front_end(sig[:, f * n:(f + 1) * n], state,
                                      tabs, nbytes)
        if f + 1 < nframes:
            out = CK.encode_frame_plain(X, ins, tabs, nbytes)
            state = CK._assemble_state(state, front, out)
    return X, ins


def hard_inputs(n_lanes: int, seed: int = 5, nframes: int = 2,
                nbytes: int = 160, frame_size: int = 960):
    """(X, ins) of the hard lanes' last frame from the port's front end."""
    return front_inputs(hard_signals(n_lanes, nframes,
                                     np.random.default_rng(seed),
                                     frame_size),
                        nbytes, nframes, frame_size)


def run_k3_host(lib, X, ins, nbytes=160, frame_size=960):
    tabs = CK.enc_tabs(48000, frame_size)
    b = X.shape[0]
    itab, ftab = tabs.kernel_tables()
    x = np.ascontiguousarray(X.numpy(), np.float32)
    fin = np.ascontiguousarray(np.concatenate(
        [ins[k].reshape(b, -1).numpy().astype(np.float32)
         for k in CK.FIN_KEYS], axis=1))
    iin = np.ascontiguousarray(np.concatenate(
        [ins[k].reshape(b, -1).numpy().astype(np.int32)
         for k in CK.IIN_KEYS], axis=1))
    payload = np.zeros((b, nbytes), np.uint8)
    fout = np.zeros((b, 2 * tabs.nb + 1), np.float32)
    iout = np.zeros((b, len(CK.INT_OUT) + 3), np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
    lib.run_lanes(ptr(x), ptr(fin), ptr(iin), ptr(itab), ptr(ftab),
                  ptr(payload), ptr(fout), ptr(iout), b, nbytes)
    nb = tabs.nb
    res = {k: iout[:, j].astype(np.int64) for j, k in enumerate(CK.INT_OUT)}
    k = len(CK.INT_OUT)
    res.update(payload=payload, rng=iout[:, k].astype(np.int64) & 0xFFFFFFFF,
               err=iout[:, k + 1].astype(np.int64), old_e=fout[:, :nb],
               error=fout[:, nb:2 * nb], delayed_intra=fout[:, 2 * nb])
    return res


def _check(got, ref):
    for k in ("payload", "rng", "err") + CK.INT_OUT + (
            "old_e", "error", "delayed_intra"):
        r = ref[k].numpy()
        bad = np.nonzero((got[k] != r).reshape(len(r), -1).any(axis=1))[0]
        assert bad.size == 0, (k, bad[:8].tolist())


@pytest.mark.parametrize("frame_size", [960, 480])
def test_torch_k3_source_on_host_matches_plain(k3_lib, frame_size):
    tabs = CK.enc_tabs(48000, frame_size)
    nb = NBYTES[frame_size]
    for f in (0, 3, 6):
        X, ins = fixture_inputs(f, frame_size)
        _check(run_k3_host(k3_lib, X, ins, nb, frame_size),
               CK.encode_frame_plain(X, ins, tabs, nb))
    X, ins = hard_inputs(24, nbytes=nb, frame_size=frame_size)
    ref = CK.encode_frame_plain(X, ins, tabs, nb)
    _check(run_k3_host(k3_lib, X, ins, nb, frame_size), ref)
    assert ins["silence"].any() and (ins["is_transient"] != 0).any()


def _rate_lanes(nbytes: int):
    """The encoder fixture's 8 streams and 8 hard lanes, frame 2 of the
    port's front end at ``nbytes``."""
    fx = np.load(FIXTURES[960])
    sig = np.concatenate([fx["pcm"][:, :2, :].reshape(8, -1),
                          hard_signals(8, 2, np.random.default_rng(9))])
    return front_inputs(sig, nbytes)


def test_torch_k3_source_on_host_matches_plain_at_320_bytes(k3_lib):
    """128 kb/s: the digit and end-byte buffers are sized by nbytes (the
    bring-up design's fixed 160-byte buffers dropped the digits past
    164); the port's plain decoder reaches the encoder's final range on
    every unflagged lane."""
    from opus_tpu_torch.models.celt_dec_kernel import (dec_tabs,
                                                       decode_frame_plain)
    tabs = CK.enc_tabs()
    X, ins = _rate_lanes(320)
    ref = CK.encode_frame_plain(X, ins, tabs, 320)
    got = run_k3_host(k3_lib, X, ins, 320)
    _check(got, ref)
    assert not ref["err"][:8].any()
    b = X.shape[0]
    dec = decode_frame_plain(
        ref["payload"], torch.full((b,), 320), torch.zeros(b, tabs.nb),
        torch.zeros(b, tabs.nb), torch.zeros(b, dtype=torch.int64),
        dec_tabs(48000, 960))
    ok = ref["err"] == 0
    assert torch.equal(dec["rng"][ok], ref["rng"][ok])


@pytest.fixture(scope="module")
def thread_libs(tmp_path_factory):
    """K3 built at a lane width, once per width for the module."""
    built = {}

    def get(lanes):
        if lanes not in built:
            built[lanes] = _build(str(tmp_path_factory.mktemp(
                f"k3host{lanes}")), lanes)
        return built[lanes]
    return get


@pytest.mark.parametrize("frame_size", [960, 480])
@pytest.mark.parametrize("lanes", [4, 32])
def test_torch_k3_source_on_host_threads_matches_plain(thread_libs, lanes,
                                                       frame_size):
    """K3 at lane width 4 and at the card's 32, each lane a host thread:
    the tree sums, the pulse search's warp argmax, the CWRS suffix scan,
    the rotation chains and the carry scan give the plain version's
    outputs on fixture lanes at 20 and 10 ms (64 kb/s), and on fixture and
    hard lanes at 320 bytes (20 ms)."""
    lib = thread_libs(lanes)
    tabs = CK.enc_tabs(48000, frame_size)
    nb = NBYTES[frame_size]
    X, ins = fixture_inputs(3, frame_size)
    _check(run_k3_host(lib, X, ins, nb, frame_size),
           CK.encode_frame_plain(X, ins, tabs, nb))
    if frame_size != 960:
        return
    X, ins = _rate_lanes(320)
    _check(run_k3_host(lib, X, ins, 320),
           CK.encode_frame_plain(X, ins, tabs, 320))


def test_torch_k3_lane_width_is_one_macro_the_shim_sets():
    """The lane width is the one macro K3_LANES, defaulting to a warp (32)
    and guarded so that a build can set it; the launcher's block size and
    the grid follow it, no other tuning macro exists, and no literal lane
    count or full-warp mask is written anywhere else."""
    src = open(SRC).read()
    assert src.count("#define K3_LANES") == 1
    assert "#ifndef K3_LANES\n#define K3_LANES 32" in src
    assert "constexpr int LANES = K3_LANES;" in src
    assert "(B + WARPS - 1) / WARPS, WARPS * LANES" in src
    assert "__launch_bounds__(WARPS * LANES, 1)" in src
    assert set(re.findall(r"#(?:ifndef|ifdef) (\w+)", src)) == {
        "K3_LANES", "K3_WARPS", "K3_PROFILE"}
    assert "MAX_BYTES" not in src
    body = src.replace("#define K3_LANES 32", "")
    lane_math = re.findall(r"(?:[%/&]|\+=)\s*(?:32|31|64)\b", body)
    assert not lane_math, lane_math
    assert body.count("0xffffffffu") == 1     # FULL, defined once


def test_torch_k3_band_bounds_hold_at_any_rate():
    """K3's fixed bounds do not depend on nbytes: a band is at most NMAX
    wide, the pulse cache's top row (the most pulses a leaf can take,
    since a node with more bits splits) is at most MAX_K pulses, and the
    rotation table covers every k < n / 2.  Its shared memory at the
    largest Opus frame (1275 bytes) fits a block of the card, and its
    table's sections are 16-byte aligned."""
    tabs = CK.enc_tabs()
    assert max(tabs.band_n) == CK.NMAX
    top = max(int(get_pulses(row[0])) for row in tabs.cache_rows.values()
              if row)
    assert top <= CK.MAX_K
    assert CK.NMAX // 2 <= CK.MAX_K
    src = open(SRC).read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["NMAX"]) == CK.NMAX and int(consts["MAX_K"]) == \
        CK.MAX_K
    # WarpMem: X row, five NMAX float/int buffers, the 8 x 8 stack words;
    # then the digits and end bytes, each rounded up to 16 bytes
    warp = 4 * (int(consts["NX_MAX"]) + 5 * CK.NMAX + 8 * 8)
    nbytes = 1275
    warp += -(-(2 * (nbytes + 4)) // 16) * 16 + -(-(nbytes + 1) // 16) * 16
    assert 16 * warp + 64 <= 232448     # 16 warps, the offsets: 227 KB
    # every table section starts 16-byte aligned (K3 reads the wrap taps'
    # columns as int4)
    itab, _ftab = tabs.kernel_tables()
    assert all(int(o) % 4 == 0 for o in itab[6:6 + len(CK.ETabs.KSECTIONS)])
