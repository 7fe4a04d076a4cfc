"""Kernel K1's CUDA source (opus_tpu_torch/csrc/celt_dec_frame.cu) compiled
as host C++ and run on the CPU, against the plain torch symbol pass
(decode_frame_plain) on the same inputs: real 20 ms and 10 ms (LM 2)
fixture packets with random energy memory and seeds, truncated packets and
random bytes; and at
start = 17, continuing the range decoder that the SILK half leaves, on the
CELT halves of the hybrid fixture's frames (the plain hybrid chain's inputs
to K1, frame by frame) plus garbage lanes.  Its stereo instantiation (C =
2) against its plain version (decode_frame2_plain) on every stereo frame
the port's decoder gives K1 over the stereo fixture's CELT and hybrid
streams (LM 0-3, start 0 and 17), plus truncated and random-byte lanes,
with disable_inv 0 and 1.

K1 runs one warp per stream; its lane width is the macro K1_LANES (32 on
the card).  The main build sets it to 1 (one warp of one lane per block,
the kernel called once per stream): a shim header defines the CUDA
qualifiers away, gives __clz, __ldg, __ffs and rsqrtf host meanings and
makes the warp primitives (__shfl_sync, __shfl_xor_sync, __ballot_sync,
__syncwarp) those of a one-lane warp.  A second build runs K1_LANES host
threads per stream, whose warp primitives exchange values through a
barrier, so the cross-lane passes (strided loops, butterfly sums, the
ballot search, the jumped-ahead LCG) run on the CPU too.  The extern "C"
launch section is left out.  -ffp-contract=off mirrors nvcc's
-fmad=false.  The card runs the same source in chip_smoke.py; these tests
catch logic errors in it where there is no card.  Integer outputs must be
identical; X within 1e-5 of each band's maximum and energies within 1e-5
(f32 sums in another order and libm vs torch cos/exp2, a few ULPs).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from opus_tpu_torch.models.celt_dec_kernel import (INT_KEYS, dec_tabs,
                                                   decode_frame_plain,
                                                   k1_table)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "opus_tpu_torch", "csrc", "celt_dec_frame.cu")
FIXTURES = {n: os.path.join(REPO, "tests", "data", f"torch_celt{ms}_64k.npz")
            for n, ms in ((960, "20ms"), (480, "10ms"))}
HYB_FIXTURE = os.path.join(REPO, "tests", "data", "torch_hybrid_fb20ms.npz")
STEREO_FIXTURE = os.path.join(REPO, "tests", "data",
                              "torch_opus_stereo.npz")

SHIM = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__ static
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct Dim3 { int x; };
struct uint4 { uint32_t x, y, z, w; };
struct int4 { int x, y, z, w; };
struct float4 { float x, y, z, w; };
static inline int __ldg(const int *p) { return *p; }
static inline uint32_t __ldg(const uint32_t *p) { return *p; }
static inline int __clz(uint32_t v) { return v ? __builtin_clz(v) : 32; }
static inline int __ffs(int v) { return __builtin_ffs(v); }
static inline int __popc(unsigned v) { return __builtin_popcount(v); }
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline void __trap() { abort(); }
static Dim3 blockIdx, blockDim;
#if WARP_LANES == 1
static Dim3 threadIdx;
static inline void __syncwarp(unsigned = 0xffffffffu) {}
static inline void __syncthreads() {}
template <class T> static inline T __shfl_sync(unsigned, T v, int) {
  return v;
}
template <class T> static inline T __shfl_xor_sync(unsigned, T v, int) {
  return v;
}
template <class T> static inline T __shfl_down_sync(unsigned, T v, int) {
  return v;
}
template <class T> static inline T __shfl_up_sync(unsigned, T v, int) {
  return v;
}
static inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
#else
// WARP_LANES host threads are one warp: each primitive is a barrier
#include <atomic>
#include <thread>
static thread_local Dim3 threadIdx;
static std::atomic<int> host_arrived{0}, host_gen{0};
static inline void host_barrier() {
  int g = host_gen.load();
  if (host_arrived.fetch_add(1) == WARP_LANES - 1) {
    host_arrived.store(0);
    host_gen.fetch_add(1);
  } else {
    while (host_gen.load() == g) std::this_thread::yield();
  }
}
static uint64_t host_slot[WARP_LANES];
template <class T> static inline T host_xchg(T v, int src) {
  uint64_t b = 0;
  memcpy(&b, &v, sizeof v);
  host_slot[threadIdx.x % WARP_LANES] = b;
  host_barrier();
  uint64_t r = host_slot[src];
  host_barrier();
  T out;
  memcpy(&out, &r, sizeof out);
  return out;
}
static inline void __syncwarp(unsigned = 0xffffffffu) { host_barrier(); }
static inline void __syncthreads() { host_barrier(); }
template <class T> static inline T __shfl_sync(unsigned, T v, int src) {
  return host_xchg(v, src % WARP_LANES);
}
template <class T> static inline T __shfl_xor_sync(unsigned, T v, int o) {
  return host_xchg(v, (threadIdx.x % WARP_LANES) ^ o);
}
template <class T> static inline T __shfl_down_sync(unsigned, T v, int o) {
  int l = threadIdx.x % WARP_LANES;
  return host_xchg(v, l + o < WARP_LANES ? l + o : l);
}
template <class T> static inline T __shfl_up_sync(unsigned, T v, int o) {
  int l = threadIdx.x % WARP_LANES;
  return host_xchg(v, l >= o ? l - o : l);
}
static inline unsigned __ballot_sync(unsigned, int p) {
  host_slot[threadIdx.x % WARP_LANES] = p != 0;
  host_barrier();
  unsigned m = 0;
  for (int l = 0; l < WARP_LANES; l++) m |= (unsigned)host_slot[l] << l;
  host_barrier();
  return m;
}
#endif
"""

DRIVER = r"""
#include "cuda_runtime.h"
#include "body.inc"
}
__attribute__((aligned(16))) unsigned char k1_smem[1 << 16];
template <int C>
static void run_c(const void *buf, int P, const void *lens,
    const void *old_e, const void *prevmin, const void *seed,
    const void *rc_in, const void *tab, void *X, void *energies,
    void *ints, void *pf_gain, int B, int nx, int disable_inv) {
  auto run = [=] {
    celt_dec_frame_kernel<C>((const uint8_t *)buf, P, (const int32_t *)lens,
        (const float *)old_e, (const float *)prevmin, (const int64_t *)seed,
        (const int32_t *)rc_in, (const int32_t *)tab, (float *)X,
        (float *)energies, (int32_t *)ints, (float *)pf_gain, B, nx,
        disable_inv);
  };
  blockDim.x = K1_LANES;
  for (int l = 0; l < B; l++) {
    blockIdx.x = l;
#if K1_LANES == 1
    threadIdx.x = 0;
    run();
#else
    std::thread lanes[K1_LANES];
    for (int t = 0; t < K1_LANES; t++)
      lanes[t] = std::thread([=] { threadIdx.x = t; run(); });
    for (auto &th : lanes) th.join();
#endif
  }
}
extern "C" void run_lanes(const void *buf, int P, const void *lens,
    const void *old_e, const void *prevmin, const void *seed,
    const void *rc_in, const void *tab, void *X, void *energies,
    void *ints, void *pf_gain, int B, int nx) {
  run_c<1>(buf, P, lens, old_e, prevmin, seed, rc_in, tab, X, energies,
           ints, pf_gain, B, nx, 0);
}
extern "C" void run_lanes2(const void *buf, int P, const void *lens,
    const void *old_e, const void *prevmin, const void *seed,
    const void *rc_in, const void *tab, void *X, void *energies,
    void *ints, void *pf_gain, int B, int nx, int disable_inv) {
  run_c<2>(buf, P, lens, old_e, prevmin, seed, rc_in, tab, X, energies,
           ints, pf_gain, B, nx, disable_inv);
}
"""


@pytest.fixture(scope="module")
def k1_lib(tmp_path_factory):
    return _build(str(tmp_path_factory.mktemp("k1host")))


def _build(tmp, lanes=1):
    """K1's source as a host library at lane width ``lanes`` (1: the
    kernel once per stream; more: that many threads per stream)."""
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
         "-pthread", f"-DWARP_LANES={lanes}", f"-DK1_LANES={lanes}",
         "-DK1_WARPS=1",
         "-I", str(tmp), "-o", lib, os.path.join(tmp, "driver.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


def _lanes(rng, frame_size=960):
    fx = np.load(FIXTURES[frame_size])
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


def _run_host(lib, tabs, buf, ln, old_e, prevmin, seed, rc_in=None,
              tab=None):
    """K1's source on the host over every lane -> (X [B, nx], energies,
    ints [B, 9], pf_gain), numpy; tab: K1's table (default
    tabs.kernel_table())."""
    b, p = buf.shape
    nb, nx = tabs.nb, tabs.nx
    buf, old_e, prevmin, seed = (np.ascontiguousarray(a) for a in
                                 (buf, old_e, prevmin, seed))
    tab = tabs.kernel_table() if tab is None else np.ascontiguousarray(tab)
    lens32 = np.clip(ln, 0, p).astype(np.int32)
    x = np.zeros((b, nx), np.float32)
    energies = np.zeros((b, nb), np.float32)
    ints = np.zeros((b, 9), np.int32)
    pf_gain = np.zeros(b, np.float32)
    ptr = lambda a: None if a is None else a.ctypes.data_as(  # noqa: E731
        ctypes.c_void_p)
    lib.run_lanes(ptr(buf), p, ptr(lens32), ptr(old_e), ptr(prevmin),
                  ptr(seed), ptr(rc_in), ptr(tab), ptr(x), ptr(energies),
                  ptr(ints), ptr(pf_gain), b, nx)
    return x, energies, ints, pf_gain


def _check(tabs, got, ref):
    x, energies, ints, pf_gain = got
    for j, key in enumerate(INT_KEYS):
        v = ints[:, j].astype(np.int64)
        if key == "rng":
            v &= 0xFFFFFFFF
        assert v.tolist() == ref[key].tolist(), key
    assert np.array_equal(pf_gain, ref["pf_gain"].numpy())
    assert np.abs(energies - ref["energies"].numpy()).max() <= 1e-5
    xr = ref["X"].numpy()
    m, eb = tabs.M, tabs.eBands
    for i in range(tabs.nb):
        a, c = m * int(eb[i]), m * int(eb[i + 1])
        scale = np.abs(xr[:, a:c]).max(axis=1)
        err = np.abs(x[:, a:c] - xr[:, a:c]).max(axis=1)
        assert (err <= 1e-5 * scale).all(), (i, err.max())


@pytest.mark.parametrize("frame_size", [960, 480])
def test_torch_k1_source_on_host_matches_plain(k1_lib, frame_size):
    tabs = dec_tabs(48000, frame_size)
    rng = np.random.default_rng(7)
    buf, ln = _lanes(rng, frame_size)
    b = buf.shape[0]
    nb = tabs.nb
    old_e = rng.normal(0, 4, (b, nb)).astype(np.float32)
    prevmin = rng.normal(0, 4, (b, nb)).astype(np.float32)
    seed = rng.integers(0, 2 ** 32, b).astype(np.int64)
    ref = decode_frame_plain(torch.from_numpy(buf), torch.from_numpy(ln),
                             torch.from_numpy(old_e),
                             torch.from_numpy(prevmin),
                             torch.from_numpy(seed), tabs)
    _check(tabs, _run_host(k1_lib, tabs, buf, ln, old_e, prevmin, seed),
           ref)


def _hybrid_lanes(rng):
    """The hybrid fixture's 8 streams plus 4 truncated and 4 random-byte
    lanes, per frame."""
    fx = np.load(HYB_FIXTURE)
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    out = []
    for f in range(nf):
        buf = np.zeros((ns + 8, p), np.uint8)
        ln = np.zeros(ns + 8, np.int64)
        buf[:ns], ln[:ns] = frames[:, f], lens[:, f]
        for j in range(8):
            cut = int(rng.integers(0, lens[j, f] if j < 4 else p + 1))
            buf[ns + j, :cut] = (frames[j, f, :cut] if j < 4
                                 else rng.integers(0, 256, cut))
            ln[ns + j] = cut
        out.append((buf, ln))
    return out


def _hybrid_k1_frames(tabs, nframes=None):
    """Per frame of the plain hybrid chain (state carried): K1's inputs
    (buf, lens, old_e, prevmin, seed, rc_in as numpy) and the plain
    version's outputs."""
    from opus_tpu_torch.models import hybrid_dec_fused as H
    from opus_tpu_torch.ops.rc_kernel import pack_state

    lanes = _hybrid_lanes(np.random.default_rng(11))[:nframes]
    state = H.hybrid_init_state(lanes[0][0].shape[0], tabs)
    for buf, ln in lanes:
        seen = {}

        def plain(buf_t, lens, old_e, prevmin, seed, tabs_, d0):
            seen.update(args=(buf_t, lens, old_e, prevmin, seed, d0))
            seen["ref"] = decode_frame_plain(buf_t, lens, old_e, prevmin,
                                             seed, tabs_, d0)
            return seen["ref"]

        _pcm, state, _err = H.fused_hybrid_decode(
            torch.from_numpy(buf), torch.from_numpy(ln), state, tabs, plain)
        buf_t, lens, old_e, prevmin, seed, d0 = seen["args"]
        rc = pack_state(d0).numpy()
        rc_in = np.where(rc >= 1 << 31, rc - (1 << 32), rc).astype(np.int32)
        yield ((buf_t.numpy(), lens.numpy(), old_e.numpy(), prevmin.numpy(),
                seed.numpy(), rc_in), seen["ref"])


def test_torch_k1_source_on_host_matches_plain_hybrid_start17(k1_lib):
    """K1 at start = 17 with the SILK half's coder state on every frame of
    the plain hybrid chain (state carried)."""
    tabs = dec_tabs(48000, 960, 17, 21)
    transient = 0
    for args, ref in _hybrid_k1_frames(tabs):
        got = _run_host(k1_lib, tabs, *args)
        _check(tabs, got, ref)
        assert not got[0][:, :tabs.M * int(tabs.eBands[17])].any()
        transient += int(ref["is_transient"].sum())
    assert transient > 0


def test_torch_k1_table_cache_keeps_band_ranges_apart(k1_lib):
    """A CELT-only (start 0) and a hybrid (start 17) decoder in one process:
    the device-table cache gives each its own K1 table, and K1 run on the
    cached tables decodes each one's packets as the plain version does."""
    tabs0 = dec_tabs(48000, 960)
    tabs17 = dec_tabs(48000, 960, 17, 21)
    t0 = k1_table(tabs0, "cpu").numpy()
    t17 = k1_table(tabs17, "cpu").numpy()
    assert np.array_equal(t0, tabs0.kernel_table())
    assert np.array_equal(t17, tabs17.kernel_table())
    rng = np.random.default_rng(8)
    buf, ln = _lanes(rng)
    b, nb = buf.shape[0], tabs0.nb
    old_e = rng.normal(0, 4, (b, nb)).astype(np.float32)
    prevmin = rng.normal(0, 4, (b, nb)).astype(np.float32)
    seed = rng.integers(0, 2 ** 32, b).astype(np.int64)
    ref = decode_frame_plain(*(torch.from_numpy(a) for a in
                               (buf, ln, old_e, prevmin, seed)), tabs0)
    _check(tabs0, _run_host(k1_lib, tabs0, buf, ln, old_e, prevmin, seed,
                            tab=t0), ref)
    args, ref = next(_hybrid_k1_frames(tabs17, 1))
    _check(tabs17, _run_host(k1_lib, tabs17, *args, tab=t17), ref)


def test_torch_k1_lane_width_is_one_macro_the_shim_sets():
    """The lane width is the one macro K1_LANES, defaulting to a warp (32)
    and guarded so that a build can set it; the launcher's block size and
    the grid follow it, and no literal lane count or full-warp mask is
    written anywhere else."""
    src = open(SRC).read()
    assert src.count("#define K1_LANES") == 1
    assert "#ifndef K1_LANES\n#define K1_LANES 32" in src
    assert "constexpr int LANES = K1_LANES;" in src
    assert "constexpr int NW = warps_of<C>();" in src
    assert "<<<(B + NW - 1) / NW, NW * LANES, smem," in src
    assert "__launch_bounds__(warps_of<C>() * LANES, 1)" in src
    body = src.replace("#define K1_LANES 32", "")
    lane_math = re.findall(r"(?:[%/&]|\+=)\s*(?:32|31|64)\b", body)
    assert not lane_math, lane_math
    assert body.count("0xffffffffu") == 1     # FULL, defined once


@pytest.fixture(scope="module")
def thread_libs(tmp_path_factory):
    """K1 built at a lane width, once per width for the module."""
    built = {}

    def get(lanes):
        if lanes not in built:
            built[lanes] = _build(str(tmp_path_factory.mktemp(
                f"k1host{lanes}")), lanes)
        return built[lanes]
    return get


@pytest.mark.parametrize("frame_size", [960, 480])
@pytest.mark.parametrize("lanes", [4, 32])
def test_torch_k1_source_on_host_threads_matches_plain(thread_libs, lanes,
                                                       frame_size):
    """K1 at lane width 4 and at the card's 32, each lane a host thread:
    the strided passes, butterfly sums, ballot searches and jumped-ahead
    LCG fills give the plain version's outputs at start 0 (fixture,
    truncated and random-byte lanes, 20 and 10 ms) and start 17 (two
    hybrid frames, 20 ms)."""
    lib = thread_libs(lanes)
    tabs = dec_tabs(48000, frame_size)
    rng = np.random.default_rng(7)
    buf, ln = _lanes(rng, frame_size)
    b, nb = buf.shape[0], tabs.nb
    old_e = rng.normal(0, 4, (b, nb)).astype(np.float32)
    prevmin = rng.normal(0, 4, (b, nb)).astype(np.float32)
    seed = rng.integers(0, 2 ** 32, b).astype(np.int64)
    ref = decode_frame_plain(*(torch.from_numpy(a) for a in
                               (buf, ln, old_e, prevmin, seed)), tabs)
    assert int(ref["anti_collapse_on"].sum()) > 0
    _check(tabs, _run_host(lib, tabs, buf, ln, old_e, prevmin, seed), ref)
    if frame_size != 960:
        return
    tabs17 = dec_tabs(48000, 960, 17, 21)
    for args, ref in _hybrid_k1_frames(tabs17, 2):
        _check(tabs17, _run_host(lib, tabs17, *args), ref)


# ---- the stereo instantiation ------------------------------------------

STEREO_STREAMS = (3, 4, 6)     # the fixture's stereo CELT and hybrid


@pytest.fixture(scope="module")
def stereo_k1_calls():
    """Every call of K1's stereo instantiation that the port's two-channel
    decoder makes over the stereo fixture's CELT and hybrid streams on the
    CPU: the inputs, as numpy, by (frame size, start, end)."""
    from opus_tpu_torch.models import celt_dec_kernel as CK
    from opus_tpu_torch.models.opus_decoder import BatchedOpusDecoder
    from opus_tpu_torch.ops.rc_kernel import pack_state

    fx = np.load(STEREO_FIXTURE)
    plen, pkts = fx["plen"], fx["packets"]
    calls = {}
    real = CK.decode_frame2

    def spy(buf, lens, old_e, prevmin, seed, tabs, d0=None,
            disable_inv=False):
        key = (tabs.mode.shortMdctSize << tabs.lm, tabs.start,
               tabs.end_band)
        rc_in = None
        if d0 is not None:
            rc = pack_state(d0).numpy()
            rc_in = np.where(rc >= 1 << 31, rc - (1 << 32), rc).astype(
                np.int32)
        calls.setdefault(key, []).append(tuple(
            a.numpy() for a in (buf, lens, old_e, prevmin, seed))
            + (rc_in,))
        return real(buf, lens, old_e, prevmin, seed, tabs, d0, disable_inv)

    CK.decode_frame2 = spy
    try:
        dec = BatchedOpusDecoder(len(STEREO_STREAMS), channels=2,
                                 device="cpu")
        for t in range(plen.shape[1]):
            row = [(None if plen[s, t] < 0 else
                    bytes(pkts[s, t, :plen[s, t]]), bool(fx["fec"][s, t]),
                    int(fx["fsize"][s, t])) for s in STEREO_STREAMS]
            dec.decode([p for p, _f, _z in row],
                       decode_fec=[f for _p, f, _z in row],
                       frame_size=[z for _p, _f, z in row])
    finally:
        CK.decode_frame2 = real
    return calls


def _stereo_lanes(calls, rng):
    """One group's calls as one batch of lanes, plus 4 truncated copies of
    its first lanes and 4 lanes of random bytes (coder states and energy
    memory taken from real lanes)."""
    p = max(c[0].shape[1] for c in calls)
    rows = [np.pad(c[0], ((0, 0), (0, p - c[0].shape[1]))) for c in calls]
    buf = np.concatenate(rows)
    ln, old_e, prevmin, seed = (np.concatenate([c[k] for c in calls])
                                for k in range(1, 5))
    rc_in = None
    if any(c[5] is not None for c in calls):
        # a CELT-only lane that shared a round with a hybrid lane got a
        # coder at its packet's start: the same as none
        rc_in = np.concatenate([_rc_rows(c[0], c[1]) if c[5] is None
                                else c[5] for c in calls])
    b = buf.shape[0]
    pick = np.arange(8) % b
    ext = buf[pick].copy()
    ext_ln = ln[pick].copy()
    for j in range(8):
        cut = int(rng.integers(0, max(1, ext_ln[j]) if j < 4 else p + 1))
        if j >= 4:
            ext[j, :cut] = rng.integers(0, 256, cut)
        ext[j, cut:] = 0
        ext_ln[j] = cut
    cat = np.concatenate
    return (cat([buf, ext]), cat([ln, ext_ln]), cat([old_e, old_e[pick]]),
            cat([prevmin, prevmin[pick]]), cat([seed, seed[pick]]),
            None if rc_in is None else cat([rc_in, rc_in[pick]]))


def _rc_rows(buf, ln):
    """pack_state of a coder started on each lane's packet, as int32."""
    from opus_tpu_torch.ops.rc_kernel import pack_state, rk_init
    rc = pack_state(rk_init(torch.from_numpy(buf), torch.from_numpy(
        ln).clamp(0, buf.shape[1]))).numpy()
    return np.where(rc >= 1 << 31, rc - (1 << 32), rc).astype(np.int32)


def _run_host2(lib, tabs, buf, ln, old_e, prevmin, seed, rc_in, inv):
    b, p = buf.shape
    nb, nx = tabs.nb, tabs.nx
    buf, old_e, prevmin, seed = (np.ascontiguousarray(a) for a in
                                 (buf, old_e, prevmin, seed))
    tab = tabs.kernel_table()
    lens32 = np.clip(ln, 0, p).astype(np.int32)
    x = np.zeros((b, 2, nx), np.float32)
    energies = np.zeros((b, 2, nb), np.float32)
    ints = np.zeros((b, 9), np.int32)
    pf_gain = np.zeros(b, np.float32)
    ptr = lambda a: None if a is None else a.ctypes.data_as(  # noqa: E731
        ctypes.c_void_p)
    lib.run_lanes2(ptr(buf), p, ptr(lens32), ptr(old_e), ptr(prevmin),
                   ptr(seed), ptr(rc_in), ptr(tab), ptr(x), ptr(energies),
                   ptr(ints), ptr(pf_gain), b, nx, int(inv))
    return x, energies, ints, pf_gain


def _d0(rc_in):
    """pack_state's rows back into the plain version's coder dict."""
    from opus_tpu_torch.ops.rc_kernel import M32
    keys = ("offs", "end_offs", "end_window", "nend_bits", "nbits_total",
            "rng", "val", "ext", "rem", "error")
    v = torch.from_numpy(rc_in.astype(np.int64))
    return {k: (v[:, j] & M32 if k in ("end_window", "rng", "val", "ext")
                else v[:, j]) for j, k in enumerate(keys)}


@pytest.mark.parametrize("inv", [0, 1])
def test_torch_k1_stereo_source_on_host_matches_plain(k1_lib,
                                                      stereo_k1_calls, inv):
    """K1's stereo instantiation on every stereo CELT frame of the
    fixture's CELT and hybrid streams (LM 0-3 at start 0, start 17 with
    the SILK half's coder state), plus truncated and random-byte lanes,
    disable_inv 0 and 1: integers equal, X and energies within 1e-5."""
    from opus_tpu_torch.models.celt_dec_kernel import decode_frame2_plain

    rng = np.random.default_rng(23)
    seen = set()
    flags = dict(intensity=0, dual=0)
    for (n, start, end), calls in sorted(stereo_k1_calls.items()):
        tabs = dec_tabs(48000, n, start, end)
        args = _stereo_lanes(calls, rng)
        buf, ln, old_e, prevmin, seed, rc_in = args
        ref = decode_frame2_plain(
            *(torch.from_numpy(a) for a in (buf, ln, old_e, prevmin, seed)),
            tabs, None if rc_in is None else _d0(rc_in), bool(inv))
        got = _run_host2(k1_lib, tabs, *args, inv)
        x, energies, ints, pf_gain = got
        for j, key in enumerate(INT_KEYS):
            v = ints[:, j].astype(np.int64)
            if key == "rng":
                v &= 0xFFFFFFFF
            assert v.tolist() == ref[key].tolist(), (n, start, key)
        assert np.array_equal(pf_gain, ref["pf_gain"].numpy())
        assert np.abs(energies - ref["energies"].numpy()).max() <= 1e-5
        xr = ref["X"].numpy()
        m, eb = tabs.M, tabs.eBands
        for i in range(tabs.nb):
            a, c = m * int(eb[i]), m * int(eb[i + 1])
            scale = np.abs(xr[:, :, a:c]).max(axis=2)
            err = np.abs(x[:, :, a:c] - xr[:, :, a:c]).max(axis=2)
            assert (err <= 1e-5 * scale).all(), (n, start, i, err.max())
        seen.add((tabs.lm, start))
        flags["intensity"] += int((ref["intensity"] > start).sum())
        flags["dual"] += int(ref["dual_stereo"].sum())
    assert {(lm, 0) for lm in range(4)} <= seen and (3, 17) in seen, seen
    assert flags["intensity"] and flags["dual"], flags


def test_torch_k1_stereo_source_on_host_threads_matches_plain(
        thread_libs, stereo_k1_calls):
    """The stereo instantiation at lane width 4 (the merge's butterfly
    sums, the second fold buffer's strided fills): the 20 ms groups at
    start 0 and 17, disable_inv 0, as ``_run_host2`` at width 1 gives."""
    from opus_tpu_torch.models.celt_dec_kernel import decode_frame2_plain

    lib = thread_libs(4)
    rng = np.random.default_rng(29)
    for start in (0, 17):
        key = (960, start, 21)
        tabs = dec_tabs(48000, 960, start, 21)
        args = _stereo_lanes(stereo_k1_calls[key], rng)
        buf, ln, old_e, prevmin, seed, rc_in = args
        ref = decode_frame2_plain(
            *(torch.from_numpy(a) for a in (buf, ln, old_e, prevmin, seed)),
            tabs, None if rc_in is None else _d0(rc_in), False)
        x, energies, ints, _pf = _run_host2(lib, tabs, *args, 0)
        assert (ints[:, 8].astype(np.int64) & 0xFFFFFFFF).tolist() \
            == ref["rng"].tolist()
        assert ints[:, 6].tolist() == ref["error"].tolist()
        assert np.abs(energies - ref["energies"].numpy()).max() <= 1e-5
        xr = ref["X"].numpy()
        scale = np.abs(xr).max(axis=2, keepdims=True)
        assert (np.abs(x - xr) <= 1e-5 * np.maximum(scale, 1e-30)).all()
