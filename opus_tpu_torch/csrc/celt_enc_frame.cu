// Kernel K3: the mono CBR CELT encode symbol pass for one 20 ms frame, one
// warp per stream, from ec_enc_init to the packet bytes.
//
// Replaces the Pallas TPU kernel opus_tpu/models/celt_enc_kernel.py:798
// (_enc_frame_kernel, launched by build_enc_frame_fn).  It computes the
// same function as its [B]-lane plain version encode_frame_plain
// (opus_tpu_torch/models/celt_enc_kernel.py), operation for operation on
// floats: the three header bits, coarse energy as a two-pass intra/inter
// trial (dry tell-tracker trials, then the picked pass for real), tf
// encode, spread, the dynalloc boosts, trim, the allocation with
// encode-side skip decisions, fine energy, the PVQ band trees (theta,
// exp_rotation, the greedy pulse search, the CWRS index, ec_enc_uint),
// the anti-collapse bit, energy finalise, ec_enc_done, and the carry
// resolution and byte assembly (rc_enc_kernel.finalize), so no torch
// range-encoder op runs on the card's main path.  What is dropped is the
// TPU layout: [8,128] lane tiles, the preorder node program (an explicit
// stack here; encode needs no pop events), the gather-free page sweeps
// and the MXU wrap matmul (a per-output fmaf chain over the nonzero taps
// in index order, the JAX twin's BLAS order).
//
// Bound on this card: a stream moves ~4 KB (800 coefficients and 43
// floats in, nbytes payload bytes out), so the bytes bound is a few us at
// B = 4096; the time goes to the serial chain of dependent operations
// that range coding and the band trees are, one chain per stream
// (opus_tpu_torch/tools/k1_profile.py --kernel k3 splits it by phase: on
// an H100 SXM, ~0.7 M SM cycles per stream and frame at 160 bytes, 84%
// of them in the band loop, which the pulse search, the theta nodes and
// the CWRS index lead).  At 16 resident warps per SM, B = 4096 streams
// are two waves of chains.  The design is K1's (csrc/celt_dec_frame.cu):
// fill the card with chains,
// keep their operands on chip, and take off the chain what does not feed
// the range coder:
//
// - One warp per stream, K3_WARPS (16) warps per block, one block per SM:
//   up to 128 registers a thread, so no spills.  B = 4096 gives 4096
//   warps, not the 128 warps of one thread per stream.
// - Warp-uniform control flow: all K3_LANES lanes hold the same range
//   encoder state and run the header, coarse energy (with its dry
//   trials), tf, spread, dynalloc, trim, the allocation, fine energy, the
//   theta nodes, the pulse-count search, ec_enc_uint, the anti-collapse
//   bit, finalise and ec_enc_done on the same values, so no branch
//   diverges inside a warp.  Shared-memory stores of such scalars (the
//   band-tree stack, the digits, the end bytes) are made by lane 0,
//   between two __syncwarp()s where another lane could read them.
// - Per-band values (energies, errors, tf, offsets, the allocation, fine
//   bits and priorities) live in registers, band i in lane i (Band<>): a
//   read is one __shfl_sync, a write a select in the owning lane.  The
//   allocation's trial sums run over the bands at once (a ballot for "a
//   higher band reached its threshold", a butterfly sum; integer sums are
//   order-free), and so does the spread of the leftover bits.
// - Off the chain, across the lanes (j = lane, lane + K3_LANES, ...): the
//   wrap taps (one output per lane, each fmaf chain in its own order), the
//   swap of halves, the PVQ search (the projection as a vector pass; each
//   greedy pulse scores its positions on their lanes and a warp argmax
//   keeps the first index of the maximum, as the serial `score > best`
//   does: the scores are the same f32 expressions, so the pulse is the
//   same), the CWRS index (a suffix scan of |iy| and U-table lookups,
//   summed mod 2^32), exp_rotation (its recurrences are serial along each
//   chain, so each chain runs on a lane with its running value in a
//   register), and the carry resolution (each lane's chunk of digits as a
//   map of its incoming carry, composed by a warp scan) with the byte
//   assembly.  The f32 sums keep _tree_sum's pairing ((0,1), (2,3), ...,
//   an odd last element carried), level by level, the lanes adding a
//   level's pairs (in shared memory while a level is wider than the warp,
//   then by shuffles), so every sum has the plain version's bits.  A leaf
//   no wider than the warp keeps its pulse search in registers and
//   reduces over the next power of two above its width; a leaf without
//   the projection (k <= n / 2) skips the sums, whose values are +0.
// - Per-warp shared memory instead of local memory: the stream's X row
//   (coalesced 16-byte loads), the band window and the PVQ scratch, the
//   band-tree stack, and the digit and end-byte buffers, nbytes + 4 and
//   nbytes + 1 long, in dynamic shared memory: any nbytes up to 1275
//   launches (7488 bytes a warp at nbytes = 160, 10816 at 1275).
//   NMAX and MAX_K bound n and k at any nbytes: n is a band's width
//   (at most 176 at 20 ms), and a leaf's pulse count comes from the pulse
//   cache, whose top row is 40 (128 pulses): a node with more bits splits
//   (b > row[L] + 12), whatever the rate
//   (test_torch_k3_band_bounds_hold_at_any_rate).
// - Inputs and outputs are [B, rows] row-major, each warp its own row:
//   X [B, nx], fin [B, 2nb+1], iin [B, 7+2nb], fout [B, 2nb+1],
//   iout [B, 8] and the payload [B, nbytes].
//
// The tables (mode, pulse cache, CWRS U/V, Laplace chains, band variants
// and wrap taps, rotation cos/sin) come in as one int32 and one float32
// device tensor built by ETabs.kernel_tables(); this file holds no mode
// tables.  The host rehearsal (tests/test_torch_k3_host.py) compiles this
// file as C++ at K3_LANES 1, 4 and 32, so the lane width is a macro and
// nothing else in the source assumes 32.  Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false (no fast
// math), so float results equal the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K3_LANES
#define K3_LANES 32        // lanes per stream: one warp on the card
#endif
#ifndef K3_WARPS
#define K3_WARPS 16        // streams (warps) per block
#endif

// dynamic shared memory: the staged table offsets, then per warp its
// WarpMem, digits and end bytes
extern __shared__ __align__(16) unsigned char k3_smem[];

namespace {

constexpr int LANES = K3_LANES;
constexpr int WARPS = K3_WARPS;
constexpr unsigned FULL = 0xffffffffu;
static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
              "K3_LANES: a power of two up to 32");

constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int QTHETA_OFFSET = 4;
constexpr int ALLOC_STEPS = 6;
constexpr int NB_MAX = 21;
constexpr int NX_MAX = 800;     // M * eBands[nb] at 20 ms
constexpr int NMAX = 176;       // widest band at 20 ms
constexpr int HALF = NMAX / 2;  // a split node's half: at most 88
constexpr int MAX_K = 128;
constexpr int EW_SLOTS = 8;       // two 16-byte vectors of taps
constexpr int NVAR = 8;
constexpr int STACK = 8;
constexpr uint32_t CODE_BOT = 1u << 23;
constexpr uint32_t CODE_TOP = 1u << 31;

__constant__ int TELL_CORRECTION[8] = {35733, 38967, 42495, 46340,
                                       50535, 55109, 60097, 65535};
__constant__ int SMALL_ENERGY_ICDF[3] = {2, 1, 0};
__constant__ int TRIM_ICDF[11] = {126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0};
__constant__ int SPREAD_ICDF[4] = {25, 23, 2, 0};
__constant__ int TF_SELECT_TABLE[4][8] = {{0, -1, 0, -1, 0, -1, 0, -1},
                                          {0, -1, 0, -2, 1, 0, 1, -1},
                                          {0, -2, 0, -3, 2, 0, 1, -1},
                                          {0, -2, 0, -3, 3, 0, 1, -1}};
__constant__ int EXP2_TABLE8[8] = {16384, 17866, 19483, 21247,
                                   23170, 25267, 27554, 30048};
__constant__ float PRED_COEF[4] = {29440 / 32768.f, 26112 / 32768.f,
                                   21248 / 32768.f, 16384 / 32768.f};
__constant__ float BETA_COEF[4] = {30147 / 32768.f, 22282 / 32768.f,
                                   12124 / 32768.f, 6554 / 32768.f};
__constant__ float BETA_INTRA = 4915 / 32768.f;

// -------------------------------------------------------------- profiling
// Built with -DK3_PROFILE (opus_tpu_torch/tools/k1_profile.py --kernel
// k3), lane 0 of each warp adds the SM clock cycles of each phase into
// k3_prof; the card's build and the host rehearsal compile none of it.
#ifdef K3_PROFILE
constexpr int K3_NPROF = 16;
__device__ unsigned long long k3_prof[K3_NPROF];
#define PROF_T(v) const long long v = clock64()
#define PROF_ADD(slot, t0)                                                   \
    do {                                                                     \
        if (threadIdx.x % K3_LANES == 0)                                     \
            atomicAdd(&k3_prof[slot], (unsigned long long)(clock64() - t0)); \
    } while (0)
#else
#define PROF_T(v)
#define PROF_ADD(slot, t0)
#endif

// ------------------------------------------------------------ warp helpers
__device__ __forceinline__ int lane_id() { return threadIdx.x % LANES; }

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
    for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// per-band values in registers: band i in lane i % LANES, slot i / LANES
constexpr int BSLOTS = (NB_MAX + LANES - 1) / LANES;

template <typename V>
struct Band {
    V v[BSLOTS] = {};       // lanes past the last band hold 0
};

template <typename V>
__device__ __forceinline__ V bget(const Band<V> &a, int i) {
    if constexpr (BSLOTS == 1) return __shfl_sync(FULL, a.v[0], i);
    else return __shfl_sync(FULL, a.v[i / LANES], i % LANES);
}

template <typename V>
__device__ __forceinline__ void bset(Band<V> &a, int i, V x) {
    if constexpr (BSLOTS == 1) {
        a.v[0] = lane_id() == i ? x : a.v[0];
    } else if (lane_id() == i % LANES) {
        a.v[i / LANES] = x;
    }
}

// Sums over the bands of one allocation trial (rate.c): band j's bits v_j
// count in full (up to its cap) once some band j' >= j reached its
// threshold, else the floor when v_j >= 8, else nothing.  Bands sit in
// lanes: a ballot gives the "some j' >= j" flags, a butterfly the sum.
template <typename F>
__device__ __forceinline__ int alloc_sum(int nb, const int32_t *caps,
                                         F bits_of) {
    const int lane = lane_id();
    int psum = 0, done_hi = 0;
    for (int s = BSLOTS - 1; s >= 0; s--) {
        int j = s * LANES + lane;
        int in = j < nb;
        int thr = 0;
        int v = in ? bits_of(s, j, thr) : 0;
        unsigned m = __ballot_sync(FULL, in && v >= thr);
        int done = done_hi || (m >> lane) != 0;
        if (in) psum += done ? (v < caps[j] ? v : caps[j])
                             : (v >= 1 << BITRES ? 1 << BITRES : 0);
        done_hi |= m != 0;
    }
    return warp_sum(psum);
}

// ---------------------------------------------------------------- tables
enum { S_EBANDS, S_LOGN, S_CAPS, S_ALLOCV, S_EPROB, S_ROWOFF, S_ROWS, S_U,
       S_V, S_LAPOFF, S_LAP, S_DEPTH, S_KCAP, S_VAR, S_EWIDX, S_ROTOFF,
       S_COUNT };
constexpr int HDR = 6;

// a block's shared memory (each warp's WarpMem follows it): the int
// table's section offsets
struct __align__(16) BlockMem {
    int32_t off[S_COUNT];
};

struct Tabs {
    int nb, lm, nv, nx, urows, ucols;
    const int32_t *t;       // the int table (device memory)
    const int32_t *off;     // its section offsets (shared memory)
    const float *f;
    __device__ __forceinline__ const int32_t *s(int k) const {
        return t + off[k];
    }
};

// the header, and the section offsets staged by the whole block; the
// caller synchronises the block
__device__ Tabs load_tabs(const int32_t *t, const float *f, int32_t *off) {
    Tabs T;
    T.nb = t[0];
    T.lm = t[1];
    T.nv = t[2];
    T.nx = t[3];
    T.urows = t[4];
    T.ucols = t[5];
    for (int k = threadIdx.x; k < S_COUNT; k += blockDim.x) off[k] = t[HDR + k];
    T.t = t;
    T.off = off;
    T.f = f;
    return T;
}

__device__ __forceinline__ const int32_t *cache_row(const Tabs &T, int lmn,
                                                    int band) {
    return T.s(S_ROWS) + T.s(S_ROWOFF)[(lmn + 1) * T.nb + band];
}

__device__ __forceinline__ uint32_t Utab(const Tabs &T, int k, int n) {
    return (uint32_t)T.s(S_U)[k * T.ucols + n];
}

__device__ __forceinline__ uint32_t Vtab(const Tabs &T, int k, int n) {
    return (uint32_t)T.s(S_V)[k * T.ucols + n];
}

__device__ __forceinline__ int ilog(uint32_t v) {
    return v ? 32 - __clz(v) : 0;
}

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0
    int q = a / b;
    return (q * b > a) ? q - 1 : q;
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float pow2neg(int e) {      // 2^-e, exact
    return ldexpf(1.0f, -e);
}

// --------------------------------------------------------- warp memory
// a warp's shared memory (its digits and end bytes follow it)
struct __align__(16) WarpMem {
    float X[NX_MAX];            // the stream's row of X
    float xw[NMAX];             // a wrapped band's window
    float xa[NMAX];             // |x| in the pulse search
    float sa[NMAX], sb[NMAX];   // tree-sum levels (ping-pong)
    int iy[NMAX];               // the pulse vector
    int st[5][STACK];           // per depth: swap, mbits, sbits, itheta, rb0
    int node[3][STACK];         // the band-tree stack: depth, offset, isv1
};

// _tree_sum's order (pairs (0,1), (2,3), ...; an odd last one carried)
// over x_j on lane j, n <= K3_LANES: each level takes its pairs from the
// lanes by shuffles; returns the sum on every lane
__device__ float tree_sum_lanes(float x, int n) {
    const int lane = lane_id();
    while (n > 1) {
        const int m = n >> 1;
        const float a = __shfl_sync(FULL, x, 2 * lane);
        const float b = __shfl_sync(FULL, x, 2 * lane + 1);
        const float c = __shfl_sync(FULL, x, n - 1);
        x = lane < m ? a + b : c;       // lane m: the odd one carried
        n = m + (n & 1);
    }
    return __shfl_sync(FULL, x, 0);
}

// _tree_sum's order over v[0..n) and v[HALF..HALF+n) at once (two n, one
// pass; n <= HALF), in shared memory synced by the caller: the levels
// wider than the warp by the lanes in shared memory (ping-ponging between
// v and w, lane 0 carrying an odd last pair), then tree_sum_lanes.  v and
// w are clobbered; returns both sums on every lane.
__device__ void tree_sum2(float *v, float *w, int n, float &s1, float &s2) {
    const int lane = lane_id();
    while (n > LANES) {
        const int m = n >> 1;
        for (int q = lane; q < 2 * m; q += LANES) {
            const int h = q >= m ? HALF : 0;
            const int i = q >= m ? q - m : q;
            w[h + i] = v[h + 2 * i] + v[h + 2 * i + 1];
        }
        if ((n & 1) && lane == 0) {
            w[m] = v[n - 1];
            w[HALF + m] = v[HALF + n - 1];
        }
        __syncwarp();
        n = m + (n & 1);
        float *t = v;
        v = w;
        w = t;
    }
    const float x1 = lane < n ? v[lane] : 0.f;
    const float x2 = lane < n ? v[HALF + lane] : 0.f;
    __syncwarp();       // every lane has read v before it is reused
    s1 = tree_sum_lanes(x1, n);
    s2 = tree_sum_lanes(x2, n);
}

// _tree_sum's order over v[0..n), n <= NMAX (see tree_sum2)
__device__ float tree_sum(float *v, float *w, int n) {
    const int lane = lane_id();
    while (n > LANES) {
        const int m = n >> 1;
        for (int i = lane; i < m; i += LANES) w[i] = v[2 * i] + v[2 * i + 1];
        if ((n & 1) && lane == 0) w[m] = v[n - 1];
        __syncwarp();
        n = m + (n & 1);
        float *t = v;
        v = w;
        w = t;
    }
    const float x = lane < n ? v[lane] : 0.f;
    __syncwarp();
    return tree_sum_lanes(x, n);
}

// ----------------------------------------------------------- range encoder
// The deferred-carry encoder of ops/rc_enc_kernel.py: 9-bit digits and
// end-window bytes into the warp's buffers (lane 0 stores); appends past a
// buffer's end are dropped (the lane is then flagged at the end).  A dry
// encoder only tracks rng and nbits_total (the exact tell) and writes
// nothing.  Every lane holds the same state.
struct Enc {
    uint32_t rng, val, end_window;
    int ndigits, nend, nend_bits, nbits_total;
    int dcap, ecap;
    bool dry;
    uint16_t *dig;
    uint8_t *endb;
};

__device__ void enc_init(Enc &e, uint16_t *dig, uint8_t *endb, int nbytes) {
    e.rng = CODE_TOP;
    e.val = 0;
    e.end_window = 0;
    e.ndigits = e.nend = e.nend_bits = 0;
    e.nbits_total = 33;
    e.dcap = nbytes + 4;
    e.ecap = nbytes + 1;
    e.dry = false;
    e.dig = dig;
    e.endb = endb;
}

// The loops that store digits stay rolled (#pragma unroll 1): unrolled,
// the card's build (nvcc 12, ptxas -O2 and above) lost an occasional
// digit store on a few percent of the streams (the range coder's state
// and every other output were right); ptxas -O1, a rolled loop or an
// out-of-line call all store every digit, at the same speed.
__device__ void enc_normalize(Enc &e) {
#pragma unroll 1
    for (int t = 0; t < 3 && e.rng <= CODE_BOT; t++) {
        if (!e.dry) {
            if (e.ndigits < e.dcap && lane_id() == 0)
                e.dig[e.ndigits] = (uint16_t)(e.val >> 23);
            e.ndigits++;
            e.val = (e.val << 8) & (CODE_TOP - 1);
        }
        e.rng <<= 8;
        e.nbits_total += 8;
    }
}

__device__ void enc_encode(Enc &e, uint32_t fl, uint32_t fh, uint32_t ft) {
    if (ft < 1) ft = 1;
    uint32_t r = e.rng / ft;
    if (fl > 0) {
        if (!e.dry) e.val += e.rng - r * (ft - fl);
        e.rng = r * (fh - fl);
    } else {
        e.rng -= r * (ft - fh);
    }
    enc_normalize(e);
}

__device__ void enc_encode_bin(Enc &e, uint32_t fl, uint32_t fh, int bits) {
    uint32_t r = e.rng >> bits;
    uint32_t total = 1u << bits;
    if (fl > 0) {
        if (!e.dry) e.val += e.rng - r * (total - fl);
        e.rng = r * (fh - fl);
    } else {
        e.rng -= r * (total - fh);
    }
    enc_normalize(e);
}

__device__ void enc_bit_logp(Enc &e, int bit, int logp) {
    uint32_t r = e.rng;
    uint32_t s = r >> logp;
    if (bit) {
        if (!e.dry) e.val += r - s;
        e.rng = s;
    } else {
        e.rng = r - s;
    }
    enc_normalize(e);
}

__device__ void enc_icdf(Enc &e, int s, const int *icdf, int len, int ftb) {
    s = s < 0 ? 0 : (s > len - 1 ? len - 1 : s);
    uint32_t cur = (uint32_t)icdf[s];
    uint32_t prev = s > 0 ? (uint32_t)icdf[s - 1] : (1u << ftb);
    uint32_t r = e.rng >> ftb;
    if (s > 0) {
        if (!e.dry) e.val += e.rng - r * prev;
        e.rng = r * (prev - cur);
    } else {
        e.rng -= r * cur;
    }
    enc_normalize(e);
}

__device__ void enc_bits(Enc &e, uint32_t fl, int bits) {
    if (bits <= 0) return;
    if (e.dry) {
        e.nbits_total += bits;
        return;
    }
    if (e.nend_bits + bits > 32) {
        for (int t = 0; t < 4; t++) {
            if (e.nend_bits >= 8) {
                if (e.nend < e.ecap && lane_id() == 0)
                    e.endb[e.nend] = (uint8_t)(e.end_window & 255u);
                e.nend++;
                e.end_window >>= 8;
                e.nend_bits -= 8;
            }
        }
    }
    e.end_window |= fl << e.nend_bits;
    e.nend_bits += bits;
    e.nbits_total += bits;
}

__device__ void enc_uint(Enc &e, uint32_t fl, uint32_t ft) {
    uint32_t ftm = (ft < 2 ? 2 : ft) - 1;
    int ftb = ilog(ftm);
    int sh = ftb > 8 ? ftb - 8 : 0;
    uint32_t hi = fl >> sh;
    enc_encode(e, hi, hi + 1, (ftm >> sh) + 1);
    if (sh > 0) enc_bits(e, fl & ((1u << sh) - 1), sh);
}

__device__ __forceinline__ int enc_tell(const Enc &e) {
    return e.nbits_total - ilog(e.rng);
}

__device__ int enc_tell_frac(const Enc &e) {
    int l = ilog(e.rng);
    uint32_t r = e.rng >> (l > 16 ? l - 16 : 0);
    int b = (int)(r >> 12) - 8;
    int bc = b < 0 ? 0 : (b > 7 ? 7 : b);
    b += r > (uint32_t)TELL_CORRECTION[bc];
    return (e.nbits_total << BITRES) - ((l << 3) + b);
}

__device__ void enc_done(Enc &e) {
    int l = 32 - ilog(e.rng);
    uint32_t msk = (CODE_TOP - 1) >> l;
    uint32_t end = (e.val + msk) & ~msk;
    if ((end | msk) >= e.val + e.rng) {
        l++;
        msk >>= 1;
        end = (e.val + msk) & ~msk;
    }
#pragma unroll 1
    for (int t = 0; t < 2; t++) {
        if (l > 0) {
            if (e.ndigits < e.dcap && lane_id() == 0)
                e.dig[e.ndigits] = (uint16_t)(end >> 23);
            e.ndigits++;
            end = (end << 8) & (CODE_TOP - 1);
        }
        l -= 8;
    }
}

// Carry resolution + byte assembly (rc_enc_kernel.finalize): whole bytes
// left in the end window go to the end buffer; digits resolve last to
// first; the stream is the resolved digits from the front, the end bytes
// from the back and the window's leftover bits before them.  The carry
// runs across the lanes: lane l owns a chunk of C digits, whose effect on
// a carry is a map {0, 1} -> {0, 1}; a warp scan composes the chunks'
// maps from the top, each lane then resolves its chunk from its incoming
// carry.  The bytes are written to out coalesced.  Returns the error
// flag (digits and end bytes do not fit).
__device__ int enc_finalize(Enc &e, uint8_t *out, int nbytes) {
    const int lane = lane_id();
    uint32_t window = e.end_window;
    int used = e.nend_bits, nend = e.nend;
    for (int t = 0; t < 4; t++) {
        if (used >= 8) {
            if (nend < e.ecap && lane == 0)
                e.endb[nend] = (uint8_t)(window & 255u);
            nend++;
            window >>= 8;
            used -= 8;
        }
    }
    __syncwarp();       // the digits and end bytes lane 0 stored
    uint16_t *dig = e.dig;
    const int nd = imin(e.ndigits, e.dcap);
    const int chunk = (nd + LANES - 1) / LANES;
    const int lo = lane * chunk, hi = imin(lo + chunk, nd);
    int g0 = 0, g1 = 1;         // the carry out of the chunk for 0 and 1 in
    for (int j = hi - 1; j >= lo; j--) {
        int d = dig[j];
        g0 = ((d + g0) >> 8) & 1;
        g1 = ((d + g1) >> 8) & 1;
    }
    // compose with the chunks above: g maps the carry into chunk
    // lane + span - 1 to the carry out of chunk lane
    for (int o = 1; o < LANES; o <<= 1) {
        int h0 = __shfl_down_sync(FULL, g0, o);
        int h1 = __shfl_down_sync(FULL, g1, o);
        if (lane + o < LANES) {
            int n0 = h0 ? g1 : g0;
            int n1 = h1 ? g1 : g0;
            g0 = n0;
            g1 = n1;
        }
    }
    int carry = __shfl_down_sync(FULL, g0, 1);
    if (lane == LANES - 1) carry = 0;
    for (int j = hi - 1; j >= lo; j--) {
        int v = (int)dig[j] + carry;
        dig[j] = (uint16_t)(v & 255);
        carry = (v >> 8) & 1;
    }
    __syncwarp();
    const int lpos = nbytes - nend - 1;
    for (int pos = lane; pos < nbytes; pos += LANES) {
        int byte = pos < e.ndigits ? (int)dig[pos] : 0;
        int ti = nbytes - 1 - pos;
        if (ti < nend && ti < e.ecap) byte |= e.endb[ti];
        if (used > 0 && pos == lpos) byte |= (int)(window & 255u);
        out[pos] = (uint8_t)byte;
    }
    return (e.ndigits + nend) > nbytes;
}

// ------------------------------------------------------------ plan pieces
// ec_laplace_encode with the static (fl, fs) chain of this band's model
// (celt_enc_fused._laplace_encode); returns the coded (possibly clamped)
// value.
__device__ int laplace_encode(Enc &e, const Tabs &T, int chain, int qi,
                              int fs0) {
    int fl, fs, value;
    if (qi == 0) {
        fl = 0;
        fs = fs0;
        value = 0;
    } else {
        const int32_t *lapoff = T.s(S_LAPOFF);
        const int32_t *lap = T.s(S_LAP) + lapoff[2 * chain];
        int big_l = lapoff[2 * chain + 1];
        int s = qi < 0 ? -1 : 0;
        int aval = qi < 0 ? -qi : qi;
        int i_stop = imin(aval, big_l);
        int fl_i = lap[2 * i_stop], fs_i = lap[2 * i_stop + 1];
        if (aval < big_l) {
            fs = fs_i + 1;
            fl = fl_i + (s == 0 ? fs : 0);
            value = qi;
        } else {
            int ndi_max = (32768 - fl_i - s) >> 1;
            int di = imin(aval - big_l, ndi_max - 1);
            fl = fl_i + (2 * di + 1 + s);
            fs = imin(1, 32768 - fl);
            value = (big_l + di + s) ^ s;
        }
    }
    enc_encode_bin(e, (uint32_t)fl, (uint32_t)(fl + fs), 15);
    return value;
}

// _quant_coarse_impl (quant_bands.c:156), mono.  Returns the badness;
// writes the new energy memory and the error (band i in lane i).
__device__ int coarse_impl(Enc &e, const Tabs &T, const Band<float> &x,
                           const Band<float> &old_e, Band<float> &new_old,
                           Band<float> &err, int budget, int tell0,
                           int intra, float max_decay) {
    const int nb = T.nb, lm = T.lm;
    const float coef = intra ? 0.0f : PRED_COEF[lm];
    const float beta = intra ? BETA_INTRA : BETA_COEF[lm];
    const int32_t *pm = T.s(S_EPROB) + intra * 42;
    if (tell0 + 3 <= budget) enc_bit_logp(e, intra, 3);
    float prev = 0.0f;
    int badness = 0;
    for (int i = 0; i < nb; i++) {
        const float xi = bget(x, i), oi = bget(old_e, i);
        float old = fmaxf(-9.0f, oi);
        float f = xi - coef * old - prev;
        int qi = (int)floorf(0.5f + f);
        float decay_bound = fmaxf(-28.0f, oi) - max_decay;
        if (qi < 0 && xi < decay_bound)
            qi = imin(qi + (int)(decay_bound - xi), 0);
        int qi0 = qi;
        int tell = enc_tell(e);
        int bits_left = budget - tell - 3 * (nb - i);
        if (i != 0 && bits_left < 30) {
            if (bits_left < 24) qi = imin(1, qi);
            if (bits_left < 16) qi = imax(-1, qi);
        }
        int pi = 2 * imin(i, 20);
        if (budget - tell >= 15) {
            qi = laplace_encode(e, T, intra * nb + i, qi, pm[pi] << 7);
        } else if (budget - tell >= 2) {
            qi = qi < -1 ? -1 : (qi > 1 ? 1 : qi);
            enc_icdf(e, (2 * qi) ^ -(qi < 0), SMALL_ENERGY_ICDF, 3, 2);
        } else if (budget - tell >= 1) {
            qi = imin(0, qi);
            enc_bit_logp(e, -qi, 1);
        } else {
            qi = -1;
        }
        bset(err, i, f - (float)qi);
        badness += qi0 > qi ? qi0 - qi : qi - qi0;
        float q = (float)qi;
        bset(new_old, i, coef * old + prev + q);
        prev = prev + q - beta * q;
    }
    return badness;
}

// quant_coarse_energy (quant_bands.c:260): dry intra and inter trials,
// then the picked pass for real.  Returns pick_intra.
__device__ int coarse_energy(Enc &e, const Tabs &T, WarpMem *w,
                             const Band<float> &x, const Band<float> &old_in,
                             Band<float> &old_e, Band<float> &err,
                             int budget, int nbytes, float &delayed_intra) {
    const int nb = T.nb, lm = T.lm, lane = lane_id();
    for (int s = 0; s < BSLOTS; s++) {
        int j = s * LANES + lane;
        if (j < nb) {
            float d = (x.v[s] - old_in.v[s]) * (x.v[s] - old_in.v[s]);
            w->sa[j] = fminf(d, 200.0f);
        }
    }
    __syncwarp();
    float new_distortion = fminf(tree_sum(w->sa, w->sb, nb), 200.0f);
    int tell0 = enc_tell(e);
    int two_pass = tell0 + 3 <= budget;
    float max_decay = fminf(16.0f, (float)(0.125 * nbytes));
    Band<float> tmp, tmp_err;
    int bad1 = 0;
    Enc d1 = e;
    d1.dry = true;
    if (two_pass)
        bad1 = coarse_impl(d1, T, x, old_in, tmp, tmp_err, budget, tell0, 1,
                           max_decay);
    int tf1 = enc_tell_frac(d1);
    Enc d2 = e;
    d2.dry = true;
    int bad2 = coarse_impl(d2, T, x, old_in, tmp, tmp_err, budget, tell0, 0,
                           max_decay);
    int tf2 = enc_tell_frac(d2);
    int pick = two_pass && (bad1 < bad2 || (bad1 == bad2 && tf2 > tf1));
    coarse_impl(e, T, x, old_in, old_e, err, budget, tell0, pick, max_decay);
    const float pc = PRED_COEF[lm];
    const float pc2 = (float)((double)pc * (double)pc);
    delayed_intra = pick ? new_distortion
                         : pc2 * delayed_intra + new_distortion;
    return pick;
}

// tf_encode (celt_encoder.c:824); tf_vals gets the TF_SELECT_TABLE values.
__device__ void tf_encode(Enc &e, const Tabs &T, const Band<int> &tf_res,
                          int tf_select, int tr, int budget,
                          Band<int> &tf_vals) {
    const int nb = T.nb, lm = T.lm;
    int tell = enc_tell(e);
    int logp0 = tr ? 2 : 4;
    int rsv = lm > 0 && tell + logp0 + 1 <= budget;
    budget -= rsv;
    int curr = 0, changed = 0;
    Band<int> out;
    for (int i = 0; i < nb; i++) {
        int logp = i == 0 ? logp0 : (tr ? 4 : 5);
        if (tell + logp <= budget) {
            int ti = bget(tf_res, i);
            enc_bit_logp(e, ti ^ curr, logp);
            tell = enc_tell(e);
            curr = ti;
        }
        bset(out, i, curr);
        changed |= curr;
    }
    const int *tab = TF_SELECT_TABLE[lm];
    int t4 = 4 * tr;
    if (rsv && tab[t4 + changed] != tab[t4 + 2 + changed])
        enc_bit_logp(e, tf_select, 1);
    else
        tf_select = 0;
    for (int s = 0; s < BSLOTS; s++)
        tf_vals.v[s] = s * LANES + lane_id() < nb
            ? tab[t4 + 2 * tf_select + out.v[s]] : 0;
}

__device__ __forceinline__ int alloc_col(const Tabs &T, int j, int v) {
    const int32_t *eB = T.s(S_EBANDS);
    int w = eB[j + 1] - eB[j];
    return (w * T.s(S_ALLOCV)[v * T.nb + j]) << T.lm >> 2;
}

// compute_allocation + interp_bits2pulses, mono encode (rate.c:535/249),
// as celt_enc_fused._compute_allocation_enc, the bands in lanes.  Returns
// coded_bands.
__device__ int compute_allocation(Enc &e, const Tabs &T,
                                  const Band<int> &offsets, int trim,
                                  int total, int prev_cb, int &balance_out,
                                  Band<int> &bits, Band<int> &ebits,
                                  Band<int> &fine_priority) {
    const int nb = T.nb, lm = T.lm, nv = T.nv, lane = lane_id();
    const int32_t *eB = T.s(S_EBANDS);
    const int32_t *caps = T.s(S_CAPS);
    const int32_t *logN = T.s(S_LOGN);
    const int alloc_floor = 1 << BITRES;
    Band<int> thresh, trim_off, bits1, bits2;
    total = imax(total, 0);
    int skip_rsv = total >= (1 << BITRES) ? 1 << BITRES : 0;
    total -= skip_rsv;
    for (int s = 0; s < BSLOTS; s++) {
        int j = s * LANES + lane;
        thresh.v[s] = trim_off.v[s] = bits1.v[s] = bits2.v[s] = 0;
        bits.v[s] = ebits.v[s] = fine_priority.v[s] = 0;
        if (j >= nb) continue;
        int w = eB[j + 1] - eB[j];
        thresh.v[s] = imax((3 * w << lm << BITRES) >> 4, 1 << BITRES);
        int t = (w * (trim - 5 - lm) * (nb - 1 - j) * (1 << (lm + BITRES)))
            >> 6;
        if ((w << lm) == 1) t -= 1 << BITRES;
        trim_off.v[s] = t;
    }
    int lo = 1, hi = nv - 1;
    for (int it = 0; it < 6; it++) {
        if (lo > hi) continue;
        int mid = (lo + hi) >> 1;
        int psum = alloc_sum(nb, caps, [&](int s, int j, int &thr) {
            int bj = alloc_col(T, j, mid);
            if (bj > 0) bj = imax(bj + trim_off.v[s], 0);
            thr = thresh.v[s];
            return bj + offsets.v[s];
        });
        if (psum > total) hi = mid - 1;
        else lo = mid + 1;
    }
    int hi_f = lo, lo_f = lo - 1;
    // skip_start: the highest band with a dynalloc boost, else 0
    int skip_start = 0;
    for (int s = BSLOTS - 1; s >= 0; s--) {
        int j = s * LANES + lane;
        unsigned m = __ballot_sync(FULL, j < nb && offsets.v[s] > 0);
        if (m) {
            skip_start = s * LANES + 31 - __clz(m);
            break;
        }
    }
    const int loc = lo_f < 0 ? 0 : (lo_f > nv - 1 ? nv - 1 : lo_f);
    const int hic = hi_f < 0 ? 0 : (hi_f > nv - 1 ? nv - 1 : hi_f);
    for (int s = 0; s < BSLOTS; s++) {
        int j = s * LANES + lane;
        if (j >= nb) continue;
        int b1 = alloc_col(T, j, loc);
        int b2 = hi_f >= nv ? caps[j] : alloc_col(T, j, hic);
        if (b1 > 0) b1 = imax(b1 + trim_off.v[s], 0);
        if (b2 > 0) b2 = imax(b2 + trim_off.v[s], 0);
        if (lo_f > 0) b1 += offsets.v[s];
        b2 += offsets.v[s];
        bits1.v[s] = b1;
        bits2.v[s] = imax(b2 - b1, 0);
    }

    // ---- interp_bits2pulses ----
    lo = 0;
    hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
        int mid = (lo + hi) >> 1;
        int psum = alloc_sum(nb, caps, [&](int s, int, int &thr) {
            thr = thresh.v[s];
            return bits1.v[s] + ((mid * bits2.v[s]) >> ALLOC_STEPS);
        });
        if (psum > total) hi = mid;
        else lo = mid;
    }
    // the chosen trial's bits per band, summed as alloc_sum does
    int psum = 0, done_hi = 0;
    for (int s = BSLOTS - 1; s >= 0; s--) {
        int j = s * LANES + lane;
        int in = j < nb;
        int tmp = in ? bits1.v[s] + ((lo * bits2.v[s]) >> ALLOC_STEPS) : 0;
        unsigned m = __ballot_sync(FULL, in && tmp >= thresh.v[s]);
        int done = done_hi || (m >> lane) != 0;
        if (!done) tmp = tmp >= alloc_floor ? alloc_floor : 0;
        if (in) {
            tmp = imin(tmp, caps[j]);
            bits.v[s] = tmp;
            psum += tmp;
        }
        done_hi |= m != 0;
    }
    psum = warp_sum(psum);
    int coded = nb;
    int forced_stop = 0;
    for (int j = nb - 1; j > 0; j--) {
        if (coded != j + 1) break;
        if (j <= skip_start) {
            forced_stop = 1;
            break;
        }
        int left = total - psum;
        int den = eB[j + 1] - eB[0];
        int percoeff = floordiv(left, den);
        int leftr = left - den * percoeff;
        int rem = imax(leftr - (eB[j] - eB[0]), 0);
        int band_width = eB[j + 1] - eB[j];
        int bj = bget(bits, j);
        int band_bits = bj + percoeff * band_width + rem;
        int th = imax(bget(thresh, j), alloc_floor + (1 << BITRES));
        int stop = 0;
        if (band_bits >= th) {
            int depth_threshold = coded > 17 ? (j < prev_cb ? 7 : 9) : 0;
            stop = coded <= 2
                || (band_bits > ((depth_threshold * band_width << lm
                                  << BITRES) >> 4)
                    && j <= nb - 1);
            enc_bit_logp(e, stop, 1);
            if (stop) break;
            psum += 1 << BITRES;
            band_bits -= 1 << BITRES;
        }
        int keep = band_bits >= alloc_floor ? alloc_floor : 0;
        psum = psum - bj + keep;
        bset(bits, j, keep);
        coded--;
    }
    if (forced_stop) total += skip_rsv;

    // the leftover bits: percoeff per coefficient of the coded bands, then
    // the remainder from the lowest band up, each at most its width (the
    // serial take loop in closed form: the remainder is below the coded
    // width)
    int left = total - psum;
    int den = imax(eB[coded] - eB[0], 1);
    int percoeff = floordiv(left, den);
    left -= den * percoeff;
    for (int s = 0; s < BSLOTS; s++) {
        int j = s * LANES + lane;
        if (j >= coded) continue;
        int wj = eB[j + 1] - eB[j];
        bits.v[s] += percoeff * wj + imin(imax(left - (eB[j] - eB[0]), 0), wj);
    }
    int balance = 0;
    const int log_m = lm << BITRES;
    for (int j = 0; j < nb; j++) {
        int n = (eB[j + 1] - eB[j]) << lm;
        int in_c = j < coded;
        int bitsj = bget(bits, j);
        int bitj = bitsj + balance;
        int excess, bj, eb, fp;
        if (n > 1) {
            excess = imax(bitj - caps[j], 0);
            bj = bitj - excess;
            int nclogn = n * (logN[j] + log_m);
            int offset = (nclogn >> 1) - n * FINE_OFFSET;
            if (n == 2) offset += n << BITRES >> 2;
            int off1 = bj + offset < (n * 2 << BITRES)
                ? offset + (nclogn >> 2)
                : (bj + offset < (n * 3 << BITRES) ? offset + (nclogn >> 3)
                                                  : offset);
            eb = imax(bj + off1 + (n << (BITRES - 1)), 0);
            eb = floordiv(eb, n) >> BITRES;
            if (eb > (bj >> BITRES)) eb = bj >> BITRES;
            eb = imin(eb, MAX_FINE_BITS);
            fp = eb * (n << BITRES) >= bj + off1;
            bj -= eb << BITRES;
        } else {
            excess = imax(bitj - (1 << BITRES), 0);
            bj = bitj - excess;
            eb = 0;
            fp = 1;
        }
        int extra_fine = imin(excess >> BITRES, MAX_FINE_BITS - eb);
        int eb2 = eb, excess2 = excess;
        if (excess > 0) {
            eb2 = eb + extra_fine;
            fp = (extra_fine << BITRES) >= excess - balance;
            excess2 = excess - (extra_fine << BITRES);
        }
        int unc_eb = bitsj >> BITRES;
        bset(ebits, j, in_c ? eb2 : unc_eb);
        bset(fine_priority, j, in_c ? fp : (int)(unc_eb < 1));
        bset(bits, j, in_c ? bj : 0);
        if (in_c) balance = excess2;
    }
    balance_out = balance;
    return coded;
}

// ------------------------------------------------------- theta + PVQ leaf
__device__ int compute_qn(int n2, int b, int offset, int pulse_cap) {
    int n2x = 2 * n2 - 1;
    int qb = (b + n2x * offset) / n2x;   // C truncating division
    if (qb > b - pulse_cap - (4 << BITRES)) qb = b - pulse_cap - (4 << BITRES);
    if (qb > 8 << BITRES) qb = 8 << BITRES;
    if (qb < (1 << BITRES >> 1)) return 1;
    int sh = 14 - (qb >> BITRES);
    sh = sh < 0 ? 0 : (sh > 31 ? 31 : sh);
    return ((EXP2_TABLE8[qb & 7] >> sh) + 1) >> 1 << 1;
}

__device__ __forceinline__ int frac_mul16(int a, int b) {
    return (16384 + a * b) >> 15;
}

__device__ int bitexact_cos(int x) {
    int x2 = (4096 + x * x) >> 13;
    x2 = (32767 - x2)
        + frac_mul16(x2, -7651 + frac_mul16(x2, 8277 + frac_mul16(-626, x2)));
    return 1 + x2;
}

__device__ int bitexact_log2tan(int isin, int icos) {
    int lc = ilog((uint32_t)icos);
    int ls = ilog((uint32_t)isin);
    icos <<= 15 - lc;
    isin <<= 15 - ls;
    return (ls - lc) * (1 << 11)
        + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
        - frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

// atan2 for y, x >= 0 as the JAX twin's odd polynomial (not atan2f)
__device__ float atan2p(float y, float x) {
    int swap = y > x;
    float num = fminf(y, x);
    float den = fmaxf(fmaxf(y, x), 1e-30f);
    float r = num / den;
    float z = r / (1.0f + sqrtf(1.0f + r * r));
    float z2 = z * z;
    float p = (float)(1 / 13.0);
    p = p * z2 + (float)(-1 / 11.0);
    p = p * z2 + (float)(1 / 9.0);
    p = p * z2 + (float)(-1 / 7.0);
    p = p * z2 + (float)(1 / 5.0);
    p = p * z2 + (float)(-1 / 3.0);
    p = p * z2 + 1.0f;
    float a = 2.0f * z * p;
    return swap ? (float)(0.5 * 3.14159265358979323846) - a : a;
}

// compute_theta, mono encode (bands.c:700).  Updates b and rb; returns the
// Q14 itheta and delta.
__device__ void theta_encode(Enc &e, const Tabs &T, int band, int n2, int &b,
                             int b0, int lm2, float emid, float eside,
                             int avoid, int &rb, int &itheta_q14,
                             int &delta) {
    int pulse_cap = T.s(S_LOGN)[band] + lm2 * (1 << BITRES);
    int offset = (pulse_cap >> 1) - QTHETA_OFFSET;
    int qn = compute_qn(n2, b, offset, pulse_cap);
    int tell0 = enc_tell_frac(e);
    const float scale = (float)(16384 * 0.63662);
    int itheta_raw = (int)floorf(
        0.5f + scale * atan2p(sqrtf(eside), sqrtf(emid)));
    int has_theta = qn != 1;
    int itheta = (itheta_raw * qn + 8192) >> 14;
    if (has_theta && avoid && itheta > 0 && itheta < qn) {
        int unq = itheta * 16384 / imax(qn, 1);
        int imid = bitexact_cos(unq);
        int iside = bitexact_cos(16384 - unq);
        int d = frac_mul16((n2 - 1) << 7, bitexact_log2tan(iside, imid));
        if (d > b) itheta = qn;
        else if (d < -b) itheta = 0;
    }
    if (has_theta) {
        if (b0 > 1) {
            enc_uint(e, (uint32_t)itheta, (uint32_t)(qn + 1));
        } else {
            int qh = qn >> 1;
            int ft = (qh + 1) * (qh + 1);
            int low = itheta <= qh;
            int fs = low ? itheta + 1 : qn + 1 - itheta;
            int fl = low ? (itheta * (itheta + 1)) >> 1
                         : ft - (((qn + 1 - itheta) * (qn + 2 - itheta)) >> 1);
            enc_encode(e, (uint32_t)fl, (uint32_t)(fl + fs), (uint32_t)ft);
        }
        itheta_q14 = itheta * 16384 / imax(qn, 1);
    } else {
        itheta_q14 = itheta_raw;
    }
    int qalloc = enc_tell_frac(e) - tell0;
    b -= qalloc;
    rb -= qalloc;
    if (itheta_q14 == 0) {
        delta = -16384;
    } else if (itheta_q14 == 16384) {
        delta = 16384;
    } else {
        int imid = bitexact_cos(itheta_q14);
        int iside = bitexact_cos(16384 - itheta_q14);
        delta = frac_mul16((n2 - 1) << 7, bitexact_log2tan(iside, imid));
    }
}

// exp_rotation1 (vq.c) restricted to the chain of positions r, r + stride,
// ...: its forward and backward recurrences touch no other chain.  The
// value each step hands to the next stays in a register.
__device__ void rotation_chain(float *x, int len, int stride, int r, float c,
                               float s) {
    int i = r;
    float x1 = x[r];
    for (; i < len - stride; i += stride) {
        float x2 = x[i + stride];
        x[i] = c * x1 - s * x2;
        x1 = c * x2 + s * x1;
    }
    x[i] = x1;
    int top = len - 2 * stride - 1;
    if (top < r) return;
    i = top - ((top - r) % stride);
    float x2 = x[i + stride];
    for (; i >= 0; i -= stride) {
        float y1 = x[i];
        x[i + stride] = c * x2 + s * y1;
        x2 = c * y1 - s * x2;
    }
    x[i + stride] = x2;
}

// exp_rotation direction=+1 (vq.c:104) on x (shared memory, synced): per
// segment the stride-1 pass with (c, -s), then the stride2 pass with
// (s, -c); cos/sin from the table.  The segments' stride-1 chains run on
// separate lanes, then their stride2 chains.
__device__ void exp_rotation_enc(const Tabs &T, float *x, int n, int sv,
                                 int k, int spread) {
    if (spread == 0 || 2 * k >= n || n < sv) return;
    const float *cs = T.f + T.s(S_ROTOFF)[n] + (spread * (MAX_K + 1) + k) * 2;
    const float c = cs[0], s = cs[1];
    int stride2 = 0;
    if (n >= 8 * sv) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * sv + (sv >> 2) < n) stride2++;
    }
    const int len = n / sv;
    for (int seg = lane_id(); seg < sv; seg += LANES)
        rotation_chain(x + seg * len, len, 1, 0, c, -s);
    __syncwarp();
    if (stride2) {
        for (int p = lane_id(); p < sv * stride2; p += LANES)
            rotation_chain(x + (p / stride2) * len, len, stride2, p % stride2,
                           s, -c);
        __syncwarp();
    }
}

// the warp argmax of a greedy pulse step over groups of `width` lanes (a
// power of two): the larger score, the lower index on a tie (the serial
// first maximum); the winner's |x| and pulse count travel with it
__device__ __forceinline__ void pulse_argmax(int width, float &s, int &j,
                                             float &a, int &y) {
    for (int o = width >> 1; o > 0; o >>= 1) {
        const float s2 = __shfl_xor_sync(FULL, s, o);
        const int j2 = __shfl_xor_sync(FULL, j, o);
        const float a2 = __shfl_xor_sync(FULL, a, o);
        const int y2 = __shfl_xor_sync(FULL, y, o);
        if (j2 >= 0 && (j < 0 || s2 > s || (s2 == s && j2 < j))) {
            s = s2;
            j = j2;
            a = a2;
            y = y2;
        }
    }
}

// op_pvq_search (vq.c:205) across the warp on x (shared memory, synced):
// the projection, then one pulse at a time.  Position j is always handled
// by lane j % K3_LANES, so a lane reads and writes only its own xa[j] and
// iy[j] after the sums: the greedy steps need no __syncwarp.  Each step's
// scores are the serial f32 expressions; pulse_argmax picks the serial
// first maximum.  A leaf no wider than the warp keeps its position's |x|
// and pulse count in registers and reduces over the next power of two
// above n lanes (the lanes above hold no position and their copies of
// xy and yy, which nothing reads after the search, go stale).  iy gets
// the signed pulses.
__device__ void pvq_search(WarpMem *w, const float *x, int n, int k,
                           int kcap, int &evals) {
    const int lane = lane_id();
    const bool narrow = n <= LANES;
    float *xa = w->xa;
    int *iy = w->iy;
    // without the projection (k <= n / 2) the pulses start at 0, so yy and
    // xy are sums of zeros, +0 in any order, and the sum of |x| is unused
    const int proj = k > (n >> 1);
    float sum = 0.0f, yy = 0.0f, xy = 0.0f;
    int isum = 0;
    if (narrow) {
        const float a = lane < n ? fabsf(x[lane]) : 0.f;
        xa[lane] = a;
        iy[lane] = 0;
        if (proj) {
            sum = tree_sum_lanes(a, n);
            const bool bad = !(sum > 1e-15f && sum < 64.0f);
            const float a1 = bad ? (lane == 0 ? 1.0f : 0.0f) : a;
            if (bad) sum = 1.0f;
            xa[lane] = a1;
            const float rcp = ((float)k + 0.8f) / sum;
            const int v = lane < n ? (int)floorf(rcp * a1) : 0;
            iy[lane] = v;
            isum = warp_sum(v);
            yy = tree_sum_lanes((float)(v * v), n);
            xy = tree_sum_lanes(a1 * (float)v, n);
        }
    } else {
        for (int j = lane; j < n; j += LANES) {
            float a = fabsf(x[j]);
            xa[j] = a;
            iy[j] = 0;
            w->sa[j] = a;
        }
        if (proj) {
            __syncwarp();
            sum = tree_sum(w->sa, w->sb, n);
            if (!(sum > 1e-15f && sum < 64.0f)) {
                for (int j = lane; j < n; j += LANES)
                    xa[j] = j == 0 ? 1.0f : 0.0f;
                sum = 1.0f;
            }
            const float rcp = ((float)k + 0.8f) / sum;
            for (int j = lane; j < n; j += LANES) {
                int v = (int)floorf(rcp * xa[j]);
                iy[j] = v;
                isum += v;
                w->sa[j] = (float)(v * v);
            }
            isum = warp_sum(isum);
            __syncwarp();
            yy = tree_sum(w->sa, w->sb, n);
            for (int j = lane; j < n; j += LANES)
                w->sa[j] = xa[j] * (float)iy[j];
            __syncwarp();
            xy = tree_sum(w->sa, w->sb, n);
        }
    }
    int pulses_left = proj ? k - isum : k;
    if (pulses_left > n + 3) {
        __syncwarp();       // lane 0's iy[0] (a shuffle is no fence)
        float tmpf = (float)pulses_left;
        yy = yy + tmpf * tmpf + tmpf * 2.0f * (float)iy[0];
        __syncwarp();       // every lane has read iy[0]
        if (lane == 0) iy[0] += pulses_left;
        __syncwarp();
        pulses_left = 0;
    }
    const int cap = imin(kcap, n + 3);
    const int steps = imin(cap, pulses_left);
    evals += steps > 0 ? steps * n : 0;
    if (narrow) {
        int width = 1;
        while (width < n) width <<= 1;
        const float a = xa[lane];
        int y = iy[lane];
        for (int t = 0; t < steps; t++) {
            const float yy1 = yy + 1.0f;
            const float rxy = xy + a;
            float best_s = (rxy * rxy) / (yy1 + 2.0f * (float)y);
            int best = lane < n ? lane : -1;
            float best_xa = a;
            int best_iy = y;
            pulse_argmax(width, best_s, best, best_xa, best_iy);
            xy = xy + best_xa;
            yy = yy1 + 2.0f * (float)best_iy;
            y += lane == best;
        }
        if (lane < n) iy[lane] = x[lane] < 0 ? -y : y;
    } else {
        for (int t = 0; t < steps; t++) {
            const float yy1 = yy + 1.0f;
            int best = -1, best_iy = 0;
            float best_s = 0.0f, best_xa = 0.0f;
            for (int j = lane; j < n; j += LANES) {
                const float a = xa[j];
                const int y = iy[j];
                const float rxy = xy + a;
                const float score = (rxy * rxy) / (yy1 + 2.0f * (float)y);
                if (best < 0 || score > best_s) {
                    best_s = score;
                    best = j;
                    best_xa = a;
                    best_iy = y;
                }
            }
            pulse_argmax(LANES, best_s, best, best_xa, best_iy);
            xy = xy + best_xa;
            yy = yy1 + 2.0f * (float)best_iy;
            if (lane == best % LANES) iy[best] = best_iy + 1;
        }
        for (int j = lane; j < n; j += LANES)
            if (x[j] < 0) iy[j] = -iy[j];
    }
    __syncwarp();
}

// icwrs (cwrs.c:444) + ec_enc_uint(idx, V(n, k)).  The suffix sums of |iy|
// run row by row (K3_LANES positions, top row first) as a lane scan plus
// the rows above; each lane adds its positions' U terms and the lanes'
// sum (mod 2^32) goes to every lane.  A leaf no wider than the warp scans
// and sums over the next power of two above n lanes only.
__device__ void encode_pulses(Enc &e, const Tabs &T, const int *iy, int n,
                              int k, int kcap) {
    const int lane = lane_id();
    const int kc = imin(kcap + 2, T.urows - 1);
    int width = 1;
    while (width < n && width < LANES) width <<= 1;
    uint32_t idx = 0;
    int above = 0;          // sum of |iy| over the rows above
    for (int r = (n - 1) / LANES; r >= 0; r--) {
        const int j = r * LANES + lane;
        const int y = j < n ? iy[j] : 0;
        const int a = y < 0 ? -y : y;
        int s = a;          // sum over this row's lanes >= lane
        for (int o = 1; o < width; o <<= 1) {
            int v = __shfl_down_sync(FULL, s, o);
            if (lane + o < LANES) s += v;
        }
        const int t_incl = s + above;
        const int s_excl = t_incl - a;
        if (j < n - 1) {
            const int nj = n - j;
            idx += Utab(T, imin(s_excl, kc), nj);
            if (y < 0) idx += Utab(T, imin(t_incl + 1, kc), nj);
        } else if (j == n - 1) {
            idx += y < 0;
        }
        above += __shfl_sync(FULL, s, 0);
    }
    for (int o = width >> 1; o > 0; o >>= 1)
        idx += __shfl_xor_sync(FULL, idx, o);
    if (width < LANES) idx = __shfl_sync(FULL, idx, 0);
    enc_uint(e, idx, Vtab(T, imin(k, kcap), n));
}

// ------------------------------------------------------------ band tree
// quant_partition encode over one band's static split tree, preorder,
// with an explicit stack in shared memory (every lane reads it, lane 0
// writes): only nodes this stream reaches are visited (a child exists
// where its parent split).  xw is the band's window; split nodes swap its
// halves in place when the side is coded first, and a leaf rotates its
// own part in place (no later node reads it).
__device__ void band_tree(Enc &e, const Tabs &T, WarpMem *w, int band,
                          int n_root, float *xw, int &rb, int spread,
                          int bb_root, int b_band, int avoid, int &evals) {
    const int lm = T.lm, lane = lane_id();
    int (*st)[STACK] = w->st;
    int (*node)[STACK] = w->node;
    int top = 0;
    __syncwarp();
    if (lane == 0) node[0][0] = node[1][0] = node[2][0] = 0;
    __syncwarp();
    while (top >= 0) {
        const int dd = node[0][top], off = node[1][top],
                  isv1 = node[2][top];
        top--;
        const int nd = n_root >> dd;
        const int lmd = lm - dd;
        int bb = bb_root;
        for (int t = 0; t < dd; t++) bb = (bb + 1) >> 1;
        int b;
        if (dd == 0) {
            b = b_band;
        } else {
            const int p = dd - 1;
            const int swap = st[0][p];
            const int b_v0 = swap ? st[2][p] : st[1][p];
            if (isv1) {
                int rebalance = b_v0 - (st[4][p] - rb);
                int anchor = swap ? 16384 : 0;
                int extra = (rebalance > (3 << BITRES) && st[3][p] != anchor)
                    ? rebalance - (3 << BITRES) : 0;
                b = (swap ? st[1][p] : st[2][p]) + extra;
            } else {
                b = b_v0;
            }
        }
        const int32_t *row = cache_row(T, lmd, band);
        const int L = row[0];
        if (lmd != -1 && nd > 2 && b > row[L] + 12) {
            PROF_T(t_th);
            const int n2 = nd >> 1;
            for (int j = lane; j < n2; j += LANES) {
                float m = xw[off + j], sd = xw[off + n2 + j];
                w->sa[j] = m * m;
                w->sa[HALF + j] = sd * sd;
            }
            __syncwarp();
            float emid, eside;
            tree_sum2(w->sa, w->sb, n2, emid, eside);
            emid += 1e-15f;
            eside += 1e-15f;
            int itheta, delta;
            const int lm2 = lmd - 1;
            theta_encode(e, T, band, n2, b, bb, lm2, emid, eside, avoid, rb,
                         itheta, delta);
            if (bb > 1 && (itheta & 0x3fff) != 0) {
                if (itheta > 8192) delta -= delta >> (4 - lm2);
                else delta = imin(0, delta + ((n2 << BITRES) >> (5 - lm2)));
            }
            int mbits = imax(0, imin(b, floordiv(b - delta, 2)));
            int sbits = b - mbits;
            int swap = mbits < sbits;
            // push the two children; every lane has read the popped frame
            // and its parent's record (the tree sums synced since)
            if (lane == 0) {
                st[0][dd] = swap;
                st[1][dd] = mbits;
                st[2][dd] = sbits;
                st[3][dd] = itheta;
                st[4][dd] = rb;
                node[0][top + 1] = dd + 1;
                node[1][top + 1] = off + n2;
                node[2][top + 1] = 1;
                node[0][top + 2] = dd + 1;
                node[1][top + 2] = off;
                node[2][top + 2] = 0;
            }
            if (swap) {
                for (int j = lane; j < n2; j += LANES) {
                    float t = xw[off + j];
                    xw[off + j] = xw[off + n2 + j];
                    xw[off + n2 + j] = t;
                }
            }
            __syncwarp();
            top += 2;
            PROF_ADD(8, t_th);
            continue;
        }
        // ---- leaf: bits -> pulses -> rotate / search / index ----
        const int bm1 = b - 1;
        int lo = 0, c_fit = 0;
        for (int j0 = 1; j0 <= L; j0 += LANES) {
            const int j = j0 + lane;
            const int rj = j <= L ? row[j] : 0;
            lo += __popc(__ballot_sync(FULL, j <= L && bm1 > rj));
            c_fit += __popc(__ballot_sync(FULL, j <= L && rb >= rj + 1));
        }
        const int hi = imin(lo + 1, L);
        const int lo_val = lo == 0 ? -1 : row[lo];
        int q = (bm1 - lo_val <= row[hi] - bm1) ? lo : hi;
        q = imax(imin(q, imax(c_fit, 0)), 0);
        if (q > 0) rb -= row[q] + 1;
        const int kq = q < 8 ? q : (8 + (q & 7)) << imax((q >> 3) - 1, 0);
        if (kq != 0) {
            const int kcap = T.s(S_KCAP)[band * (lm + 2) + dd];
            float *xs = xw + off;
            PROF_T(t_rot);
            exp_rotation_enc(T, xs, nd, bb, kq, spread);
            PROF_ADD(9, t_rot);
            PROF_T(t_pvq);
            pvq_search(w, xs, nd, kq, kcap, evals);
            PROF_ADD(10, t_pvq);
            PROF_T(t_cw);
            encode_pulses(e, T, w->iy, nd, kq, kcap);
            PROF_ADD(11, t_cw);
        }
    }
}

// ------------------------------------------------------------ the kernel
// bytes of a warp's digit and end-byte buffers, each a multiple of 16
__device__ __host__ __forceinline__ int dig_bytes(int nbytes) {
    return ((nbytes + 4) * 2 + 15) & ~15;
}

__device__ __host__ __forceinline__ int warp_bytes(int nbytes) {
    return (int)sizeof(WarpMem) + dig_bytes(nbytes) + ((nbytes + 1 + 15) & ~15);
}

// one resident block per SM asked of ptxas: up to 128 registers a thread
__global__ void __launch_bounds__(WARPS * LANES, 1)
celt_enc_frame_kernel(const float *__restrict__ X,
                      const float *__restrict__ fin,
                      const int32_t *__restrict__ iin,
                      const int32_t *__restrict__ itab,
                      const float *__restrict__ ftab, uint8_t *payload,
                      float *fout, int32_t *iout, int B, int nbytes) {
    PROF_T(t_start);
    BlockMem &bm = *reinterpret_cast<BlockMem *>(k3_smem);
    const Tabs T = load_tabs(itab, ftab, bm.off);
    __syncthreads();
    const int lane = lane_id(), warp = threadIdx.x / LANES;
    const int stream = blockIdx.x * WARPS + warp;
    if (stream >= B) return;
    const int nb = T.nb, lm = T.lm, nx = T.nx;
    const int M = 1 << lm;
    const int32_t *eB = T.s(S_EBANDS);
    WarpMem *w = reinterpret_cast<WarpMem *>(
        k3_smem + sizeof(BlockMem) + (size_t)warp * warp_bytes(nbytes));
    uint16_t *dig = reinterpret_cast<uint16_t *>(w + 1);
    uint8_t *endb = reinterpret_cast<uint8_t *>(w + 1) + dig_bytes(nbytes);

    // ---- the stream's X row into shared memory, coalesced
    const float *xr = X + (size_t)stream * nx;
    if ((nx & 3) == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0) {
        for (int k = lane; k < nx >> 2; k += LANES)
            reinterpret_cast<float4 *>(w->X)[k] =
                reinterpret_cast<const float4 *>(xr)[k];
    } else {
        for (int j = lane; j < nx; j += LANES) w->X[j] = xr[j];
    }

    // ---- inputs: fin [B, 2nb+1] f32, iin [B, 7 + 2nb] i32, band i in
    // lane i
    const float *fr = fin + (size_t)stream * (2 * nb + 1);
    const int32_t *ir = iin + (size_t)stream * (7 + 2 * nb);
    Band<float> ble_b, old_in, old_e, err;
    Band<int> tf_res, offsets_cnt;
    for (int s = 0; s < BSLOTS; s++) {
        const int j = s * LANES + lane;
        const bool in = j < nb;
        ble_b.v[s] = in ? fr[j] : 0.f;
        old_in.v[s] = in ? fr[nb + j] : 0.f;
        old_e.v[s] = err.v[s] = 0.f;
        tf_res.v[s] = in ? ir[7 + j] : 0;
        offsets_cnt.v[s] = in ? ir[7 + nb + j] : 0;
    }
    float delayed_intra = fr[2 * nb];
    const int silence = ir[0] != 0;
    const int tr = ir[1] != 0;
    const int tf_select_in = ir[2];
    const int spread_calc = ir[3];
    const int trim_calc = ir[4];
    const int prev_cb = ir[5];
    const int consec_transient = ir[6];
    __syncwarp();       // the X row

    Enc e;
    enc_init(e, dig, endb, nbytes);
    const int total_bits = nbytes * 8;
    const int budget = total_bits;
    PROF_ADD(0, t_start);

    // ---- header: silence, postfilter off, transient ----
    PROF_T(t_head);
    enc_bit_logp(e, silence, 15);
    if (silence) e.nbits_total += total_bits - enc_tell(e);
    if (enc_tell(e) + 16 <= total_bits) enc_bit_logp(e, 0, 1);
    if (lm > 0 && enc_tell(e) + 3 <= total_bits) enc_bit_logp(e, tr, 3);

    // ---- coarse energy ----
    const int pick_intra = coarse_energy(e, T, w, ble_b, old_in, old_e, err,
                                         budget, nbytes, delayed_intra);
    PROF_ADD(1, t_head);

    // ---- tf ----
    PROF_T(t_tf);
    Band<int> tf_vals;
    tf_encode(e, T, tf_res, tf_select_in, tr, budget, tf_vals);

    // ---- spread ----
    const int can_sp = enc_tell(e) + 4 <= total_bits;
    const int use_calc = can_sp && !tr && nbytes >= 10;
    const int spread = use_calc ? spread_calc : 2;
    if (can_sp) enc_icdf(e, spread, SPREAD_ICDF, 4, 5);

    // ---- dynalloc boosts ----
    Band<int> offsets;
    int dyn_logp = 6;
    const int total_bits8 = total_bits << BITRES;
    int total_boost = 0;
    int tell_frac = enc_tell_frac(e);
    for (int i = 0; i < nb; i++) {
        int width = (eB[i + 1] - eB[i]) << lm;
        int quanta = imin(width << BITRES, imax(6 << BITRES, width));
        int cap_i = T.s(S_CAPS)[i];
        int cnt = bget(offsets_cnt, i);
        int dlp = dyn_logp, boost = 0, coded_any = 0;
        for (int j = 0; j <= cap_i / quanta; j++) {
            if (!(tell_frac + (dlp << BITRES) < total_bits8 - total_boost
                  && boost < cap_i))
                break;
            int flag = j < cnt;
            enc_bit_logp(e, flag, dlp);
            tell_frac = enc_tell_frac(e);
            if (!flag) break;
            boost += quanta;
            total_boost += quanta;
            dlp = 1;
            coded_any = 1;
        }
        if (coded_any) dyn_logp = imax(2, dyn_logp - 1);
        bset(offsets, i, boost);
    }

    // ---- trim ----
    int trim = 5;
    if (tell_frac + (6 << BITRES) <= total_bits8 - total_boost) {
        trim = trim_calc;
        enc_icdf(e, trim, TRIM_ICDF, 11, 7);
    }
    tell_frac = enc_tell_frac(e);
    PROF_ADD(2, t_tf);

    // ---- allocation ----
    PROF_T(t_alloc);
    int bits = total_bits8 - tell_frac - 1;
    const int anti_rsv = (tr && lm >= 2 && bits >= ((lm + 2) << BITRES))
        ? 1 << BITRES : 0;
    bits -= anti_rsv;
    Band<int> pulses, ebits, fine_priority;
    int balance;
    const int coded_bands = compute_allocation(e, T, offsets, trim, bits,
                                               prev_cb, balance, pulses,
                                               ebits, fine_priority);
    PROF_ADD(3, t_alloc);

    // ---- fine energy ----
    PROF_T(t_fine);
    for (int i = 0; i < nb; i++) {
        const int ebi = bget(ebits, i);
        if (!(ebi > 0 && enc_tell(e) + ebi <= total_bits)) continue;
        int ex = 1 << imin(imax(ebi, 0), MAX_FINE_BITS);
        float extra = (float)ex;
        const float erri = bget(err, i);
        int q2 = (int)floorf((erri + 0.5f) * extra);
        q2 = imin(imax(q2, 0), ex - 1);
        enc_bits(e, (uint32_t)q2, ebi);
        float offs = ((float)q2 + 0.5f) * pow2neg(ebi) - 0.5f;
        bset(old_e, i, bget(old_e, i) + offs);
        bset(err, i, erri - offs);
    }
    PROF_ADD(4, t_fine);

    // ---- PVQ bands ----
    PROF_T(t_bands);
    const int total_bits8b = nbytes * (8 << BITRES) - anti_rsv;
    int evals = 0;
    const int32_t *ewidx = T.s(S_EWIDX);
    for (int i = 0; i < nb; i++) {
        PROF_T(t_setup);
        const int n = M * (eB[i + 1] - eB[i]);
        const int base = M * eB[i];
        const int tell = enc_tell_frac(e);
        if (i != 0) balance -= tell;
        const int remaining = total_bits8b - tell - 1;
        const int den = imin(imax(coded_bands - i, 1), 3);
        const int curr_balance = balance / den;        // C truncation
        const int pi = bget(pulses, i);
        int b = 0;
        if (i <= coded_bands - 1) {
            b = imin(remaining + 1, pi + curr_balance);
            b = b < 0 ? 0 : (b > 16383 ? 16383 : b);
        }
        const int32_t *var = T.s(S_VAR) + i * NVAR * 4;
        const int tfv = bget(tf_vals, i);
        int bb_root = 0, ewoff = -1;
        for (int v = 0; v < NVAR && var[4 * v] >= 0; v++) {
            if (var[4 * v] == tr && var[4 * v + 1] == tfv) {
                bb_root = var[4 * v + 2];
                ewoff = var[4 * v + 3];
            }
        }
        // the band's window: the X row itself, or its wrap (the taps of
        // output c in index order, one output per lane)
        const float *xin = w->X + base;
        float *xw = w->X + base;
        if (ewoff >= 0) {
            xw = w->xw;
            for (int c = lane; c < n; c += LANES) {
                const int4 *ix = reinterpret_cast<const int4 *>(
                    ewidx + (size_t)(ewoff + c) * EW_SLOTS);
                const float4 *cf = reinterpret_cast<const float4 *>(
                    T.f + (size_t)(ewoff + c) * EW_SLOTS);
                const int4 i0 = ix[0], i1 = ix[1];
                const float4 c0 = cf[0], c1 = cf[1];
                float acc = 0.0f;
                acc = fmaf(xin[i0.x], c0.x, acc);
                acc = fmaf(xin[i0.y], c0.y, acc);
                acc = fmaf(xin[i0.z], c0.z, acc);
                acc = fmaf(xin[i0.w], c0.w, acc);
                acc = fmaf(xin[i1.x], c1.x, acc);
                acc = fmaf(xin[i1.y], c1.y, acc);
                acc = fmaf(xin[i1.z], c1.z, acc);
                acc = fmaf(xin[i1.w], c1.w, acc);
                xw[c] = acc;
            }
            __syncwarp();
        }
        PROF_ADD(12, t_setup);
        int rb = remaining;
        band_tree(e, T, w, i, n, xw, rb, spread, bb_root, b,
                  i == 0 ? tr : 0, evals);
        balance += pi + tell;
    }
    PROF_ADD(5, t_bands);

    // ---- anti-collapse flag ----
    PROF_T(t_fin);
    if (anti_rsv > 0) enc_bits(e, consec_transient < 2, 1);

    // ---- energy finalise + done ----
    int bits_left = total_bits - enc_tell(e);
    for (int prio = 0; prio < 2; prio++) {
        for (int i = 0; i < nb; i++) {
            const int ebi = bget(ebits, i);
            if (!(bits_left >= 1 && ebi < MAX_FINE_BITS
                  && bget(fine_priority, i) == prio))
                continue;
            const float erri = bget(err, i);
            int q2 = erri >= 0;
            enc_bits(e, (uint32_t)q2, 1);
            bset(err, i, erri - ((float)q2 - 0.5f) * pow2neg(ebi + 1));
            bits_left--;
        }
    }
    enc_done(e);
    const int error = enc_finalize(e, payload + (size_t)stream * nbytes,
                                   nbytes);
    PROF_ADD(6, t_fin);

    // ---- outputs: fout [B, 2nb+1], iout [B, 8]: INT_OUT, rng, error and
    // the count of pulse-search score evaluations (for the op bound) ----
    PROF_T(t_out);
    float *fo = fout + (size_t)stream * (2 * nb + 1);
    for (int s = 0; s < BSLOTS; s++) {
        const int j = s * LANES + lane;
        if (j < nb) {
            fo[j] = old_e.v[s];
            fo[nb + j] = err.v[s];
        }
    }
    if (lane == 0) {
        fo[2 * nb] = delayed_intra;
        int32_t *io = iout + (size_t)stream * 8;
        io[0] = pick_intra;
        io[1] = coded_bands;
        io[2] = spread;
        io[3] = can_sp;
        io[4] = use_calc;
        io[5] = (int32_t)e.rng;
        io[6] = error;
        io[7] = evals;
    }
    PROF_ADD(7, t_out);
    PROF_ADD(14, t_start);
}

}  // namespace

namespace {

// dynamic shared memory of a block: the staged offsets and each warp's
// WarpMem with its digit and end-byte buffers; above 48 KB the kernel
// must opt in, and a request the card cannot hold fails there
size_t block_smem(int nbytes) {
    return sizeof(BlockMem) + (size_t)WARPS * warp_bytes(nbytes);
}

cudaError_t opt_in_smem(size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(celt_enc_frame_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

}  // namespace

// X [B, nx], fin [B, 2nb+1], iin [B, 7+2nb]; payload [B, nbytes], fout
// [B, 2nb+1], iout [B, 8]; all row-major
extern "C" int opus_celt_enc_frame_launch(
    const void *X, const void *fin, const void *iin, const void *itab,
    const void *ftab, void *payload, void *fout, void *iout, int B,
    int nbytes, void *stream) {
    if (B <= 0) return 0;
    if (nbytes <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = block_smem(nbytes);
    cudaError_t e = opt_in_smem(smem);
    if (e != cudaSuccess) return (int)e;
    celt_enc_frame_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, smem,
                            (cudaStream_t)stream>>>(
        (const float *)X, (const float *)fin, (const int32_t *)iin,
        (const int32_t *)itab, (const float *)ftab, (uint8_t *)payload,
        (float *)fout, (int32_t *)iout, B, nbytes);
    return (int)cudaGetLastError();
}

#ifdef K3_PROFILE
// the cycle sums of k3_prof (K3_NPROF slots) into out, then zeroed
extern "C" int opus_celt_enc_frame_profile(unsigned long long *out) {
    static const unsigned long long zero[K3_NPROF] = {};
    cudaError_t e = cudaMemcpyFromSymbol(out, k3_prof, sizeof zero);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(k3_prof, zero, sizeof zero);
    return (int)e;
}
#endif

// K3's geometry at nbytes, for reports: info = [shared memory bytes per
// block, warps per block, resident blocks per SM, registers per thread,
// local memory bytes per thread]
extern "C" int opus_celt_enc_frame_occupancy(int nbytes, int *info) {
    const size_t smem = block_smem(nbytes);
    cudaError_t e = opt_in_smem(smem);
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, celt_enc_frame_kernel, WARPS * LANES, smem);
    cudaFuncAttributes a = {};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, celt_enc_frame_kernel);
    info[0] = (int)smem;
    info[1] = WARPS;
    info[2] = blocks;
    info[3] = a.numRegs;
    info[4] = (int)a.localSizeBytes;
    return (int)e;
}
