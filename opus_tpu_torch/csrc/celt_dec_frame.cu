// Kernel K1: the mono CELT decode symbol pass for one 10/20 ms frame, one
// warp per stream, over the coded bands [start, end): start 0 for a
// CELT-only frame, 17 for the CELT half of a hybrid frame, which continues
// the range decoder that SILK leaves behind (the optional per-stream
// initial coder state; src/opus_decoder.c:432).
//
// Replaces the Pallas TPU kernel opus_tpu/models/celt_dec_kernel.py:656
// (_frame_kernel, launched by build_frame_fn).  What is kept is the
// integer semantics of that kernel and of its [B]-lane twin
// opus_tpu_torch/models/celt_dec_fused.py (the plain version this kernel
// is checked against): range decoding, coarse/fine energy, tf, spread,
// dynalloc, trim, allocation, the PVQ band tree (CWRS, theta,
// exp_rotation, folding, haar/hadamard), anti-collapse and energy
// finalise, error lanes included.  What is dropped is the TPU layout: the
// [8,128] lane tiles, the preorder node program, the gather-free page
// sweeps and the MXU wrapper matrices.
//
// Bound on this card: a stream moves ~3.5 KB (160 packet bytes, 2 x 21
// energies in, 800 coefficients out), so the bytes bound is a few us at
// B = 4096; the time goes to the serial chain of dependent operations
// that range decoding and the band tree are, one chain per stream
// (opus_tpu_torch/tools/k1_profile.py splits it by phase).  So the
// design fills the card with chains, keeps their operands on chip and
// takes off the chain what does not depend on the range decoder:
//
// - One warp per stream, K1_WARPS (16) warps per block, one block per
//   SM: up to 128 registers a thread, so no spills.  B = 4096 gives 4096
//   warps, not the 128 warps of one thread per stream.
// - Warp-uniform control flow: all K1_LANES lanes hold the same range
//   decoder state and run the header, coarse energy, tf, spread, dynalloc,
//   trim, allocation, fine energy, the band tree, the anti-collapse bit
//   and finalise on the same values, so no branch diverges inside a warp.
//   No step runs on lane 0 alone to be broadcast: every lane computes the
//   same scalar, which costs the warp the same issue slots as one lane
//   does and needs no shuffle.  Stores of such scalars into shared memory
//   (the band-tree stack, the leaf records) are made by lane 0, between
//   two __syncwarp()s.
// - Per-band values (energies, tf, offsets, the allocation, fine bits,
//   collapse masks) live in registers, band i in lane i (Band<> below):
//   a read is one __shfl_sync, a write a select in the owning lane.  The allocation's trial sums run over the bands at once (a
//   ballot for "a higher band reached its threshold", a butterfly sum).
// - Per-warp shared memory instead of local memory: the packet bytes
//   (coalesced 16-byte loads), X, the fold buffer, the hadamard scratch,
//   the band-tree stack and the leaf records, 6016 bytes a warp at
//   P = 160.  libopus's fold memory norm is not kept: it always equals
//   sqrt(N) * X of the bands coded so far, so a fold reads X (see the
//   band loop).  The block stages the small mode tables once (eBands,
//   logN, caps, the alloc vectors, e_prob) with sqrt(N) and 1/sqrt(N) per
//   band and the band of each position; the pulse-cache rows and the CWRS
//   U table (stored column by column, so a search over k reads
//   consecutive words) stay in device memory, read through __ldg.
// - A band's split tree is decoded first and its leaves recorded; then
//   the leaves' cwrsi run at once, one lane each (a band of one leaf runs
//   it on the whole warp, whose downward k searches test K1_LANES
//   candidates at once with __ballot_sync).  The range decoder never
//   reads a pulse vector, so this changes no decision.
// - Vector passes across the lanes (j = lane; j < n; j += K1_LANES): the
//   zeroing and fold copies, the pulse-to-float scale, renormalise,
//   haar and (de)interleave_hadamard, the noise and anti-collapse fills
//   (the LCG jumped ahead per lane), the collapse mask, the cache-row
//   search (ballot counts) and the output write.  Sums reduce with
//   __shfl_xor_sync in a fixed butterfly, so every lane gets the same
//   bits.  exp_rotation's recurrences are serial along each chain: its
//   chains run on separate lanes, each carrying its running value in a
//   register.  The energy path (coarse, fine, finalise) stays a serial
//   f32 sum in the plain version's order.
// - X is written [B, nx] row-major, each warp its own row, from shared
//   memory.
//
// Neither tensor cores (wgmma) nor TMA have a role: the pass has no matrix
// product, and a stream reads 160 bytes and 2 x 21 floats, which plain
// coalesced loads move as fast as a TMA descriptor would.
//
// The host rehearsal (tests/test_torch_k1_host.py) compiles this file as
// C++ with K1_LANES 1 (and with K1_LANES > 1 on host threads), so the
// lane width is a macro and nothing else in the source assumes 32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (no fast math), so fp32 results track the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K1_LANES
#define K1_LANES 32        // lanes per stream: one warp on the card
#endif
#ifndef K1_WARPS
#define K1_WARPS 16        // streams (warps) per block
#endif

// dynamic shared memory: the staged tables, then one WarpMem per warp
extern __shared__ __align__(16) unsigned char k1_smem[];

namespace {

constexpr int LANES = K1_LANES;
constexpr int WARPS = K1_WARPS;
constexpr unsigned FULL = 0xffffffffu;
static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
              "K1_LANES: a power of two up to 32");

constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int QTHETA_OFFSET = 4;
constexpr int QTHETA_OFFSET_TWOPHASE = 16;
constexpr int ALLOC_STEPS = 6;
constexpr int LAPLACE_CAP = 40;
constexpr int NB_MAX = 21;
constexpr int NX_MAX = 800;     // M * eBands[nb] at 20 ms
constexpr int NMAX = 176;       // widest band at 20 ms
constexpr int MAX_K = 128;
constexpr int QP_DEPTH = 6;     // band split tree: LM + 2 levels
constexpr int TAB_WORDS = 384;  // eBands .. e_prob, staged per block
constexpr uint32_t CODE_BOT = 1u << 23;
constexpr uint32_t CODE_TOP = 1u << 31;

__constant__ int TELL_CORRECTION[8] = {35733, 38967, 42495, 46340,
                                       50535, 55109, 60097, 65535};
__constant__ int SMALL_ENERGY_ICDF[3] = {2, 1, 0};
__constant__ int TRIM_ICDF[11] = {126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0};
__constant__ int SPREAD_ICDF[4] = {25, 23, 2, 0};
__constant__ int TAPSET_ICDF[3] = {2, 1, 0};
__constant__ int LOG2_FRAC_TABLE[24] = {0, 8, 13, 16, 19, 21, 23, 24, 26,
                                        27, 28, 29, 30, 31, 32, 32, 33, 34,
                                        34, 35, 36, 36, 37, 37};
__constant__ int TF_SELECT_TABLE[4][8] = {{0, -1, 0, -1, 0, -1, 0, -1},
                                          {0, -1, 0, -2, 1, 0, 1, -1},
                                          {0, -2, 0, -3, 2, 0, 1, -1},
                                          {0, -2, 0, -3, 3, 0, 1, -1}};
__constant__ int EXP2_TABLE8[8] = {16384, 17866, 19483, 21247,
                                   23170, 25267, 27554, 30048};
__constant__ int BIT_INTERLEAVE_TABLE[16] = {0, 1, 1, 1, 2, 3, 3, 3,
                                             2, 3, 3, 3, 2, 3, 3, 3};
__constant__ int BIT_DEINTERLEAVE_TABLE[16] = {
    0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
    0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF};
__constant__ int ORDERY2[2] = {1, 0};
__constant__ int ORDERY4[4] = {3, 0, 2, 1};
__constant__ int ORDERY8[8] = {7, 0, 4, 3, 6, 1, 5, 2};
__constant__ float PRED_COEF[4] = {29440 / 32768.f, 26112 / 32768.f,
                                   21248 / 32768.f, 16384 / 32768.f};
__constant__ float BETA_COEF[4] = {30147 / 32768.f, 22282 / 32768.f,
                                   12124 / 32768.f, 6554 / 32768.f};

// -------------------------------------------------------------- profiling
// Built with -DK1_PROFILE (opus_tpu_torch/tools/k1_profile.py), lane 0 of
// each warp adds the SM clock cycles of each phase into k1_prof; the
// card's build and the host rehearsal compile none of it.
#ifdef K1_PROFILE
constexpr int K1_NPROF = 16;
__device__ unsigned long long k1_prof[K1_NPROF];
#define PROF_T(v) const long long v = clock64()
#define PROF_ADD(slot, t0)                                                   \
    do {                                                                     \
        if (threadIdx.x % K1_LANES == 0)                                     \
            atomicAdd(&k1_prof[slot], (unsigned long long)(clock64() - t0)); \
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

__device__ __forceinline__ int warp_or(int v) {
    for (int o = LANES / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(FULL, v, o);
    return v;
}

// per-band values in registers: band i in lane i % LANES, slot i / LANES
constexpr int BSLOTS = (NB_MAX + LANES - 1) / LANES;

template <typename V>
struct Band {
    V v[BSLOTS];
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

// the LCG (bands.c celt_lcg_rand) jumped ahead: this lane's lane + 1 steps
// and K1_LANES steps, as s -> a * s + c
struct Jump {
    uint32_t a1, c1, aL, cL;
};

__device__ __forceinline__ uint32_t lcg(uint32_t s) {
    return 1664525u * s + 1013904223u;
}

__device__ Jump lcg_jump(int lane) {
    Jump J;
    uint32_t a = 1, c = 0;
    J.a1 = 1;
    J.c1 = 0;
    for (int t = 0; t < LANES; t++) {
        a = 1664525u * a;
        c = lcg(c);
        if (t == lane) {
            J.a1 = a;
            J.c1 = c;
        }
    }
    J.aL = a;
    J.cL = c;
    return J;
}

// n serial LCG steps from seed, step t (0-based) on lane t % LANES:
// f(t, state after step t); returns the state after n steps on every lane
template <typename F>
__device__ __forceinline__ uint32_t lcg_fill(uint32_t seed, int n,
                                             const Jump &J, F f) {
    if (n <= 0) return seed;
    uint32_t s = J.a1 * seed + J.c1, last = s;
    for (int t = lane_id(); t < n; t += LANES) {
        f(t, s);
        last = s;
        s = J.aL * s + J.cL;
    }
    return __shfl_sync(FULL, last, (n - 1) % LANES);
}

// Sums over the coded bands of one allocation trial (rate.c): band j's
// bits v_j count in full (up to its cap) once some band j' >= j reached
// its threshold, else the floor when v_j >= alloc_floor, else nothing.
// Bands sit in lanes: a ballot gives the "some j' >= j" flags, a butterfly
// the sum.  Integer, so the order of the sum does not matter.
template <typename F>
__device__ __forceinline__ int alloc_sum(int start, int end,
                                         const int32_t *caps, F bits_of,
                                         int floor = 1 << BITRES) {
    const int lane = lane_id();
    int psum = 0, done_hi = 0;
    for (int s = BSLOTS - 1; s >= 0; s--) {
        int j = s * LANES + lane;
        int in = j >= start && j < end;
        int thr = 0;
        int v = in ? bits_of(s, j, thr) : 0;
        unsigned m = __ballot_sync(FULL, in && v >= thr);
        int done = done_hi || (m >> lane) != 0;
        if (in) psum += done ? (v < caps[j] ? v : caps[j])
                             : (v >= floor ? floor : 0);
        done_hi |= m != 0;
    }
    return warp_sum(psum);
}

// ---------------------------------------------------------------- tables
// a block's shared memory (each warp's WarpMem follows it): the staged
// tables, and per band sqrt(N) and 1/sqrt(N), and the band of each of the
// nx positions
struct __align__(16) BlockMem {
    int32_t tab[TAB_WORDS];
    float nrm[NB_MAX + 1], isq[NB_MAX + 1];
    uint8_t band_of[NX_MAX];
};

struct Tabs {
    int nb, lm, nv, urows, ucols, start, end;
    const int32_t *eBands, *logN, *caps, *allocV, *eprob;  // shared memory
    const int32_t *rowoff, *rows, *caps2;                  // device memory
    const uint32_t *u;
};

// the header, and eBands .. e_prob (one span of the table) copied into
// stage by the whole block; the caller synchronises the block
__device__ Tabs load_tabs(const int32_t *t, int32_t *stage) {
    Tabs T;
    T.nb = t[0];
    T.lm = t[1];
    T.nv = t[2];
    T.urows = t[3];
    T.ucols = t[4];
    T.start = t[5];
    T.end = t[6];
    const int lo = t[7], hi = t[12];
    if (hi - lo > TAB_WORDS) __trap();
    for (int k = threadIdx.x; k < hi - lo; k += blockDim.x) stage[k] = t[lo + k];
    T.eBands = stage;
    T.logN = stage + (t[8] - lo);
    T.caps = stage + (t[9] - lo);
    T.allocV = stage + (t[10] - lo);
    T.eprob = stage + (t[11] - lo);
    T.rowoff = t + t[12];
    T.rows = t + t[13];
    T.u = reinterpret_cast<const uint32_t *>(t + t[14]);
    T.caps2 = t + t[15];
    return T;
}

// BlockMem's per-band values, from the staged eBands (after a block sync)
__device__ void band_tables(const Tabs &T, BlockMem &bm, int nx) {
    const int M = 1 << T.lm;
    for (int j = threadIdx.x; j < T.nb; j += blockDim.x) {
        int n = M * (T.eBands[j + 1] - T.eBands[j]);
        bm.nrm[j] = (float)sqrt((double)n);
        bm.isq[j] = (float)(1.0 / sqrt((double)n));
    }
    for (int p = threadIdx.x; p < nx; p += blockDim.x) {
        int lo = 0, hi = T.nb - 1;      // the last band starting at <= p
        while (lo < hi) {
            int mid = (lo + hi + 1) >> 1;
            if (M * T.eBands[mid] <= p) lo = mid;
            else hi = mid - 1;
        }
        bm.band_of[p] = (uint8_t)lo;
    }
}

__device__ __forceinline__ const int32_t *cache_row(const Tabs &T, int lmn,
                                                    int band) {
    return T.rows + __ldg(T.rowoff + (lmn + 1) * T.nb + band);
}

// U(k, n), saturated at 2^32-1; stored column by column, so consecutive
// k are consecutive words
__device__ __forceinline__ uint32_t U(const Tabs &T, int k, int n) {
    return __ldg(T.u + n * T.urows + k);
}

__device__ __forceinline__ int ilog(uint32_t v) {
    return v ? 32 - __clz(v) : 0;
}

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0
    int q = a / b;
    return (q * b > a) ? q - 1 : q;
}

// ----------------------------------------------------------- range decoder
struct RD {
    const uint8_t *buf;     // the packet's bytes in shared memory
    int storage;
    int offs, end_offs, nend_bits, nbits_total, rem, error;
    uint32_t end_window, rng, val, ext;
};

__device__ __forceinline__ int read_byte(RD &d) {
    if (d.offs < d.storage) return d.buf[d.offs++];
    return 0;
}

__device__ __forceinline__ int read_byte_from_end(RD &d) {
    if (d.end_offs < d.storage) {
        int b = d.buf[d.storage - d.end_offs - 1];
        d.end_offs++;
        return b;
    }
    return 0;
}

__device__ void rd_normalize(RD &d) {
    for (int t = 0; t < 3 && d.rng <= CODE_BOT; t++) {
        int byte = read_byte(d);
        int sym = ((d.rem << 8) | byte) >> 1;
        d.nbits_total += 8;
        d.rng <<= 8;
        d.val = ((d.val << 8) + (255u & ~(uint32_t)sym)) & (CODE_TOP - 1);
        d.rem = byte;
    }
}

__device__ void rd_init(RD &d, const uint8_t *buf, int storage) {
    d.buf = buf;
    d.storage = storage;
    d.offs = d.end_offs = d.nend_bits = 0;
    d.end_window = 0;
    d.nbits_total = 32 + 1 - ((32 - 7) / 8) * 8;
    d.rng = 1u << 7;
    d.ext = 0;
    d.error = 0;
    int byte = read_byte(d);
    d.rem = byte;
    d.val = d.rng - 1 - (uint32_t)(byte >> 1);
    rd_normalize(d);
}

// a live decoder state: one row of rc_kernel.pack_state's [B, 10] columns
// (offs, end_offs, end_window, nend_bits, nbits_total, rng, val, ext, rem,
// error), read on a buffer whose storage is this frame's length
__device__ void rd_load(RD &d, const uint8_t *buf, int storage,
                        const int32_t *r) {
    d.buf = buf;
    d.storage = storage;
    d.offs = r[0];
    d.end_offs = r[1];
    d.end_window = (uint32_t)r[2];
    d.nend_bits = r[3];
    d.nbits_total = r[4];
    d.rng = (uint32_t)r[5];
    d.val = (uint32_t)r[6];
    d.ext = (uint32_t)r[7];
    d.rem = r[8];
    d.error = r[9];
}

__device__ __forceinline__ int rd_tell(const RD &d) {
    return d.nbits_total - ilog(d.rng);
}

__device__ int rd_tell_frac(const RD &d) {
    int l = ilog(d.rng);
    uint32_t r = d.rng >> (l > 16 ? l - 16 : 0);
    int b = (int)(r >> 12) - 8;
    int bc = b < 0 ? 0 : (b > 7 ? 7 : b);
    b += r > (uint32_t)TELL_CORRECTION[bc];
    return (d.nbits_total << BITRES) - ((l << 3) + b);
}

__device__ uint32_t rd_decode(RD &d, uint32_t ft) {
    if (ft < 1) ft = 1;
    d.ext = d.rng / ft;
    uint64_t s1 = (uint64_t)(d.val / d.ext) + 1;
    return ft - (uint32_t)(s1 < ft ? s1 : ft);
}

__device__ void rd_update(RD &d, uint32_t fl, uint32_t fh, uint32_t ft) {
    uint32_t s = d.ext * (ft - fh);
    d.val -= s;
    d.rng = fl > 0 ? d.ext * (fh - fl) : d.rng - s;
    rd_normalize(d);
}

__device__ int rd_bit_logp(RD &d, int logp) {
    uint32_t r = d.rng;
    uint32_t s = r >> logp;
    int ret = d.val < s;
    if (!ret) d.val -= s;
    d.rng = ret ? s : r - s;
    rd_normalize(d);
    return ret;
}

__device__ int rd_icdf(RD &d, const int *icdf, int len, int ftb) {
    uint32_t r = d.rng >> ftb;
    int ret = 0;
    for (int t = 0; t < len; t++) ret += d.val < r * (uint32_t)icdf[t];
    uint32_t s = ret < len ? r * (uint32_t)icdf[ret] : 0;
    uint32_t t = ret > 0 ? r * (uint32_t)icdf[ret - 1] : d.rng;
    d.val -= s;
    d.rng = t - s;
    rd_normalize(d);
    return ret;
}

__device__ uint32_t rd_bits(RD &d, int bits) {
    if (d.nend_bits < bits) {
        for (int t = 0; t < 4; t++) {
            if (d.nend_bits <= 32 - 8) {
                uint32_t byte = (uint32_t)read_byte_from_end(d);
                d.end_window |= byte << d.nend_bits;
                d.nend_bits += 8;
            }
        }
    }
    uint32_t mask = bits <= 0 ? 0u : (bits >= 32 ? 0xFFFFFFFFu
                                                  : (1u << bits) - 1);
    uint32_t ret = d.end_window & mask;
    d.end_window = bits >= 32 ? 0u : d.end_window >> (bits > 0 ? bits : 0);
    d.nend_bits -= bits;
    d.nbits_total += bits;
    return ret;
}

__device__ uint32_t rd_uint(RD &d, uint32_t ft) {
    uint32_t ftm = (ft < 2 ? 2 : ft) - 1;
    int ftb = ilog(ftm);
    int big = ftb > 8;
    int sh = big ? ftb - 8 : 0;
    uint32_t ftrunc = (ftm >> sh) + 1;
    uint32_t fs = rd_decode(d, ftrunc);
    rd_update(d, fs, fs + 1, ftrunc);
    if (!big) return fs;
    uint32_t lo = rd_bits(d, sh);
    uint32_t t = (fs << sh) | lo;
    if (t > ftm) {
        d.error = 1;
        t = ftm;
    }
    return t;
}

// ------------------------------------------------------------ plan pieces
__device__ int laplace_decode(RD &d, int fs0, int decay) {
    int fm = (int)rd_decode(d, 32768);
    int val = 0, fl = 0, fs = fs0;
    int ge = fm >= fs0;
    if (ge) {
        val = 1;
        fl = fs0;
        fs = (((32768 - 32 - fs0) * (16384 - decay)) >> 15) + 1;
        for (int t = 0; t < LAPLACE_CAP; t++) {
            if (!(fs > 1 && fm >= fl + 2 * fs)) break;
            int fs2 = fs * 2;
            fs = (((fs2 - 2) * decay) >> 15) + 1;
            fl += fs2;
            val++;
        }
        if (fs > 1 && fm >= fl + 2 * fs) d.error = 1;   // cap overflow
        if (fs <= 1) {
            int di = (fm - fl) >> 1;
            val += di;
            fl += 2 * di;
        }
        if (fm < fl + fs) val = -val;
        else fl += fs;
    }
    int fh = fl + fs < 32768 ? fl + fs : 32768;
    rd_update(d, (uint32_t)fl, (uint32_t)fh, 32768u);
    return val;
}

// compute_qn (bands.c) for N2 = n2x: 2N - 1 for a split of N (mono), and
// for a stereo band of N, 2N - 1 or 2 at N = 2
__device__ int compute_qn_n2(int n2x, int b, int offset, int pulse_cap) {
    int qb = (b + n2x * offset) / n2x;   // C truncating division
    if (qb > b - pulse_cap - (4 << BITRES)) qb = b - pulse_cap - (4 << BITRES);
    if (qb > 8 << BITRES) qb = 8 << BITRES;
    if (qb < (1 << BITRES >> 1)) return 1;
    int sh = 14 - (qb >> BITRES);
    sh = sh < 0 ? 0 : (sh > 31 ? 31 : sh);
    return ((EXP2_TABLE8[qb & 7] >> sh) + 1) >> 1 << 1;
}

__device__ __forceinline__ int compute_qn(int n2, int b, int offset,
                                          int pulse_cap) {
    return compute_qn_n2(2 * n2 - 1, b, offset, pulse_cap);
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

__device__ int isqrt24(int x) {
    int s = (int)sqrtf((float)x);
    s -= s * s > x;
    s += (s + 1) * (s + 1) <= x;
    return s;
}

// ------------------------------------------------- vector passes (a warp)
// Each ends with __syncwarp(), so the next pass may read any element.

// stride is a power of two (a block count)
__device__ void haar1(float *x, int n0, int stride) {
    const float s = 0.70710678118654752440f;
    const int ls = __ffs(stride) - 1;
    for (int p = lane_id(); p < (stride * (n0 >> 1)); p += LANES) {
        int i = p & (stride - 1), j = p >> ls;
        int i0 = stride * 2 * j + i;
        float t1 = s * x[i0];
        float t2 = s * x[i0 + stride];
        x[i0] = t1 + t2;
        x[i0 + stride] = t1 - t2;
    }
    __syncwarp();
}

__device__ const int *ordery(int stride) {
    return stride == 2 ? ORDERY2 : (stride == 4 ? ORDERY4 : ORDERY8);
}

__device__ void deinterleave_hadamard(float *x, float *tmp, int n0,
                                      int stride, int hadamard) {
    const int *ord = ordery(stride);
    const int ls = __ffs(stride) - 1;
    for (int q = lane_id(); q < n0 * stride; q += LANES) {
        int i = q & (stride - 1), j = q >> ls;
        tmp[(hadamard ? ord[i] : i) * n0 + j] = x[q];
    }
    __syncwarp();
    for (int q = lane_id(); q < n0 * stride; q += LANES) x[q] = tmp[q];
    __syncwarp();
}

__device__ void interleave_hadamard(float *x, float *tmp, int n0, int stride,
                                    int hadamard) {
    const int *ord = ordery(stride);
    const int ls = __ffs(stride) - 1;
    for (int q = lane_id(); q < n0 * stride; q += LANES) {
        int i = q & (stride - 1), j = q >> ls;
        tmp[q] = x[(hadamard ? ord[i] : i) * n0 + j];
    }
    __syncwarp();
    for (int q = lane_id(); q < n0 * stride; q += LANES) x[q] = tmp[q];
    __syncwarp();
}

// exp_rotation1 (vq.c) restricted to the chain of positions r, r + stride,
// ...: its forward and backward recurrences touch no other chain.  The
// value each step hands to the next stays in a register, so a step waits
// on two float operations and not on a shared-memory round trip.
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

__device__ void exp_rotation_dec(float *x, int n, int stride, int k,
                                 int spread) {
    if (spread == 0 || 2 * k >= n || n < stride) return;
    float factor = spread == 1 ? 15.f : (spread == 2 ? 10.f : 5.f);
    float gain = (float)n / ((float)n + factor * (float)k);
    float theta = 0.5f * gain * gain;
    const float hp = (float)(0.5 * 3.14159265358979323846);
    float c = cosf(hp * theta);
    float s = cosf(hp * (1.0f - theta));
    int stride2 = 0;
    if (n >= 8 * stride) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < n)
            stride2++;
    }
    int len = n / stride;
    // per block: the stride2 pass (its chains on separate lanes), then
    // the stride-1 pass (one chain per block)
    if (stride2) {
        for (int p = lane_id(); p < stride * stride2; p += LANES)
            rotation_chain(x + (p / stride2) * len, len, stride2,
                           p % stride2, s, c);
        __syncwarp();
    }
    for (int blk = lane_id(); blk < stride; blk += LANES)
        rotation_chain(x + blk * len, len, 1, 0, c, s);
    __syncwarp();
}

__device__ void renormalise(float *x, int n, float gain) {
    float e = 0.f;
    for (int i = lane_id(); i < n; i += LANES) e += x[i] * x[i];
    e = warp_sum(e);
    e += 1e-15f;
    float g = gain * rsqrtf(e);
    for (int i = lane_id(); i < n; i += LANES) x[i] *= g;
    __syncwarp();
}

// ---------------------------------------------------------------- band tree
// The range decoder never reads a leaf's pulse vector: a band's split tree
// is decoded first (theta, the leaves' pulse counts and codebook indices),
// its leaves recorded, and then built: every leaf's cwrsi at once, one
// lane each, then the float work leaf by leaf in the tree's order (the
// noise fills draw the LCG in that order).

// 20 words, 16-byte aligned: a frame moves as five 16-byte accesses
struct __align__(16) QPFrame {
    int n, lm, b, bb, fill, xo, phase, cs;
    float gain;
    int bb2, fill_s, itheta, mbits, sbits, swap, rb_before, bv0;
    float mid, side;
    int pad;
};

// a leaf: x offset and size, blocks, pulse count (0: folded or noise),
// cache cap, fill mask, the shift of its collapse bits in the band's mask
// and its codebook index
struct __align__(16) Leaf {
    int xo, n, bb, kq, kcap, fill, cs;
    uint32_t idx;
    float gain;
    int pad[3];
};

constexpr int MAX_LEAVES = 1 << (QP_DEPTH - 2);   // LM 3: 4 splits

// a warp's shared memory (the packet's bytes follow it)
struct __align__(16) WarpMem {
    float X[NX_MAX];
    float lb[NMAX];
    float tmp[NMAX];        // (de)interleave_hadamard scratch
    QPFrame st[QP_DEPTH];
    Leaf leaves[MAX_LEAVES];
};

// what a two-channel frame adds to a warp's WarpMem: the second channel's
// spectrum, the fold memories (norm: sqrt(N) times the first channel's
// or the mid's shape as quant_band left it, before the stereo merge;
// norm2: the second channel's, kept while dual stereo lasts) and the
// second channel's folding source
struct __align__(16) StereoMem {
    float Y[NX_MAX];
    float norm[NX_MAX];
    float norm2[NX_MAX];
    float lb2[NMAX];
};

template <int C>
__host__ __device__ constexpr int warps_of() {
    return C == 1 || WARPS == 1 ? WARPS : WARPS / 2;
}

template <int C>
__host__ __device__ constexpr size_t warp_bytes() {
    return sizeof(WarpMem) + (C == 2 ? sizeof(StereoMem) : 0);
}

struct Ctx {
    RD d;
    int rb;
    uint32_t seed;
    int spread;
    Jump J;
    WarpMem *w;
};

// cwrsi (cwrs.c:467): codebook index -> pulse vector, stored as floats in
// y.  whole_warp: every lane runs it on the same leaf (lane 0 stores) and
// each downward k search tests LANES candidates at once; else each lane
// decodes its own leaf with a serial search.
__device__ void cwrsi(const Tabs &T, int n, int k, uint32_t i, int kcap,
                      float *y, bool whole_warp) {
    const int lane = lane_id();
    const bool store = !whole_warp || lane == 0;
    int idx = 0;
    for (; n > 2; n--) {
        int is_a = k >= n;
        uint32_t col_k = U(T, k, n), col_k1 = U(T, k + 1, n);
        int s = i >= col_k1;
        int izero = !is_a && col_k <= i && i < col_k1;
        if (izero) {
            i -= col_k;
            if (store) y[idx] = 0.f;
            idx++;
            continue;
        }
        if (s) i -= col_k1;
        int upper;
        if (is_a) {
            uint32_t q = n <= kcap + 1 ? U(T, n, n) : 0xFFFFFFFFu;
            upper = q > i ? n - 1 : k;
        } else {
            upper = k - 1;
        }
        if (upper < 0) upper = 0;
        // kn = the largest k' <= upper with k' == 0 or U(k', n) <= i
        int kn = upper;
        uint32_t ukn;
        if (whole_warp) {
            for (;;) {
                int cand = kn - lane;
                uint32_t uc = cand >= 0 ? U(T, cand, n) : 0u;
                int past = cand > 0 && uc > i;
                unsigned stop = __ballot_sync(FULL, !past);
                if (stop) {
                    int first = __ffs((int)stop) - 1;
                    ukn = __shfl_sync(FULL, uc, first);
                    kn -= first;
                    break;
                }
                kn -= LANES;
            }
        } else {
            ukn = U(T, kn, n);
            while (kn > 0 && ukn > i) ukn = U(T, --kn, n);
        }
        i -= ukn;
        int val = k - kn;
        if (store) y[idx] = (float)(s ? -val : val);
        idx++;
        k = kn;
    }
    uint32_t p = 2u * (uint32_t)k + 1;
    int s = i >= p;
    if (s) i -= p;
    int k2 = (int)((i + 1) >> 1);
    if (k2 > 0) i -= 2u * (uint32_t)k2 - 1;
    int val = k - k2;
    if (store) {
        y[idx] = (float)(s ? -val : val);
        y[idx + 1] = (float)(i ? -k2 : k2);
    }
}

// a leaf's decoding (bands.c quant_partition's leaf, mono decode): its
// pulse count from the cache row nearest b - 1 bits that fits in c.rb,
// and the codebook index
__device__ Leaf decode_leaf(const Tabs &T, Ctx &c, const QPFrame &f,
                            const int32_t *row) {
    // the row's L entries counted across the lanes
    int L = __ldg(row);
    int bm1 = f.b - 1;
    int lo = 0;
    int c_fit = 0;
    for (int j0 = 1; j0 <= L; j0 += LANES) {
        int j = j0 + lane_id();
        int rj = j <= L ? __ldg(row + j) : 0;
        lo += __popc(__ballot_sync(FULL, j <= L && bm1 > rj));
        c_fit += __popc(__ballot_sync(FULL, j <= L && c.rb >= rj + 1));
    }
    int hi = lo + 1 < L ? lo + 1 : L;
    int lo_val = lo == 0 ? -1 : __ldg(row + lo);
    int hi_val = __ldg(row + hi), fit_val = __ldg(row + c_fit);
    int q = (bm1 - lo_val <= hi_val - bm1) ? lo : hi;
    int q_val = q == lo ? lo_val : hi_val;
    if (q > c_fit) {
        q = c_fit;
        q_val = fit_val;
    }
    c.rb -= q > 0 ? q_val + 1 : 0;
    Leaf lf;
    lf.xo = f.xo;
    lf.n = f.n;
    lf.bb = f.bb;
    lf.kq = q < 8 ? q : (8 + (q & 7)) << ((q >> 3) - 1);
    lf.kcap = 0;
    lf.fill = f.fill;
    lf.cs = f.cs;
    lf.idx = 0;
    lf.gain = f.gain;
    if (lf.kq != 0) {
        int kcap = L < 8 ? L : (8 + (L & 7)) << ((L >> 3) - 1);
        if (kcap > MAX_K) kcap = MAX_K;
        int kc = lf.kq < kcap ? lf.kq : kcap;
        uint64_t v = (uint64_t)U(T, kc, f.n) + U(T, kc + 1, f.n);
        uint32_t ft = v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
        lf.idx = rd_uint(c.d, ft);
        lf.kcap = kcap;
    }
    return lf;
}

// quant_partition decode (bands.c:973) with an explicit stack in shared
// memory (every lane reads the top frame, lane 0 writes): decodes the
// band's split tree and records its leaves in c.w->leaves; returns their
// number.  A node's second child replaces it on the stack.
__device__ int quant_partition(const Tabs &T, Ctx &c, int band, int n,
                               int lm, int b, int bb, int fill, float gain) {
    QPFrame *st = c.w->st;
    Leaf *leaves = c.w->leaves;
    const int lane = lane_id();
    int top = 0, nl = 0;
    __syncwarp();
    if (lane == 0) {
        st[0].n = n;
        st[0].lm = lm;
        st[0].b = b;
        st[0].bb = bb;
        st[0].fill = fill;
        st[0].gain = gain;
        st[0].xo = 0;
        st[0].cs = 0;
        st[0].phase = 0;
    }
    __syncwarp();
    while (top >= 0) {
        QPFrame f = st[top];
        QPFrame ch;
        if (f.phase == 0) {
            const int32_t *row = cache_row(T, f.lm, band);
            int split = f.lm != -1 && f.n > 2
                && f.b > __ldg(row + __ldg(row)) + 12;
            if (!split) {
                PROF_T(t_leaf);
                Leaf lf = decode_leaf(T, c, f, row);
                if (lane == 0) leaves[nl] = lf;
                nl++;
                PROF_ADD(10, t_leaf);
                top--;
                continue;
            }
            PROF_T(t_th);
            int n2 = f.n >> 1, lm2 = f.lm - 1;
            f.fill_s = f.bb == 1 ? (f.fill & 1) | (f.fill << 1) : f.fill;
            f.bb2 = (f.bb + 1) >> 1;
            // ---- compute_theta, mono decode (bands.c:700)
            int pulse_cap = T.logN[band] + lm2 * (1 << BITRES);
            int offset = (pulse_cap >> 1) - QTHETA_OFFSET;
            int qn = compute_qn(n2, f.b, offset, pulse_cap);
            int tell0 = rd_tell_frac(c.d);
            int itheta = 0;
            if (qn != 1) {
                int th;
                if (f.bb > 1) {
                    th = (int)rd_uint(c.d, (uint32_t)(qn + 1));
                } else {
                    int qh = qn >> 1;
                    int ft = (qh + 1) * (qh + 1);
                    int fm = (int)rd_decode(c.d, (uint32_t)ft);
                    int fs, fl;
                    if (fm < ((qh * (qh + 1)) >> 1)) {
                        th = (isqrt24(8 * fm + 1) - 1) >> 1;
                        fs = th + 1;
                        fl = (th * (th + 1)) >> 1;
                    } else {
                        int a = ft - fm - 1;
                        th = (2 * (qn + 1) - isqrt24(8 * (a > 0 ? a : 0) + 1))
                            >> 1;
                        fs = qn + 1 - th;
                        fl = ft - (((qn + 1 - th) * (qn + 2 - th)) >> 1);
                    }
                    rd_update(c.d, (uint32_t)fl, (uint32_t)(fl + fs),
                              (uint32_t)ft);
                }
                itheta = th * 16384 / qn;
            }
            int qalloc = rd_tell_frac(c.d) - tell0;
            int bs = f.b - qalloc;
            c.rb -= qalloc;
            int imid, iside, delta;
            if (itheta == 0) {
                imid = 32767;
                iside = 0;
                delta = -16384;
                f.fill_s &= (1 << f.bb2) - 1;
            } else if (itheta == 16384) {
                imid = 0;
                iside = 32767;
                delta = 16384;
                f.fill_s &= ((1 << f.bb2) - 1) << f.bb2;
            } else {
                imid = bitexact_cos(itheta);
                iside = bitexact_cos(16384 - itheta);
                delta = frac_mul16((n2 - 1) << 7,
                                   bitexact_log2tan(iside, imid));
            }
            f.itheta = itheta;
            f.mid = (float)imid * (1.0f / 32768.0f);
            f.side = (float)iside * (1.0f / 32768.0f);
            if (f.bb > 1 && (itheta & 0x3fff)) {
                if (itheta > 8192) {
                    delta -= delta >> (4 - lm2);
                } else {
                    int d2 = delta + (n2 << BITRES >> (5 - lm2));
                    delta = d2 < 0 ? d2 : 0;
                }
            }
            int mb = (bs - delta) >> 1;          // floor division by 2
            if (mb > bs) mb = bs;
            if (mb < 0) mb = 0;
            f.mbits = mb;
            f.sbits = bs - mb;
            f.swap = f.mbits < f.sbits;
            f.rb_before = c.rb;
            f.bv0 = f.swap ? f.sbits : f.mbits;
            f.phase = 1;
            PROF_ADD(11, t_th);
            // the first child: the side half if it has more bits
            ch.n = n2;
            ch.lm = lm2;
            ch.b = f.bv0;
            ch.bb = f.bb2;
            ch.fill = f.swap ? f.fill_s >> f.bb2 : f.fill_s;
            ch.gain = f.gain * (f.swap ? f.side : f.mid);
            ch.xo = f.xo + (f.swap ? n2 : 0);
            ch.cs = f.cs + (f.swap ? f.bb >> 1 : 0);
            ch.phase = 0;
            // push: every lane has read st[top] before lane 0 writes it
            __syncwarp();
            if (lane == 0) {
                st[top] = f;
                st[top + 1] = ch;
            }
            __syncwarp();
            top++;
        } else {
            // the second child, with the bits the first left over
            int n2 = f.n >> 1;
            int rebalance = f.bv0 - (f.rb_before - c.rb);
            int anchor = f.swap ? 16384 : 0;
            int extra = (rebalance > (3 << BITRES) && f.itheta != anchor)
                ? rebalance - (3 << BITRES) : 0;
            ch.n = n2;
            ch.lm = f.lm - 1;
            ch.b = (f.swap ? f.mbits : f.sbits) + extra;
            ch.bb = f.bb2;
            ch.fill = f.swap ? f.fill_s : f.fill_s >> f.bb2;
            ch.gain = f.gain * (f.swap ? f.mid : f.side);
            ch.xo = f.xo + (f.swap ? 0 : n2);
            ch.cs = f.cs + (f.swap ? 0 : f.bb >> 1);
            ch.phase = 0;
            __syncwarp();
            if (lane == 0) st[top] = ch;
            __syncwarp();
        }
    }
    __syncwarp();       // the leaves lane 0 recorded
    return nl;
}

// builds the nl recorded leaves of a band into x; returns the band's
// collapse mask (each leaf's mask shifted to its blocks)
__device__ int build_leaves(const Tabs &T, Ctx &c, float *x, const float *lb,
                            int lb_has, int nl) {
    const Leaf *leaves = c.w->leaves;
    if (nl == 1) {
        const Leaf &lf = leaves[0];
        if (lf.kq != 0)
            cwrsi(T, lf.n, lf.kq > 1 ? lf.kq : 1, lf.idx, lf.kcap, x, true);
    } else {
        for (int l = lane_id(); l < nl; l += LANES) {
            Leaf lf = leaves[l];
            if (lf.kq != 0)
                cwrsi(T, lf.n, lf.kq > 1 ? lf.kq : 1, lf.idx, lf.kcap,
                      x + lf.xo, false);
        }
    }
    __syncwarp();
    int cm = 0;
    for (int l = 0; l < nl; l++) {
        const Leaf lf = leaves[l];
        float *xl = x + lf.xo;
        const int n = lf.n, bb = lf.bb;
        int cml;
        if (lf.kq != 0) {
            // xl holds the pulses: their squares sum exactly in any order
            // (integers below 2^24); the collapse bits mark blocks with one
            const int n0 = n / bb;
            float ryy = 0.f;
            int nz = 0;
            for (int j = lane_id(); j < n; j += LANES) {
                ryy += xl[j] * xl[j];
                if (xl[j] != 0.f) nz |= 1 << (j / n0);
            }
            ryy = warp_sum(ryy);
            float g = lf.gain * rsqrtf(ryy > 1e-30f ? ryy : 1e-30f);
            for (int j = lane_id(); j < n; j += LANES) xl[j] = xl[j] * g;
            __syncwarp();
            PROF_T(t_rot);
            exp_rotation_dec(xl, n, bb, lf.kq, c.spread);
            PROF_ADD(9, t_rot);
            cml = bb <= 1 ? 1 : warp_or(nz);
        } else {
            int cm_mask = (1 << bb) - 1;
            int fillm = lf.fill & cm_mask;
            if (fillm == 0) {
                for (int j = lane_id(); j < n; j += LANES) xl[j] = 0.f;
                __syncwarp();
                cml = 0;
            } else {
                const float *ll = lb + lf.xo;
                c.seed = lcg_fill(c.seed, n, c.J, [&](int j, uint32_t s) {
                    xl[j] = lb_has
                        ? ll[j] + ((s & 0x8000) ? 1.0f / 256 : -1.0f / 256)
                        : (float)((int32_t)s >> 20);
                });
                __syncwarp();
                renormalise(xl, n, lf.gain);
                cml = lb_has ? fillm : cm_mask;
            }
        }
        cm |= cml << lf.cs;
    }
    return cm;
}

// quant_band, mono decode (bands.c:1245): tf/hadamard wrappers around
// quant_partition.  lb: the band's folding source (n floats, modified when
// lb_has); gain: 1, or a stereo band's side gain.
__device__ int quant_band(const Tabs &T, Ctx &c, int band, float *x,
                          float *lb, int lb_has, int n, int b, int tr,
                          int tf_change, int fill, float gain = 1.0f) {
    float *tmp = c.w->tmp;
    if (n == 1) {
        int sign = 0;
        if (c.rb >= 1 << BITRES) {
            sign = (int)rd_bits(c.d, 1);
            c.rb -= 1 << BITRES;
        }
        if (lane_id() == 0) x[0] = sign ? -1.0f : 1.0f;
        __syncwarp();
        return 1;
    }
    int lm = T.lm;
    int B0 = tr ? 1 << lm : 1;
    int recombine = tf_change > 0 ? tf_change : 0;
    int bb = B0 >> recombine;
    int n_b = (n / B0) << recombine;
    int tdiv = 0, tfc = tf_change;
    while ((n_b & 1) == 0 && tfc < 0) {
        bb <<= 1;
        n_b >>= 1;
        tdiv++;
        tfc++;
    }
    int b0f = bb, n_b0 = n_b, longb = B0 == 1;
    // input side: lowband + fill
    for (int k = 0; k < recombine; k++) {
        if (lb_has) haar1(lb, n >> k, 1 << k);
        fill = BIT_INTERLEAVE_TABLE[fill & 0xF]
            | BIT_INTERLEAVE_TABLE[(fill >> 4) & 0xF] << 2;
    }
    bb = B0 >> recombine;
    n_b = (n / B0) << recombine;
    for (int t = 0; t < tdiv; t++) {
        if (lb_has) haar1(lb, n_b, bb);
        fill |= fill << bb;
        bb <<= 1;
        n_b >>= 1;
    }
    if (b0f > 1 && lb_has)
        deinterleave_hadamard(lb, tmp, n_b0 >> recombine, b0f << recombine,
                              longb);
    PROF_T(t_qp);
    int nl = quant_partition(T, c, band, n, lm, b, b0f, fill, gain);
    PROF_T(t_build);
    int cm = build_leaves(T, c, x, lb, lb_has, nl);
    PROF_ADD(8, t_build);
    PROF_ADD(12, t_qp);
    // resynth side: x + cm
    bb = b0f;
    n_b = n_b0;
    if (bb > 1)
        interleave_hadamard(x, tmp, n_b >> recombine, bb << recombine,
                            longb);
    for (int t = 0; t < tdiv; t++) {
        bb >>= 1;
        n_b <<= 1;
        cm |= cm >> bb;
        haar1(x, n_b, bb);
    }
    for (int k = 0; k < recombine; k++) {
        cm = BIT_DEINTERLEAVE_TABLE[cm < 0 ? 0 : (cm > 15 ? 15 : cm)];
        haar1(x, n >> k, 1 << k);
    }
    bb <<= recombine;
    return cm & ((1 << bb) - 1);
}

// ------------------------------------------------------- two-channel bands
// stereo_merge (bands.c): the mid and side shapes back to left and right
__device__ void stereo_merge(float *x, float *y, float mid, int n) {
    float xp = 0.f, side = 0.f;
    for (int j = lane_id(); j < n; j += LANES) {
        xp += y[j] * x[j];
        side += y[j] * y[j];
    }
    xp = warp_sum(xp);
    side = warp_sum(side);
    xp = mid * xp;
    const float mm = mid * mid;
    const float el = mm + side - 2 * xp;
    const float er = mm + side + 2 * xp;
    if (er < 6e-4f || el < 6e-4f) {
        for (int j = lane_id(); j < n; j += LANES) y[j] = x[j];
    } else {
        const float lg = 1.0f / sqrtf(el), rg = 1.0f / sqrtf(er);
        for (int j = lane_id(); j < n; j += LANES) {
            float l = mid * x[j], r = y[j];
            x[j] = lg * (l - r);
            y[j] = rg * (l + r);
        }
    }
    __syncwarp();
}

// quant_band_stereo, decode (bands.c:1387) for N > 1: compute_theta's
// stereo branch, then the N = 2 rotation or the mid and side bands in the
// order of their bits, the merge and the inversion.  nrm_out: where the
// band's fold memory goes (sqrt(N) times the mid's shape as quant_band
// left it), or null for the last band.  Returns the collapse mask.
__device__ int band_stereo(const Tabs &T, Ctx &c, int band, float *xs,
                           float *ys, float *lb, int lb_has, int n, int b,
                           int tr, int tf_change, int fill, int intensity,
                           int disable_inv, float *nrm_out, float nrm) {
    const int lane = lane_id();
    const int lm = T.lm;
    const int bb = tr ? 1 << lm : 1;
    const int orig_fill = fill;
    // ---- compute_theta, stereo decode (bands.c:700)
    int pulse_cap = T.logN[band] + lm * (1 << BITRES);
    int offset = (pulse_cap >> 1) - (n == 2 ? QTHETA_OFFSET_TWOPHASE
                                            : QTHETA_OFFSET);
    int qn = compute_qn_n2(2 * n - 1 - (n == 2), b, offset, pulse_cap);
    if (band >= intensity) qn = 1;
    int tell0 = rd_tell_frac(c.d);
    int itheta = 0, inv = 0;
    if (qn != 1) {
        int th;
        if (n > 2) {                     // the step pdf
            int x0 = qn >> 1;
            int ft = 3 * (x0 + 1) + x0;
            int fs = (int)rd_decode(c.d, (uint32_t)ft);
            int xq = fs < (x0 + 1) * 3 ? fs / 3 : x0 + 1 + (fs - (x0 + 1) * 3);
            int fl = xq <= x0 ? 3 * xq : (xq - 1 - x0) + (x0 + 1) * 3;
            int fh = xq <= x0 ? 3 * (xq + 1) : (xq - x0) + (x0 + 1) * 3;
            rd_update(c.d, (uint32_t)fl, (uint32_t)fh, (uint32_t)ft);
            th = xq;
        } else {
            th = (int)rd_uint(c.d, (uint32_t)(qn + 1));
        }
        itheta = th * 16384 / qn;
    } else {
        if (b > 2 << BITRES && c.rb > 2 << BITRES) inv = rd_bit_logp(c.d, 2);
        if (disable_inv) inv = 0;
    }
    int qalloc = rd_tell_frac(c.d) - tell0;
    b -= qalloc;
    int imid, iside, delta;
    if (itheta == 0) {
        imid = 32767;
        iside = 0;
        delta = -16384;
        fill &= (1 << bb) - 1;
    } else if (itheta == 16384) {
        imid = 0;
        iside = 32767;
        delta = 16384;
        fill &= ((1 << bb) - 1) << bb;
    } else {
        imid = bitexact_cos(itheta);
        iside = bitexact_cos(16384 - itheta);
        delta = frac_mul16((n - 1) << 7, bitexact_log2tan(iside, imid));
    }
    const float mid = (float)imid * (1.0f / 32768.0f);
    const float side = (float)iside * (1.0f / 32768.0f);
    int cm;
    if (n == 2) {
        int sbits = (itheta != 0 && itheta != 16384) ? 1 << BITRES : 0;
        int mbits = b - sbits;
        int flip = itheta > 8192;
        c.rb -= qalloc + sbits;
        int sign = sbits ? (int)rd_bits(c.d, 1) : 0;
        float sg = (float)(1 - 2 * sign);
        float *x2 = flip ? ys : xs, *y2 = flip ? xs : ys;
        cm = quant_band(T, c, band, x2, lb, lb_has, 2, mbits, tr, tf_change,
                        orig_fill);
        if (lane == 0) {
            if (nrm_out) {
                nrm_out[0] = nrm * x2[0];
                nrm_out[1] = nrm * x2[1];
            }
            y2[0] = -sg * x2[1];
            y2[1] = sg * x2[0];
            float a0 = xs[0] * mid, a1 = xs[1] * mid;
            float b0 = ys[0] * side, b1 = ys[1] * side;
            xs[0] = a0 - b0;
            ys[0] = a0 + b0;
            xs[1] = a1 - b1;
            ys[1] = a1 + b1;
        }
        __syncwarp();
    } else {
        int mbits = (b - delta) >> 1;          // floor division by 2
        if (mbits > b) mbits = b;
        if (mbits < 0) mbits = 0;
        int sbits = b - mbits;
        c.rb -= qalloc;
        const int rb0 = c.rb;
        if (mbits >= sbits) {
            cm = quant_band(T, c, band, xs, lb, lb_has, n, mbits, tr,
                            tf_change, fill);
            int reb = mbits - (rb0 - c.rb);
            if (reb > 3 << BITRES && itheta != 0) sbits += reb - (3 << BITRES);
            cm |= quant_band(T, c, band, ys, lb, 0, n, sbits, tr, tf_change,
                             fill >> bb, side);
        } else {
            cm = quant_band(T, c, band, ys, lb, 0, n, sbits, tr, tf_change,
                            fill >> bb, side);
            int reb = sbits - (rb0 - c.rb);
            if (reb > 3 << BITRES && itheta != 16384)
                mbits += reb - (3 << BITRES);
            cm |= quant_band(T, c, band, xs, lb, lb_has, n, mbits, tr,
                             tf_change, fill);
        }
        if (nrm_out) {
            for (int j = lane; j < n; j += LANES) nrm_out[j] = nrm * xs[j];
            __syncwarp();
        }
        stereo_merge(xs, ys, mid, n);
    }
    if (inv) {
        for (int j = lane; j < n; j += LANES) ys[j] = -ys[j];
        __syncwarp();
    }
    return cm;
}

// quant_all_bands with C = 2 (bands.c:1589), decode: dual stereo (the two
// channels as two mono bands, each folding from its own memory, until the
// intensity band averages the memories) or mid/side stereo; collapse
// masks per channel
__device__ void bands_stereo(const Tabs &T, Ctx &c, const BlockMem &bm,
                             StereoMem *sm, float *Xs, float *lb,
                             const Band<int> &pulses, const Band<int> &tf_res,
                             Band<int> *collapse, int coded_bands,
                             int balance, int tb8, int is_transient,
                             int spread, int intensity, int dual,
                             int disable_inv) {
    const int lane = lane_id();
    const int nb = T.nb, M = 1 << T.lm;
    const int start = T.start, end = T.end;
    const int32_t *eB = T.eBands;
    const int norm_offset = M * eB[start];
    const int norm_total = M * eB[nb - 1];
    float *Ys = sm->Y, *norm = sm->norm, *norm2 = sm->norm2, *lb2 = sm->lb2;
    const int B_l = is_transient ? M : 1;
    int lowband_offset = 0, update_lowband = 1;
    for (int i = start; i < end; i++) {
        int n = M * (eB[i + 1] - eB[i]);
        int tl = rd_tell_frac(c.d);
        if (i != start) balance -= tl;
        int remaining = tb8 - tl - 1;
        c.rb = remaining;
        int b = 0;
        int pi = bget(pulses, i);
        if (i <= coded_bands - 1) {
            int den = coded_bands - i;
            den = den < 1 ? 1 : (den > 3 ? 3 : den);
            int curr_balance = balance / den;   // truncating
            b = remaining + 1 < pi + curr_balance
                ? remaining + 1 : pi + curr_balance;
            b = b < 0 ? 0 : (b > 16383 ? 16383 : b);
        }
        if (M * eB[i] - n >= norm_offset || i == start + 1)
            if (update_lowband || lowband_offset == 0) lowband_offset = i;
        if (i == start + 1) {
            // special_hybrid_folding: both fold memories
            const int n1 = M * (eB[start + 1] - eB[start]);
            const int n2 = M * (eB[start + 2] - eB[start + 1]);
            for (int j = lane; j < n2 - n1; j += LANES) {
                norm[norm_offset + n1 + j] = norm[norm_offset + 2 * n1 - n2 + j];
                norm2[norm_offset + n1 + j] =
                    norm2[norm_offset + 2 * n1 - n2 + j];
            }
            __syncwarp();
        }
        int tf_change = bget(tf_res, i);
        int fold = lowband_offset != 0
            && (spread != 3 || B_l > 1 || tf_change < 0);
        if (dual && i == intensity) {
            dual = 0;
            for (int j = norm_offset + lane; j < M * eB[i]; j += LANES)
                norm[j] = 0.5f * (norm[j] + norm2[j]);
            __syncwarp();
        }
        int x_cm = fold ? 0 : (1 << B_l) - 1, y_cm = x_cm;
        if (fold) {
            int lo = lowband_offset;
            int eff = M * eB[lo] - n;
            if (eff < norm_offset) eff = norm_offset;
            int fs_ = lo;
            do {
                fs_--;
            } while (M * eB[fs_] > eff);
            int fe_ = lo - 1;
            do {
                fe_++;
            } while (fe_ < i && M * eB[fe_] < eff + n);
            int cx = 0, cy = 0, fi = fs_;
            do {
                cx |= bget(collapse[0], fi);
                cy |= bget(collapse[1], fi);
            } while (++fi < fe_);
            x_cm = cx;
            y_cm = cy;
            for (int j = lane; j < n; j += LANES) {
                int p = eff + j;
                lb[j] = p < norm_total ? norm[p] : 0.f;
                lb2[j] = p < norm_total ? norm2[p] : 0.f;
            }
        } else {
            for (int j = lane; j < n; j += LANES) lb[j] = lb2[j] = 0.f;
        }
        __syncwarp();
        const int base = M * eB[i];
        float *xs = Xs + base, *ys = Ys + base;
        const int last = i == end - 1;
        const float nrm = bm.nrm[i];
        int cmx, cmy;
        if (n == 1) {
            // quant_band_n1 on both channels
            int sx = 0, sy = 0;
            if (c.rb >= 1 << BITRES) {
                sx = (int)rd_bits(c.d, 1);
                c.rb -= 1 << BITRES;
            }
            if (c.rb >= 1 << BITRES) {
                sy = (int)rd_bits(c.d, 1);
                c.rb -= 1 << BITRES;
            }
            if (lane == 0) {
                xs[0] = sx ? -1.0f : 1.0f;
                ys[0] = sy ? -1.0f : 1.0f;
                if (!last) {
                    norm[base] = xs[0];
                    if (dual) norm2[base] = ys[0];
                }
            }
            __syncwarp();
            cmx = cmy = 1;
        } else if (dual) {
            cmx = quant_band(T, c, i, xs, lb, fold, n, b >> 1, is_transient,
                             tf_change, x_cm);
            cmy = quant_band(T, c, i, ys, lb2, fold, n, b >> 1, is_transient,
                             tf_change, y_cm);
            if (!last) {
                for (int j = lane; j < n; j += LANES) {
                    norm[base + j] = nrm * xs[j];
                    norm2[base + j] = nrm * ys[j];
                }
                __syncwarp();
            }
        } else {
            cmx = cmy = band_stereo(T, c, i, xs, ys, lb, fold, n, b,
                                    is_transient, tf_change, x_cm | y_cm,
                                    intensity, disable_inv,
                                    last ? nullptr : norm + base, nrm);
        }
        bset(collapse[0], i, cmx & 0xFF);
        bset(collapse[1], i, cmy & 0xFF);
        balance = balance + pi + tl;
        update_lowband = b > (n << BITRES);
    }
}

// ---------------------------------------------------------------- the frame
// C coded channels (1 or 2); old_e, prevmin, energies: [B, C, nb], X:
// [B, C, nx].  The mono instantiation keeps the mono code: each C == 2
// step is a branch the compiler drops for C == 1.  One resident block per
// SM asked of ptxas: up to 128 registers a thread at C == 1.
template <int C>
__global__ void __launch_bounds__(warps_of<C>() * LANES, 1)
celt_dec_frame_kernel(const uint8_t *__restrict__ buf, int P,
                      const int32_t *__restrict__ lens,
                      const float *__restrict__ old_e,
                      const float *__restrict__ prevmin,
                      const int64_t *__restrict__ seed_in,
                      const int32_t *__restrict__ rc_in,
                      const int32_t *__restrict__ tab, float *X,
                      float *energies, int32_t *ints, float *pf_gain_out,
                      int B, int nx, int disable_inv) {
    constexpr int NW = warps_of<C>();
    PROF_T(t_start);
    BlockMem &bm = *reinterpret_cast<BlockMem *>(k1_smem);
    const Tabs T = load_tabs(tab, bm.tab);
    __syncthreads();
    band_tables(T, bm, nx);
    __syncthreads();
    const int lane = lane_id(), warp = threadIdx.x / LANES;
    const int stream = blockIdx.x * NW + warp;
    if (stream >= B) return;
    const int nb = T.nb, lm = T.lm, M = 1 << lm;
    const int start = T.start, end = T.end;
    const int32_t *eB = T.eBands;
    const int32_t *caps = C == 2 ? T.caps2 : T.caps;
    const size_t per_warp = warp_bytes<C>() + ((P + 15) & ~15);
    WarpMem *w = reinterpret_cast<WarpMem *>(
        k1_smem + sizeof(BlockMem) + warp * per_warp);
    StereoMem *sm = reinterpret_cast<StereoMem *>(w + 1);
    uint8_t *pkt = reinterpret_cast<uint8_t *>(w + 1)
        + (C == 2 ? sizeof(StereoMem) : 0);
    float *const Xs = w->X;
    float *const lb = w->lb;

    // ---- the packet's bytes into shared memory
    int len = lens[stream];
    const uint8_t *src = buf + (size_t)stream * P;
    if ((P & 15) == 0 && (reinterpret_cast<uintptr_t>(buf) & 15) == 0) {
        for (int k = lane; k < (len + 15) >> 4; k += LANES)
            reinterpret_cast<uint4 *>(pkt)[k] =
                reinterpret_cast<const uint4 *>(src)[k];
    } else {
        for (int k = lane; k < len; k += LANES) pkt[k] = src[k];
    }
    for (int j = lane; j < nx; j += LANES) Xs[j] = 0.f;  // uncoded bands: 0
    if constexpr (C == 2)
        for (int j = lane; j < nx; j += LANES)
            sm->Y[j] = sm->norm[j] = sm->norm2[j] = 0.f;
    __syncwarp();

    Ctx c;
    c.w = w;
    c.J = lcg_jump(lane);
    if (rc_in)
        rd_load(c.d, pkt, len, rc_in + stream * 10);
    else
        rd_init(c.d, pkt, len);
    Band<float> e[C];
    Band<int> tf_res, offsets, bits1, bits2, pulses, ebits, fine_priority,
        thresh, collapse[C], trim_off;
    for (int s = 0; s < BSLOTS; s++) {
        int j = s * LANES + lane;
        for (int ch = 0; ch < C; ch++) {
            e[ch].v[s] = j < nb ? old_e[(stream * C + ch) * nb + j] : 0.f;
            collapse[ch].v[s] = 0;
        }
        tf_res.v[s] = offsets.v[s] = bits1.v[s] = bits2.v[s] = 0;
        pulses.v[s] = ebits.v[s] = fine_priority.v[s] = thresh.v[s] = 0;
        trim_off.v[s] = 0;
    }
    int intensity = 0, dual = 0;

    PROF_ADD(0, t_start);
    PROF_T(t_head);
    int total_bits = len * 8;
    int tell = rd_tell(c.d);
    int sil_bit = tell == 1 ? rd_bit_logp(c.d, 15) : 0;
    int silence = tell >= total_bits ? 1 : sil_bit;
    if (silence) c.d.nbits_total += total_bits - rd_tell(c.d);
    int live = !silence;
    int pf_pitch = 0, pf_tapset = 0, is_transient = 0, intra = 0, ac_on = 0;
    float pf_gain = 0.f;

    if (live) {
        // ---- postfilter (celt_decoder.c:1232), CELT-only frames
        tell = rd_tell(c.d);
        if (start == 0 && tell + 16 <= total_bits && rd_bit_logp(c.d, 1)) {
            int octave = (int)rd_uint(c.d, 6);
            pf_pitch = (16 << octave) + (int)rd_bits(c.d, 4 + octave) - 1;
            int qg = (int)rd_bits(c.d, 3);
            if (rd_tell(c.d) + 2 <= total_bits)
                pf_tapset = rd_icdf(c.d, TAPSET_ICDF, 3, 2);
            pf_gain = 0.09375f * (float)(qg + 1);
        }
        // ---- transient + intra
        tell = rd_tell(c.d);
        if (lm > 0 && tell + 3 <= total_bits)
            is_transient = rd_bit_logp(c.d, 3);
        tell = rd_tell(c.d);
        if (tell + 3 <= total_bits) intra = rd_bit_logp(c.d, 3);

        // ---- coarse energy (quant_bands.c unquant_coarse_energy)
        {
            float coef = intra ? 0.f : PRED_COEF[lm];
            float beta = intra ? 4915 / 32768.f : BETA_COEF[lm];
            const int32_t *prob = T.eprob + (intra ? 42 : 0);
            float prev[C] = {};
            for (int i = start; i < end; i++) {
                for (int ch = 0; ch < C; ch++) {
                    int t = rd_tell(c.d);
                    int qi;
                    if (total_bits - t >= 15) {
                        int pi = 2 * (i < 20 ? i : 20);
                        qi = laplace_decode(c.d, prob[pi] << 7,
                                            prob[pi + 1] << 6);
                    } else if (total_bits - t >= 2) {
                        int s = rd_icdf(c.d, SMALL_ENERGY_ICDF, 3, 2);
                        qi = (s >> 1) ^ -(s & 1);
                    } else if (total_bits - t >= 1) {
                        qi = -rd_bit_logp(c.d, 1);
                    } else {
                        qi = -1;
                    }
                    float q = (float)qi;
                    float ei = bget(e[ch], i);
                    float old = ei > -9.0f ? ei : -9.0f;
                    bset(e[ch], i, coef * old + prev[ch] + q);
                    prev[ch] = prev[ch] + q - beta * q;
                }
            }
        }
        PROF_ADD(1, t_head);
        PROF_T(t_tf);
        // ---- tf_decode
        {
            int budget = total_bits;
            tell = rd_tell(c.d);
            int tf_select_rsv = lm > 0
                && tell + (is_transient ? 2 : 4) + 1 <= budget;
            budget -= tf_select_rsv;
            int curr = 0, tf_changed = 0;
            for (int i = start; i < end; i++) {
                int logp = is_transient ? (i == start ? 2 : 4)
                                        : (i == start ? 4 : 5);
                if (tell + logp <= budget) {
                    curr ^= rd_bit_logp(c.d, logp);
                    tell = rd_tell(c.d);
                }
                tf_changed |= curr;
                bset(tf_res, i, curr);
            }
            const int *ts = TF_SELECT_TABLE[lm];
            int it4 = 4 * is_transient, tf_select = 0;
            if (tf_select_rsv && ts[it4 + tf_changed] != ts[it4 + 2 + tf_changed])
                tf_select = rd_bit_logp(c.d, 1);
            for (int s = 0; s < BSLOTS; s++) {
                int j = s * LANES + lane;
                if (j >= start && j < end)
                    tf_res.v[s] = ts[it4 + 2 * tf_select + tf_res.v[s]];
            }
        }
        // ---- spread
        int spread = 2;
        if (rd_tell(c.d) + 4 <= total_bits)
            spread = rd_icdf(c.d, SPREAD_ICDF, 4, 5);
        // ---- dynalloc + trim
        int trim;
        int total_bits8 = total_bits << BITRES;
        {
            int tellf = rd_tell_frac(c.d);
            int dyn_logp = 6;
            for (int i = start; i < end; i++) {
                int width = C * ((eB[i + 1] - eB[i]) << lm);
                int qa = width << BITRES;
                int qb = (6 << BITRES) > width ? (6 << BITRES) : width;
                int quanta = qa < qb ? qa : qb;
                int boost = 0, loop_logp = dyn_logp;
                while (tellf + (loop_logp << BITRES) < total_bits8
                       && boost < caps[i]) {
                    int flag = rd_bit_logp(c.d, loop_logp);
                    tellf = rd_tell_frac(c.d);
                    if (!flag) break;
                    boost += quanta;
                    total_bits8 -= quanta;
                    loop_logp = 1;
                }
                bset(offsets, i, boost);
                if (boost > 0) dyn_logp = dyn_logp - 1 > 2 ? dyn_logp - 1 : 2;
            }
            trim = tellf + (6 << BITRES) <= total_bits8
                ? rd_icdf(c.d, TRIM_ICDF, 11, 7) : 5;
        }
        PROF_ADD(2, t_tf);
        PROF_T(t_alloc);
        int bits_left = (len * 8 << BITRES) - rd_tell_frac(c.d) - 1;
        int ac_rsv = (is_transient && lm >= 2
                      && bits_left >= ((lm + 2) << BITRES)) ? 1 << BITRES : 0;
        bits_left -= ac_rsv;

        // ---- compute_allocation (rate.c:535), mono decode
        int coded_bands, balance;
        {
            int total = bits_left > 0 ? bits_left : 0;
            int skip_rsv = total >= (1 << BITRES) ? 1 << BITRES : 0;
            total -= skip_rsv;
            // the intensity and dual-stereo reservations (rate.c)
            int intensity_rsv = 0, dual_rsv = 0;
            if constexpr (C == 2) {
                intensity_rsv = LOG2_FRAC_TABLE[end - start];
                if (intensity_rsv > total) {
                    intensity_rsv = 0;
                } else {
                    total -= intensity_rsv;
                    dual_rsv = total >= 1 << BITRES ? 1 << BITRES : 0;
                    total -= dual_rsv;
                }
            }
            for (int s = 0; s < BSLOTS; s++) {
                int j = s * LANES + lane;
                if (j >= nb) continue;
                int w = eB[j + 1] - eB[j];
                int t = (3 * w << lm << BITRES) >> 4;
                thresh.v[s] = t > (C << BITRES) ? t : (C << BITRES);
                int to = (C * w * (trim - 5 - lm) * (end - 1 - j)
                          * (1 << (lm + BITRES))) >> 6;
                if ((w << lm) == 1) to -= C << BITRES;
                trim_off.v[s] = to;
            }
            const int nv = T.nv;
            int lo = 1, hi = nv - 1;
            for (int it = 0; it < 6; it++) {
                if (lo > hi) continue;
                int mid = (lo + hi) >> 1;
                int psum = alloc_sum(start, end, caps,
                                     [&](int s, int j, int &thr) {
                    int bj = (C * (eB[j + 1] - eB[j])
                              * T.allocV[mid * nb + j]) << lm >> 2;
                    if (bj > 0) {
                        bj += trim_off.v[s];
                        if (bj < 0) bj = 0;
                    }
                    thr = thresh.v[s];
                    return bj + offsets.v[s];
                }, C << BITRES);
                if (psum > total) hi = mid - 1;
                else lo = mid + 1;
            }
            int hi_f = lo, lo_f = lo - 1;
            // skip_start: the highest coded band with a dynalloc boost
            int skip_start = start;
            for (int s = BSLOTS - 1; s >= 0; s--) {
                int j = s * LANES + lane;
                unsigned m = __ballot_sync(
                    FULL, j >= start && j < end && offsets.v[s] > 0);
                if (m) {
                    skip_start = s * LANES + 31 - __clz(m);
                    break;
                }
            }
            for (int s = 0; s < BSLOTS; s++) {
                int j = s * LANES + lane;
                if (j < start || j >= end) continue;
                int w = eB[j + 1] - eB[j];
                int lc = lo_f < 0 ? 0 : (lo_f > nv - 1 ? nv - 1 : lo_f);
                int hc = hi_f < 0 ? 0 : (hi_f > nv - 1 ? nv - 1 : hi_f);
                int b1 = (C * w * T.allocV[lc * nb + j]) << lm >> 2;
                int b2 = hi_f >= nv ? caps[j]
                    : (C * w * T.allocV[hc * nb + j]) << lm >> 2;
                if (b1 > 0) {
                    b1 += trim_off.v[s];
                    if (b1 < 0) b1 = 0;
                }
                if (b2 > 0) {
                    b2 += trim_off.v[s];
                    if (b2 < 0) b2 = 0;
                }
                if (lo_f > 0) b1 += offsets.v[s];
                b2 += offsets.v[s];
                bits1.v[s] = b1;
                bits2.v[s] = b2 - b1 > 0 ? b2 - b1 : 0;
            }
            // ---- interp_bits2pulses (rate.c:249), mono decode
            const int alloc_floor = C << BITRES;
            lo = 0;
            hi = 1 << ALLOC_STEPS;
            for (int it = 0; it < ALLOC_STEPS; it++) {
                int mid = (lo + hi) >> 1;
                int psum = alloc_sum(start, end, caps,
                                     [&](int s, int, int &thr) {
                    thr = thresh.v[s];
                    return bits1.v[s] + ((mid * bits2.v[s]) >> ALLOC_STEPS);
                }, alloc_floor);
                if (psum > total) hi = mid;
                else lo = mid;
            }
            // the chosen trial's bits per band, summed as alloc_sum does
            int psum = 0, done_hi = 0;
            for (int s = BSLOTS - 1; s >= 0; s--) {
                int j = s * LANES + lane;
                int in = j >= start && j < end;
                int tmp = in ? bits1.v[s] + ((lo * bits2.v[s]) >> ALLOC_STEPS)
                             : 0;
                unsigned m = __ballot_sync(FULL, in && tmp >= thresh.v[s]);
                int done = done_hi || (m >> lane) != 0;
                if (!done) tmp = tmp >= alloc_floor ? alloc_floor : 0;
                if (in) {
                    if (tmp > caps[j]) tmp = caps[j];
                    pulses.v[s] = tmp;
                    psum += tmp;
                }
                done_hi |= m != 0;
            }
            psum = warp_sum(psum);
            coded_bands = end;
            int forced_stop = 0;
            // down to j == start, where skipping always stops at
            // skip_start (rate.c interp_bits2pulses; skip_start >= start)
            for (int j = end - 1; j >= start; j--) {
                if (coded_bands != j + 1) break;
                if (j <= skip_start) {
                    forced_stop = 1;
                    break;
                }
                int left = total - psum;
                int den = eB[j + 1] - eB[start];
                int percoeff = floordiv(left, den);
                int leftr = left - den * percoeff;
                int rem = leftr - (eB[j] - eB[start]);
                if (rem < 0) rem = 0;
                int pj = bget(pulses, j);
                int band_bits = pj + percoeff * (eB[j + 1] - eB[j]) + rem;
                int th = bget(thresh, j) > alloc_floor + (1 << BITRES)
                    ? bget(thresh, j) : alloc_floor + (1 << BITRES);
                if (band_bits >= th) {
                    if (rd_bit_logp(c.d, 1)) break;
                    psum += 1 << BITRES;
                    band_bits -= 1 << BITRES;
                }
                int keep = band_bits >= alloc_floor ? alloc_floor : 0;
                psum = psum - pj + keep;
                if constexpr (C == 2) {
                    psum -= intensity_rsv;
                    if (intensity_rsv > 0)
                        intensity_rsv = LOG2_FRAC_TABLE[j - start];
                    psum += intensity_rsv;
                }
                bset(pulses, j, keep);
                coded_bands--;
            }
            if (forced_stop) total += skip_rsv;
            if constexpr (C == 2) {
                // the intensity band and the dual-stereo flag
                if (intensity_rsv > 0)
                    intensity = start + (int)rd_uint(
                        c.d, (uint32_t)(coded_bands + 1 - start));
                if (intensity <= start) {
                    total += dual_rsv;
                    dual_rsv = 0;
                }
                if (dual_rsv > 0) dual = rd_bit_logp(c.d, 1);
            }
            int left = total - psum;
            int cb = coded_bands < 0 ? 0 : (coded_bands > nb ? nb : coded_bands);
            int den = eB[cb] - eB[start];
            if (den < 1) den = 1;
            int percoeff = floordiv(left, den);
            left -= den * percoeff;
            for (int s = 0; s < BSLOTS; s++) {
                int j = s * LANES + lane;
                if (j >= start && j < end && j < coded_bands)
                    pulses.v[s] += percoeff * (eB[j + 1] - eB[j]);
            }
            for (int j = start; j < end; j++) {
                if (j >= coded_bands) continue;
                int w = eB[j + 1] - eB[j];
                int take = left < w ? left : w;
                bset(pulses, j, bget(pulses, j) + take);
                left -= take;
            }
            balance = 0;
            const int log_m = lm << BITRES;
            for (int j = start; j < end; j++) {
                int n = (eB[j + 1] - eB[j]) << lm;
                int in_c = j < coded_bands;
                int pj = bget(pulses, j);
                int bitj = pj + balance;
                int excess, bj, eb, fp;
                if (n > 1) {
                    excess = bitj - caps[j] > 0 ? bitj - caps[j] : 0;
                    bj = bitj - excess;
                    // a mid/side band below the intensity band codes one
                    // more dimension (rate.c)
                    int den = C * n;
                    if (C == 2 && n > 2 && !dual && j < intensity) den++;
                    int nclogn = den * (T.logN[j] + log_m);
                    int offset = (nclogn >> 1) - den * FINE_OFFSET;
                    if (n == 2) offset += den << BITRES >> 2;
                    int off1 = bj + offset < (den * 2 << BITRES)
                        ? offset + (nclogn >> 2)
                        : (bj + offset < (den * 3 << BITRES)
                               ? offset + (nclogn >> 3) : offset);
                    eb = bj + off1 + (den << (BITRES - 1));
                    if (eb < 0) eb = 0;
                    eb = (eb / den) >> BITRES;
                    if (C * eb > (bj >> BITRES)) eb = bj >> (C - 1) >> BITRES;
                    if (eb > MAX_FINE_BITS) eb = MAX_FINE_BITS;
                    fp = eb * (den << BITRES) >= bj + off1;
                    bj -= C * eb << BITRES;
                } else {
                    excess = bitj - (C << BITRES) > 0 ? bitj - (C << BITRES)
                                                      : 0;
                    bj = bitj - excess;
                    eb = 0;
                    fp = 1;
                }
                int extra_fine = excess >> (C - 1 + BITRES);
                if (extra_fine > MAX_FINE_BITS - eb) extra_fine = MAX_FINE_BITS - eb;
                int extra_bits = extra_fine * C << BITRES;
                int eb2 = eb, excess2 = excess;
                if (excess > 0) {
                    eb2 = eb + extra_fine;
                    fp = extra_bits >= excess - balance;
                    excess2 = excess - extra_bits;
                }
                int unc_eb = pj >> (C - 1) >> BITRES;
                bset(ebits, j, in_c ? eb2 : unc_eb);
                bset(fine_priority, j, in_c ? fp : (int)(unc_eb < 1));
                bset(pulses, j, in_c ? bj : 0);
                if (in_c) balance = excess2;
            }
        }
        PROF_ADD(3, t_alloc);
        PROF_T(t_fine);
        // ---- fine energy
        for (int i = start; i < end; i++) {
            int fq = bget(ebits, i);
            if (fq <= 0) continue;
            if (C == 2 && rd_tell(c.d) + C * fq > total_bits) continue;
            for (int ch = 0; ch < C; ch++) {
                int q2 = (int)rd_bits(c.d, fq);
                bset(e[ch], i, bget(e[ch], i)
                     + (((float)q2 + 0.5f) * ldexpf(1.0f, -fq) - 0.5f));
            }
        }

        PROF_ADD(4, t_fine);
        PROF_T(t_bands);
        // ---- quant_all_bands (bands.c:1589), mono decode.  Its fold
        // memory norm is sqrt(N) * X of the bands coded so far (zero
        // elsewhere), so folds read X; only band start+1 sees something
        // else: the top of band start copied to the bottom of its own
        // window (special_hybrid_folding, bands.c)
        if constexpr (C == 2) {
            c.seed = (uint32_t)seed_in[stream];
            c.spread = spread;
            bands_stereo(T, c, bm, sm, Xs, lb, pulses, tf_res, collapse,
                         coded_bands, balance, (len * 8 << BITRES) - ac_rsv,
                         is_transient, spread, intensity, dual, disable_inv);
        } else {
            const int norm_offset = M * eB[start];
            const int norm_total = M * eB[nb - 1];
            const int n1 = M * (eB[start + 1] - eB[start]);
            int tb8 = (len * 8 << BITRES) - ac_rsv;
            int B_l = is_transient ? M : 1;
            c.seed = (uint32_t)seed_in[stream];
            c.spread = spread;
            int lowband_offset = 0, update_lowband = 1;
            for (int i = start; i < end; i++) {
                int n = M * (eB[i + 1] - eB[i]);
                int tl = rd_tell_frac(c.d);
                if (i != start) balance -= tl;
                int remaining = tb8 - tl - 1;
                c.rb = remaining;
                int b = 0;
                int pi = bget(pulses, i);
                if (i <= coded_bands - 1) {
                    int den = coded_bands - i;
                    den = den < 1 ? 1 : (den > 3 ? 3 : den);
                    int curr_balance = balance / den;   // truncating
                    b = remaining + 1 < pi + curr_balance
                        ? remaining + 1 : pi + curr_balance;
                    b = b < 0 ? 0 : (b > 16383 ? 16383 : b);
                }
                if (M * eB[i] - n >= norm_offset || i == start + 1)
                    if (update_lowband || lowband_offset == 0)
                        lowband_offset = i;
                int tf_change = bget(tf_res, i);
                int fold = lowband_offset != 0
                    && (spread != 3 || B_l > 1 || tf_change < 0);
                int x_cm = fold ? 0 : (1 << B_l) - 1;
                if (fold) {
                    int lo = lowband_offset;
                    int eff = M * eB[lo] - n;
                    if (eff < norm_offset) eff = norm_offset;
                    int fs_ = lo;
                    do {
                        fs_--;
                    } while (M * eB[fs_] > eff);
                    int fe_ = lo - 1;
                    do {
                        fe_++;
                    } while (fe_ < i && M * eB[fe_] < eff + n);
                    int cmv = 0, fi = fs_;
                    do {
                        cmv |= bget(collapse[0], fi);
                    } while (++fi < fe_);
                    x_cm = cmv;
                    // the copied span of special_hybrid_folding
                    const int cp_lo = i == start + 1 ? norm_offset + n1 : 0;
                    const int cp_hi = i == start + 1 ? norm_offset + n : 0;
                    for (int j = lane; j < n; j += LANES) {
                        int p = eff + j;
                        if (p >= cp_lo && p < cp_hi) p -= n - n1;
                        lb[j] = eff + j < norm_total
                            ? bm.nrm[bm.band_of[p]] * Xs[p] : 0.f;
                    }
                } else {
                    for (int j = lane; j < n; j += LANES) lb[j] = 0.f;
                }
                __syncwarp();
                int base = M * eB[i];
                int cm = quant_band(T, c, i, Xs + base, lb, fold, n, b,
                                    is_transient, tf_change, x_cm);
                bset(collapse[0], i, cm & 0xFF);
                balance = balance + pi + tl;
                update_lowband = b > (n << BITRES);
            }
        }
        PROF_ADD(5, t_bands);
        PROF_T(t_fin);
        // ---- anti-collapse bit + energy finalise
        if (ac_rsv > 0) ac_on = (int)rd_bits(c.d, 1);
        {
            int bl = len * 8 - rd_tell(c.d);
            for (int prio = 0; prio < 2; prio++)
                for (int i = start; i < end; i++) {
                    int ebi = bget(ebits, i);
                    if (!(bl >= C && ebi < MAX_FINE_BITS
                          && bget(fine_priority, i) == prio))
                        continue;
                    for (int ch = 0; ch < C; ch++) {
                        int q2 = (int)rd_bits(c.d, 1);
                        bset(e[ch], i, bget(e[ch], i)
                             + ((float)q2 - 0.5f) * ldexpf(1.0f, -(ebi + 1)));
                        bl--;
                    }
                }
        }
        // ---- anti-collapse (bands.c:259)
        if (ac_on) {
            int kk = 1 << lm;
            for (int i = start; i < end; i++) {
                int n0 = eB[i + 1] - eB[i];
                int depth = floordiv(1 + bget(pulses, i), n0) >> lm;
                float th = 0.5f * exp2f(-0.125f * (float)depth);
                for (int ch = 0; ch < C; ch++) {
                    float ediff = bget(e[ch], i)
                        - prevmin[(stream * C + ch) * nb + i];
                    ediff = ediff > 0.f ? ediff : 0.f;
                    float r = 2.0f * exp2f(-ediff);
                    if (lm == 3) r = r * 1.41421356f;
                    r = (th < r ? th : r) * bm.isq[i];
                    float *xs = (ch ? sm->Y : Xs) + (eB[i] << lm);
                    int coll = bget(collapse[ch], i);
                    int any = 0;
                    for (int k = 0; k < kk; k++) {
                        if ((coll >> k) & 1) continue;
                        c.seed = lcg_fill(c.seed, n0, c.J,
                                          [&](int j, uint32_t s) {
                            xs[j * kk + k] = (s & 0x8000) ? r : -r;
                        });
                        any = 1;
                    }
                    __syncwarp();
                    if (any) renormalise(xs, n0 << lm, 1.0f);
                }
            }
        }
        PROF_ADD(6, t_fin);
    }

    // ---- outputs: X row-major [B, nx], the stream's row from shared memory
    PROF_T(t_out);
    for (int ch = 0; ch < C; ch++) {
        float *xo = X + ((size_t)stream * C + ch) * nx;
        const float *xsrc = ch ? sm->Y : Xs;
        if ((nx & 3) == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0) {
            for (int k = lane; k < nx >> 2; k += LANES)
                reinterpret_cast<float4 *>(xo)[k] =
                    reinterpret_cast<const float4 *>(xsrc)[k];
        } else {
            for (int j = lane; j < nx; j += LANES) xo[j] = xsrc[j];
        }
        for (int s = 0; s < BSLOTS; s++) {
            int j = s * LANES + lane;
            if (j < nb) energies[(stream * C + ch) * nb + j] = e[ch].v[s];
        }
    }
    if (lane == 0) {
        int32_t *o = ints + stream * 9;
        o[0] = silence;
        o[1] = is_transient;
        o[2] = intra;
        o[3] = ac_on;
        o[4] = pf_pitch;
        o[5] = pf_tapset;
        o[6] = c.d.error;
        o[7] = rd_tell(c.d);
        o[8] = (int32_t)c.d.rng;
        pf_gain_out[stream] = pf_gain;
    }
    PROF_ADD(7, t_out);
    PROF_ADD(14, t_start);
}

}  // namespace

namespace {

// dynamic shared memory of a block: the staged tables and each warp's
// WarpMem (and StereoMem at C = 2) with its packet bytes; above 48 KB the
// kernel must opt in
template <int C>
size_t block_smem(int P) {
    return sizeof(BlockMem)
        + warps_of<C>() * (warp_bytes<C>() + ((P + 15) & ~15));
}

template <int C>
cudaError_t opt_in_smem(size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(celt_dec_frame_kernel<C>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

template <int C>
int launch(const void *buf, int P, const void *lens, const void *old_e,
           const void *prevmin, const void *seed, const void *rc_in,
           const void *tab, void *X, void *energies, void *ints,
           void *pf_gain, int B, int nx, int disable_inv, void *stream) {
    if (B <= 0) return 0;
    if (nx > NX_MAX || P < 0) return (int)cudaErrorInvalidValue;
    constexpr int NW = warps_of<C>();
    const size_t smem = block_smem<C>(P);
    cudaError_t e = opt_in_smem<C>(smem);
    if (e != cudaSuccess) return (int)e;
    celt_dec_frame_kernel<C><<<(B + NW - 1) / NW, NW * LANES, smem,
                               (cudaStream_t)stream>>>(
        (const uint8_t *)buf, P, (const int32_t *)lens,
        (const float *)old_e, (const float *)prevmin, (const int64_t *)seed,
        (const int32_t *)rc_in, (const int32_t *)tab, (float *)X,
        (float *)energies, (int32_t *)ints, (float *)pf_gain, B, nx,
        disable_inv);
    return (int)cudaGetLastError();
}

template <int C>
int occupancy(int P, int *info) {
    const size_t smem = block_smem<C>(P);
    cudaError_t e = opt_in_smem<C>(smem);
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, celt_dec_frame_kernel<C>, warps_of<C>() * LANES, smem);
    cudaFuncAttributes a = {};
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&a, celt_dec_frame_kernel<C>);
    info[0] = (int)smem;
    info[1] = warps_of<C>();
    info[2] = blocks;
    info[3] = a.numRegs;
    info[4] = (int)a.localSizeBytes;
    return (int)e;
}

}  // namespace

// rc_in: NULL, or [B, 10] int32 initial coder states (see rd_load);
// X: [B, nx] f32, row-major
extern "C" int opus_celt_dec_frame_launch(
    const void *buf, int P, const void *lens, const void *old_e,
    const void *prevmin, const void *seed, const void *rc_in,
    const void *tab, void *X, void *energies, void *ints, void *pf_gain,
    int B, int nx, void *stream) {
    return launch<1>(buf, P, lens, old_e, prevmin, seed, rc_in, tab, X,
                     energies, ints, pf_gain, B, nx, 0, stream);
}

// the two-channel instantiation: old_e, prevmin, energies [B, 2, nb], X
// [B, 2, nx]; disable_inv: the decoder's flag (1 on a decoder with one
// output channel)
extern "C" int opus_celt_dec_frame2_launch(
    const void *buf, int P, const void *lens, const void *old_e,
    const void *prevmin, const void *seed, const void *rc_in,
    const void *tab, void *X, void *energies, void *ints, void *pf_gain,
    int B, int nx, int disable_inv, void *stream) {
    return launch<2>(buf, P, lens, old_e, prevmin, seed, rc_in, tab, X,
                     energies, ints, pf_gain, B, nx, disable_inv, stream);
}

#ifdef K1_PROFILE
// the cycle sums of k1_prof (K1_NPROF slots) into out, then zeroed
extern "C" int opus_celt_dec_frame_profile(unsigned long long *out) {
    static const unsigned long long zero[K1_NPROF] = {};
    cudaError_t e = cudaMemcpyFromSymbol(out, k1_prof, sizeof zero);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(k1_prof, zero, sizeof zero);
    return (int)e;
}
#endif

// K1's geometry at packet stride P, for reports: info = [shared memory
// bytes per block, warps per block, resident blocks per SM, registers per
// thread, local memory bytes per thread]
extern "C" int opus_celt_dec_frame_occupancy(int P, int *info) {
    return occupancy<1>(P, info);
}

extern "C" int opus_celt_dec_frame2_occupancy(int P, int *info) {
    return occupancy<2>(P, info);
}

extern "C" const char *opus_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
