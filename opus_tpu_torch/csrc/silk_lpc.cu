// Kernel K4: the SILK LPC synthesis recursion over one subframe
// (reference: silk_decode_core, silk/decode_core.c:195-216):
//
//     pred  = order/2 + sum_j SMULWB(s[j], a_rev[j])      (16 terms, int32 wrap)
//     v[i]  = ADD_SAT32(res[i], LSHIFT_SAT32(pred, 4))
//     s     = shift_in(s, v[i])
//
// Replaces the Pallas TPU kernel opus_tpu/ops/lpc_pallas.py:67 (_kernel,
// launched by lpc_subframe), which tiles 1024 streams as sixteen [8, 128]
// vector registers and unrolls 8 samples at a time.  That kernel runs
// sf // 8 blocks and so leaves the last 4 samples of a 60-sample (12 kHz)
// subframe uncomputed; this one computes every sample.
//
// The recurrence is serial in the sample index, neither elementwise nor a
// reduction, so CUDA rather than Triton.  One thread per stream: splitting
// the 16 taps across lanes would put shuffles on the per-sample chain.
// Bound on this card: the bytes (res and v, 8 bytes a sample) give ~1 us
// at B = 4096 and sf 80; the per-sample work gives more.  So the design
// keeps the bytes coalesced and the chain short.  What holds it then is
// the integer multiplier: 16 IMAD.HI a sample issue at ~8 SM cycles each
// (opus_tpu_torch/tools/k1_profile.py --kernel k4: ~138 cycles a sample
// against 84 that the compiler schedules), and B = 4096 streams are one
// warp on each of 128 of the card's 528 schedulers (PERF.md §6).
//
// - Staging.  A block's K4_THREADS consecutive streams own one contiguous
//   chunk of res (and of a_rev, slpc, v and the new slpc).  The block
//   loads each chunk with coalesced 16-byte loads and stores it transposed
//   into shared memory, [sample][stream] with a pitch of K4_THREADS + 1
//   words, so a thread's per-sample read and write hit one bank per
//   thread.  v overwrites res in place and leaves the same way, back
//   transposed and stored coalesced; the new state is v's last 16
//   samples.
// - A one-tap chain.  SMULWB(s, a) = (s * (int16)a) >> 16 is one 32-bit
//   high multiply, __mulhi(s, a << 16), and with the add one IMAD.HI.  A
//   sample's 14 oldest taps are independent products summed as a tree,
//   then v[n-2]'s and v[n-1]'s taps are added, so only the newest tap's
//   IMAD.HI sits between v[n-1] and pred, and the rest of the sum is
//   ready a period early.  The saturations are recast so that pred feeds
//   one shift-add and two tests (add_sat_lshift4); what depends on res[n]
//   alone is off the chain.
// - The sample loop is unrolled by 20, which divides every SILK subframe
//   length (40, 60, 80), so the 16-sample window shifts by renaming
//   registers, the coefficients stay in registers (no stack) and each
//   res load is hoisted off the chain.
//
// Integer semantics: int32 wrapping sums in uint32 (the reference's int32
// adds wrap; signed overflow is undefined in C++), saturation exact.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef K4_THREADS
#define K4_THREADS 32
#endif

// dynamic shared memory: [sf + 32][K4_THREADS + 1] int32 (block_smem)
extern __shared__ __align__(16) int32_t k4_smem[];

namespace {

constexpr int T = K4_THREADS;     // streams (threads) per block
constexpr int PITCH = T + 1;      // words per staged row
constexpr int ORDER = 16;
constexpr int UNROLL = 20;        // divides 40, 60 and 80

// -------------------------------------------------------------- profiling
// Built with -DK4_PROFILE (opus_tpu_torch/tools/k1_profile.py --kernel
// k4), lane 0 of each warp adds the SM clock cycles of each phase into
// k4_prof; the card's build and the host rehearsal compile none of it.
#ifdef K4_PROFILE
constexpr int K4_NPROF = 4;
__device__ unsigned long long k4_prof[K4_NPROF];
#define PROF_T(v) const long long v = clock64()
#define PROF_ADD(slot, t0)                                                   \
    do {                                                                     \
        if (threadIdx.x % 32 == 0)                                           \
            atomicAdd(&k4_prof[slot], (unsigned long long)(clock64() - t0)); \
    } while (0)
#else
#define PROF_T(v)
#define PROF_ADD(slot, t0)
#endif

// a (int16-valued) as the high half of a word: __mulhi(s, coef16(a)) =
// (s * a * 2^16) >> 32 = SMULWB(s, a) for every int32 s
__device__ __forceinline__ int32_t coef16(int32_t a) {
    return (int32_t)((uint32_t)a << 16);
}

// SMLAWB: acc + SMULWB(s, a), wrapping: one mad.hi (IMAD.HI).  It and
// add32 are PTX on the card, where the compiler takes them as written:
// the same sums in C++ ran K4 11% slower on this card (PERF.md §6)
__device__ __forceinline__ uint32_t smlawb(uint32_t acc, int32_t s,
                                           int32_t a16) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm("mad.hi.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(s), "r"(a16), "r"(acc));
    return d;
#else
    return acc + (uint32_t)__mulhi(s, a16);
#endif
}

__device__ __forceinline__ uint32_t add32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t d;
    asm("add.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
#else
    return a + b;
#endif
}

// ADD_SAT32(r, LSHIFT_SAT32(x, 4)).  vlo = ADD_SAT32(r, INT32_MIN) and
// vhi = ADD_SAT32(r, INT32_MAX) depend on r alone, so they are ready
// before x.  For x in [INT32_MIN >> 4, INT32_MAX >> 4] the shift is exact
// and keeps x's sign, so the sum r + (x << 4) overflows where r and x
// share a sign that the sum lacks, and then saturates to vhi (x > 0) or
// vlo (x < 0).  Outside that range LSHIFT_SAT32 gives INT32_MAX (not the
// clamped value shifted) or INT32_MIN, and the result is again vhi or vlo.
__device__ __forceinline__ int32_t add_sat_lshift4(int32_t r, uint32_t x) {
    const int32_t vlo = (int32_t)((uint32_t)(r > 0 ? r : 0) + 0x80000000u);
    const int32_t vhi = (int32_t)((uint32_t)(r < 0 ? r : 0) + 0x7fffffffu);
    const uint32_t s = (uint32_t)r + (x << 4);
    const bool ovf = (int32_t)(((uint32_t)r ^ s) & ~((uint32_t)r ^ x)) < 0;
    const bool out = x + (1u << 27) >= (1u << 28);
    return (ovf || out) ? ((int32_t)x < 0 ? vlo : vhi) : (int32_t)s;
}

// the staged word of the k-th 16-byte group of a [T][W] chunk (W % 4 ==
// 0, so a group never straddles two rows): column 4 (k % (W / 4)), row
// k / (W / 4).  Every k < T * W / 4 lies inside the staged array, so
// only the device-memory side of a ragged block's copies is guarded and
// the shared-memory side runs unconditionally (no branch per group).
template <int W>
__device__ __forceinline__ int staged(unsigned k) {
    return (int)((k % (W / 4)) * 4 * PITCH + k / (W / 4));
}

// rows x W words at src (row-major, 16-byte aligned) -> dst[col * PITCH +
// row]; the groups past the last row store zeros
template <int W>
__device__ __forceinline__ void stage_in(const int32_t *__restrict__ src,
                                         int rows, int32_t *dst) {
    const unsigned n4 = rows * (W / 4);
#pragma unroll
    for (int j = 0; j < W / 4; j++) {
        const unsigned k = threadIdx.x + j * T;
        int4 q = {0, 0, 0, 0};
        if (k < n4) q = reinterpret_cast<const int4 *>(src)[k];
        int32_t *d = dst + staged<W>(k);
        d[0] = q.x;
        d[PITCH] = q.y;
        d[2 * PITCH] = q.z;
        d[3 * PITCH] = q.w;
    }
}

// the reverse: src[col * PITCH + row] -> rows x W words at dst
template <int W>
__device__ __forceinline__ void stage_out(const int32_t *src, int rows,
                                          int32_t *__restrict__ dst) {
    const unsigned n4 = rows * (W / 4);
#pragma unroll
    for (int j = 0; j < W / 4; j++) {
        const unsigned k = threadIdx.x + j * T;
        const int32_t *s = src + staged<W>(k);
        int4 q;
        q.x = s[0];
        q.y = s[PITCH];
        q.z = s[2 * PITCH];
        q.w = s[3 * PITCH];
        if (k < n4) reinterpret_cast<int4 *>(dst)[k] = q;
    }
}

// one stream's recursion over its staged column: x[i * PITCH] holds
// res[i] and receives v[i]; a and s0 the coefficients and the state
template <int SF>
__device__ __forceinline__ void synthesize(int32_t *x, const int32_t *a,
                                           const int32_t *s0,
                                           int order_half) {
    // s: the last 16 outputs, s[15] = v[n-1] (a window that the unrolled
    // loop shifts by renaming registers)
    int32_t a16[ORDER], s[ORDER];
#pragma unroll
    for (int j = 0; j < ORDER; j++) {
        a16[j] = coef16(a[j * PITCH]);
        s[j] = s0[j * PITCH];
    }
    const uint32_t base = (uint32_t)order_half;
#pragma unroll 1
    for (int i0 = 0; i0 < SF; i0 += UNROLL) {
        int32_t *blk = x + i0 * PITCH;
#pragma unroll
        for (int u = 0; u < UNROLL; u++) {
            const int32_t r = blk[u * PITCH];
            // taps 0-13 (v[n-16] .. v[n-3]): independent products summed
            // as a balanced tree, ready a period before they are needed
            uint32_t q[7];
#pragma unroll
            for (int k = 0; k < 7; k++)
                q[k] = add32(smlawb(0u, s[2 * k], a16[2 * k]),
                             smlawb(0u, s[2 * k + 1], a16[2 * k + 1]));
            const uint32_t older =
                add32(add32(add32(q[0], q[1]), add32(q[2], q[3])),
                      add32(add32(q[4], q[5]), add32(q[6], base)));
            // v[n-2], then v[n-1]: one IMAD.HI between v[n-1] and pred
            const uint32_t pred = smlawb(smlawb(older, s[14], a16[14]),
                                         s[15], a16[15]);
#pragma unroll
            for (int j = 0; j < ORDER - 1; j++) s[j] = s[j + 1];
            s[ORDER - 1] = add_sat_lshift4(r, pred);
            blk[u * PITCH] = s[ORDER - 1];
        }
    }
}

template <int SF>
__global__ void __launch_bounds__(T)
silk_lpc_kernel(const int32_t *__restrict__ res,
                const int32_t *__restrict__ a_rev,
                const int32_t *__restrict__ slpc, int32_t *__restrict__ v,
                int32_t *__restrict__ slpc_out, int B, int order_half) {
    PROF_T(t_start);
    const int b0 = blockIdx.x * T;
    const int rows = B - b0 < T ? B - b0 : T;
    int32_t *sx = k4_smem;                     // [SF][PITCH]: res, then v
    int32_t *sa = sx + SF * PITCH;             // [16][PITCH]: a_rev
    int32_t *ss = sa + ORDER * PITCH;          // [16][PITCH]: slpc
    stage_in<SF>(res + (size_t)b0 * SF, rows, sx);
    stage_in<ORDER>(a_rev + (size_t)b0 * ORDER, rows, sa);
    stage_in<ORDER>(slpc + (size_t)b0 * ORDER, rows, ss);
    __syncthreads();
    PROF_ADD(0, t_start);
    PROF_T(t_rec);
    const int t = threadIdx.x;
    if (t < rows) synthesize<SF>(sx + t, sa + t, ss + t, order_half);
    PROF_ADD(1, t_rec);
    __syncthreads();
    PROF_T(t_out);
    stage_out<SF>(sx, rows, v + (size_t)b0 * SF);
    stage_out<ORDER>(sx + (SF - ORDER) * PITCH, rows,
                     slpc_out + (size_t)b0 * ORDER);
    PROF_ADD(2, t_out);
    PROF_ADD(3, t_start);
}

}  // namespace

// ------------------------------------------------------------ launching
namespace {

size_t block_smem(int sf) { return (size_t)(sf + 2 * ORDER) * PITCH * 4; }

template <int SF>
cudaError_t launch(const int32_t *res, const int32_t *a_rev,
                   const int32_t *slpc, int32_t *v, int32_t *slpc_out,
                   int B, int order_half, cudaStream_t stream) {
    const size_t smem = block_smem(SF);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            silk_lpc_kernel<SF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    silk_lpc_kernel<SF><<<(B + T - 1) / T, T, smem, stream>>>(
        res, a_rev, slpc, v, slpc_out, B, order_half);
    return cudaGetLastError();
}

}  // namespace

// res, v [B, sf]; a_rev, slpc, slpc_out [B, 16]; int32, row-major, each
// 16-byte aligned; sf 40, 60 or 80
extern "C" int opus_silk_lpc_launch(const void *res, const void *a_rev,
                                    const void *slpc, void *v, void *slpc_out,
                                    int B, int sf, int order_half,
                                    void *stream) {
    if (B <= 0) return 0;
    if (((uintptr_t)res | (uintptr_t)a_rev | (uintptr_t)slpc | (uintptr_t)v
         | (uintptr_t)slpc_out) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    const int32_t *r = (const int32_t *)res, *a = (const int32_t *)a_rev,
                  *s = (const int32_t *)slpc;
    int32_t *vo = (int32_t *)v, *so = (int32_t *)slpc_out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (sf) {
        case 40: return (int)launch<40>(r, a, s, vo, so, B, order_half, st);
        case 60: return (int)launch<60>(r, a, s, vo, so, B, order_half, st);
        case 80: return (int)launch<80>(r, a, s, vo, so, B, order_half, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K4's geometry at sf, for reports: info = [shared memory bytes per block,
// warps per block, resident blocks per SM, registers per thread, local
// memory bytes per thread]
extern "C" int opus_silk_lpc_occupancy(int sf, int *info) {
    const void *fn = sf == 40   ? (const void *)silk_lpc_kernel<40>
                     : sf == 60 ? (const void *)silk_lpc_kernel<60>
                     : sf == 80 ? (const void *)silk_lpc_kernel<80>
                                : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = block_smem(sf);
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, T,
                                                          smem);
    cudaFuncAttributes attr = {};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
    info[0] = (int)smem;
    info[1] = (T + 31) / 32;
    info[2] = blocks;
    info[3] = attr.numRegs;
    info[4] = (int)attr.localSizeBytes;
    return (int)e;
}

#ifdef K4_PROFILE
// the cycle sums of k4_prof (K4_NPROF slots) into out, then zeroed
extern "C" int opus_silk_lpc_profile(unsigned long long *out) {
    static const unsigned long long zero[K4_NPROF] = {};
    cudaError_t e = cudaMemcpyFromSymbol(out, k4_prof, sizeof zero);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(k4_prof, zero, sizeof zero);
    return (int)e;
}
#endif
