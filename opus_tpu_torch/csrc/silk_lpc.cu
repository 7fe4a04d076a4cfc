// Kernel K4: the SILK LPC synthesis recursion over one subframe
// (reference: silk_decode_core, silk/decode_core.c:195-216), one thread per
// stream:
//
//     pred  = order/2 + sum_j SMULWB(s[j], a_rev[j])      (16 terms, int32 wrap)
//     v[i]  = ADD_SAT32(res[i], LSHIFT_SAT32(pred, 4))
//     s     = shift_in(s, v[i])
//
// Replaces the Pallas TPU kernel opus_tpu/ops/lpc_pallas.py (_kernel,
// launched by lpc_subframe), which tiles 1024 streams as sixteen [8, 128]
// vector registers and unrolls 8 samples at a time.  That kernel runs
// sf // 8 blocks and so leaves the last 4 samples of a 60-sample (12 kHz)
// subframe uncomputed; this one loops over every sample.
//
// The recurrence is serial in the sample index, neither elementwise nor a
// reduction, so CUDA rather than Triton.  Each thread keeps its 16 state
// taps and 16 coefficients in registers (fixed-size arrays, every index
// static under #pragma unroll) and walks the subframe.  Bound: memory
// traffic (res and v, 8 bytes a sample, against ~48 integer operations a
// sample, far below the card's int32 rate).  The [B, sf] row-major layout
// of the JAX signature puts neighbouring threads sf words apart, so loads
// and stores are not coalesced; a transposed or warp-cooperative layout is
// later work.
//
// Integer semantics: SMULWB as a 64-bit product of an int16 coefficient;
// the 16-term sum in uint32 (wrapping, as the reference's int32 adds do;
// signed overflow is undefined in C++); saturation by compares.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kOrder = 16;

__device__ __forceinline__ int32_t smulwb(int32_t a, int32_t b) {
    return (int32_t)(((int64_t)a * (int16_t)b) >> 16);
}

__device__ __forceinline__ int32_t lshift_sat32_4(int32_t a) {
    if (a > (INT32_MAX >> 4)) return INT32_MAX;
    if (a < (INT32_MIN >> 4)) return INT32_MIN;
    return (int32_t)((uint32_t)a << 4);
}

__device__ __forceinline__ int32_t add_sat32(int32_t a, int32_t b) {
    int64_t s = (int64_t)a + (int64_t)b;
    if (s > INT32_MAX) return INT32_MAX;
    if (s < INT32_MIN) return INT32_MIN;
    return (int32_t)s;
}

__global__ void silk_lpc_kernel(const int32_t *__restrict__ res,
                                const int32_t *__restrict__ a_rev,
                                const int32_t *__restrict__ slpc,
                                int32_t *__restrict__ v,
                                int32_t *__restrict__ slpc_out, int B, int sf,
                                int order_half) {
    int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int32_t s[kOrder];
    int32_t a[kOrder];
#pragma unroll
    for (int j = 0; j < kOrder; j++) {
        s[j] = slpc[(size_t)b * kOrder + j];
        a[j] = a_rev[(size_t)b * kOrder + j];
    }
    const int32_t *r = res + (size_t)b * sf;
    int32_t *out = v + (size_t)b * sf;
    for (int i = 0; i < sf; i++) {
        uint32_t acc = (uint32_t)order_half;
#pragma unroll
        for (int j = 0; j < kOrder; j++) acc += (uint32_t)smulwb(s[j], a[j]);
        int32_t x = add_sat32(r[i], lshift_sat32_4((int32_t)acc));
        out[i] = x;
#pragma unroll
        for (int j = 0; j < kOrder - 1; j++) s[j] = s[j + 1];
        s[kOrder - 1] = x;
    }
#pragma unroll
    for (int j = 0; j < kOrder; j++) slpc_out[(size_t)b * kOrder + j] = s[j];
}

}  // namespace

extern "C" int opus_silk_lpc_launch(const void *res, const void *a_rev,
                                    const void *slpc, void *v, void *slpc_out,
                                    int B, int sf, int order_half,
                                    void *stream) {
    if (B <= 0) return 0;
    const int threads = 64;
    silk_lpc_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
        (const int32_t *)res, (const int32_t *)a_rev, (const int32_t *)slpc,
        (int32_t *)v, (int32_t *)slpc_out, B, sf, order_half);
    return (int)cudaGetLastError();
}
