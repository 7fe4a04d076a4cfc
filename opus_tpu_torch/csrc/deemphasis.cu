// Kernel K2: first-order IIR de-emphasis y[n] = x[n] + coef * y[n-1] with
// a carry, one warp per stream, as a coalesced warp scan.
//
// Replaces the Pallas TPU kernel opus_tpu/ops/iir_pallas.py:47 (_kernel,
// launched by deemphasis), which turns the recursion into 128-sample
// triangular-Toeplitz matmuls on the MXU with the carry in VMEM.  This
// card has no use for the matmul form (2 flops a sample do not need
// tensor cores), but the same idea splits the recursion: a chunk of
// samples with a zero carry, then the carry.  Neither a fused elementwise
// pass nor a reduction, so CUDA rather than Triton.
//
// Bound on this card: memory traffic, one f32 read and one write per
// sample (8 bytes for 2 flops), ~31.5 MB a 20 ms frame at B = 4096, so
// ~9.4 us at 3.35 TB/s.  A full serial scan per thread (the bring-up
// design) could not get near it: one thread per stream over [B, N]
// row-major puts a warp's 32 loads N floats apart, 32 sectors per load,
// and B = 4096 streams are only 128 warps, under one per scheduler, too
// few loads in flight to cover the memory latency.  So each stream is a
// warp:
//
// 1. the warp loads its row into shared memory with coalesced 16-byte
//    loads (a row is N floats, N = 120, 240, 480 or 960);
// 2. lane j runs the serial recurrence over its chunk of C = ceil(N / 32)
//    samples with a zero carry (ragged: the last chunks may be short or
//    empty), and keeps the chunk's map carry -> carry, y = c^len y + last;
// 3. a warp scan (__shfl_up_sync) composes the maps of the lanes below,
//    giving each lane its incoming carry (the stream's mem for lane 0);
// 4. each lane adds c^(k+1) * carry to its chunk's k-th sample, the
//    powers built in double and rounded once (so a silent stream's
//    first chunk, mem * c^(k+1), has the plain version's bits);
// 5. the row and mem_out (its last sample) are written back coalesced.
//
// B = 4096 gives 4096 warps in blocks of K2_WARPS.  Errors: each sample is
// the serial f32 recurrence over at most C terms plus a carry term whose
// power and scan cost a few ULPs more, well inside the plain version's
// 128-term dot product bound (chip_smoke.py K2_REL_TOL).

#include <cuda_runtime.h>
#include <stdint.h>

// dynamic shared memory: one row of N floats (rounded up to 4) per warp
extern __shared__ __align__(16) float k2_smem[];

namespace {

constexpr int LANES = 32;         // a warp per stream
constexpr int K2_WARPS = 8;       // streams per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __host__ __forceinline__ int row_floats(int N) {
    return (N + 3) & ~3;
}

__global__ void __launch_bounds__(K2_WARPS * LANES)
deemphasis_kernel(const float *__restrict__ x,
                  const float *__restrict__ mem, float *__restrict__ y,
                  float *__restrict__ mem_out, int B, int N, float coef) {
    const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
    const int b = blockIdx.x * K2_WARPS + warp;
    if (b >= B) return;
    float *s = k2_smem + (size_t)warp * row_floats(N);
    const float *xr = x + (size_t)b * N;
    float *yr = y + (size_t)b * N;
    const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0
        && (reinterpret_cast<uintptr_t>(y) & 15) == 0;

    // 1. the row, coalesced
    if (vec) {
        for (int k = lane; k < N >> 2; k += LANES)
            reinterpret_cast<float4 *>(s)[k] =
                reinterpret_cast<const float4 *>(xr)[k];
    } else {
        for (int k = lane; k < N; k += LANES) s[k] = xr[k];
    }
    __syncwarp();

    // 2. this lane's chunk with a zero carry
    const int C = (N + LANES - 1) / LANES;
    const int lo = lane * C;
    const int len = N - lo < C ? (N - lo > 0 ? N - lo : 0) : C;
    float last = 0.f;                   // the chunk's map: y -> a y + last
    double a = 1.0;
    for (int t = 0; t < len; t++) {
        last = s[lo + t] + coef * last;
        s[lo + t] = last;
        a *= coef;
    }

    // 3. compose the maps of lanes 0..lane (lane 0's first)
    float A = (float)a, Y = last;
    for (int o = 1; o < LANES; o <<= 1) {
        float A2 = __shfl_up_sync(FULL, A, o);
        float Y2 = __shfl_up_sync(FULL, Y, o);
        if (lane >= o) {
            Y = A * Y2 + Y;
            A = A * A2;
        }
    }
    const float m0 = mem[b];
    float carry = __shfl_up_sync(FULL, A * m0 + Y, 1);
    if (lane == 0) carry = m0;

    // 4. the carry's share, coef^(t+1) * carry, the power rounded once
    // from double as the plain version's table is
    double p = coef;
    for (int t = 0; t < len; t++) {
        s[lo + t] = s[lo + t] + (float)p * carry;
        p *= coef;
    }
    __syncwarp();

    // 5. the row and the new memory, coalesced
    if (vec) {
        for (int k = lane; k < N >> 2; k += LANES)
            reinterpret_cast<float4 *>(yr)[k] =
                reinterpret_cast<const float4 *>(s)[k];
    } else {
        for (int k = lane; k < N; k += LANES) yr[k] = s[k];
    }
    if (lane == 0) mem_out[b] = N > 0 ? s[N - 1] : m0;
}

}  // namespace

extern "C" int opus_deemphasis_launch(const void *x, const void *mem,
                                      void *y, void *mem_out, int B, int N,
                                      float coef, void *stream) {
    if (B <= 0) return 0;
    if (N < 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)K2_WARPS * row_floats(N) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            deemphasis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    deemphasis_kernel<<<(B + K2_WARPS - 1) / K2_WARPS, K2_WARPS * LANES,
                        smem, (cudaStream_t)stream>>>(
        (const float *)x, (const float *)mem, (float *)y, (float *)mem_out,
        B, N, coef);
    return (int)cudaGetLastError();
}
