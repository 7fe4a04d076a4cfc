// Kernel K2: first-order IIR de-emphasis y[n] = x[n] + coef * y[n-1],
// one thread per stream.
//
// Replaces the Pallas TPU kernel opus_tpu/ops/iir_pallas.py (_kernel,
// launched by deemphasis), which turns the recursion into 128-sample
// triangular-Toeplitz matmuls on the MXU with the carry in VMEM.  On this
// card the recursion is a serial per-stream scan: each thread keeps the
// carry in a register and walks its N samples.  Neither a fused
// elementwise pass nor a reduction, so CUDA rather than Triton.
//
// Bound: memory traffic (one f32 read and one write per sample, 8 bytes
// for 2 flops).  Layout [B, N] row-major puts neighbouring threads on
// addresses N floats apart, so loads are not coalesced; a transposed or
// warp-cooperative layout is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void deemphasis_kernel(const float *__restrict__ x,
                                  const float *__restrict__ mem,
                                  float *__restrict__ y,
                                  float *__restrict__ mem_out, int B, int N,
                                  float coef) {
    int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float *xr = x + (size_t)b * N;
    float *yr = y + (size_t)b * N;
    float m = mem[b];
    for (int n = 0; n < N; n++) {
        m = xr[n] + coef * m;
        yr[n] = m;
    }
    mem_out[b] = m;
}

}  // namespace

extern "C" int opus_deemphasis_launch(const void *x, const void *mem,
                                      void *y, void *mem_out, int B, int N,
                                      float coef, void *stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    deemphasis_kernel<<<(B + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
        (const float *)x, (const float *)mem, (float *)y, (float *)mem_out,
        B, N, coef);
    return (int)cudaGetLastError();
}
