// Kernel K5: op-cost microbenchmarks, one kernel per case (a template on
// the case), one thread per lane.
//
// Replaces the Pallas TPU kernels of tools/kbench_ops.py (the inner f of
// `timed`, and the switch5 kernel in main), which apply one op class
// UNROLL times per trip for TRIPS trips on an [8, 128] int32 tile and
// report ns per op instance.  Here each thread carries one lane's acc
// through the same trips x unroll dependent chain (uint32 arithmetic, so
// the int32 wrap of the TPU cases is defined behaviour) and writes the
// final value, which opus_tpu_torch/tools/kbench_ops.py's plain versions
// reproduce exactly.
//
// What the design does about the compiler: every op is followed by an
// empty asm statement that claims to change acc, so nvcc cannot fold a
// chain (64 "acc + 1" into one "acc + 64", 64 "acc * 3" into one multiply
// by 3**64) or hoist it out of the loop; the add and multiply operands
// and page_sweep40's mask come in as kernel arguments, so ptxas, which
// sees through the empty asm, knows no constant either (division by the
// literal 77 keeps its literal: strength reduction is what that case
// measures); adds of one operand go through add_kept.  The trip loops are
// not unrolled, so chip_smoke.py's count of each case's signature
// instructions in the SASS (cuobjdump -sass) is the count of one trip.
//
// Bound on this card: the latency of one dependent op per thread (a few
// cycles each), over few warps per SM; the bytes are a few KB.
//
// dyn_read8 stages the rows it can read (aux rows 0..49 of [64, lanes]) in
// shared memory, the counterpart of the TPU's VMEM; page_sweep40 hoists its
// 40 pages into registers as the TPU kernel hoists them into vregs;
// switch5 reads its 400-entry node table from shared memory and every
// thread of the block takes the same branch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TRIPS = 256;
constexpr int SWITCH_NODES = 400;
constexpr int DYN_ROWS = 50;         // rows t % 50 reads

enum Case {
    ADD, MUL_I32, MUL_U32, DIV_U32, DIV_U32_CONST, SELECT, CMP_ADD,
    SHIFT_VAR, F32_MAD, CLZ, DYN_READ8, PAGE_SWEEP40, SWITCH5, N_CASES
};

// ops applied per trip, as tools/kbench_ops.py unrolls them
__host__ __device__ constexpr int unroll_of(int c) {
    return c == DYN_READ8 ? 16 : (c == PAGE_SWEEP40 ? 4 : 64);
}

struct Args {
    uint32_t one, three, k_mul, mask31;    // 1, 3, 2654435761, 31
    uint32_t on0, on1;                     // 1, 1: add_kept's predicates
    float f_mul, f_add;                    // 1.0001f, 1.0f
};

#define KEEP(x) asm volatile("" : "+r"(x))

// acc + v, predicated on a flag the compiler cannot know (always 1).
// ptxas sees through KEEP and turns (acc + v) + v into one acc + 2v
// (IMAD/LEA); two adds under different unknown predicates cannot become
// one instruction, so alternating on0/on1 keeps one add per op.
__device__ __forceinline__ uint32_t add_kept(uint32_t acc, uint32_t v,
                                             uint32_t on) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
        "@p add.u32 %0, %0, %1;\n\t}"
        : "+r"(acc) : "r"(v), "r"(on));
    return acc;
#else
    return on ? acc + v : acc;
#endif
}

// dynamic shared memory: dyn_read8's rows, switch5's node table
extern __shared__ uint32_t smem[];

template <int C>
__device__ __forceinline__ uint32_t body(uint32_t acc, uint32_t t, int u,
                                         const Args &a) {
    if (C == ADD) {
        acc = add_kept(acc, a.one, u & 1 ? a.on1 : a.on0);
    } else if (C == MUL_I32) {
        acc = acc * a.three;
    } else if (C == MUL_U32) {
        acc = acc * a.k_mul;
    } else if (C == DIV_U32) {
        acc = acc / (t + 3u) + acc;
    } else if (C == DIV_U32_CONST) {
        acc = acc / 77u + acc;
    } else if (C == SELECT) {
        acc = (int32_t)acc > (int32_t)t ? acc : acc + 1u;
    } else if (C == CMP_ADD) {
        acc = acc + (uint32_t)((int32_t)acc > (int32_t)t);
    } else if (C == SHIFT_VAR) {
        acc = (acc >> (acc & 7u)) + 1u;
    } else if (C == F32_MAD) {
        float x = __int2float_rn((int32_t)acc);
        acc = (uint32_t)__float2int_rz(__fadd_rn(__fmul_rn(x, a.f_mul),
                                                 a.f_add));
    } else if (C == CLZ) {
        acc = (uint32_t)__clz(acc) + acc;
    }
    KEEP(acc);
    return acc;
}

template <int C>
__global__ void kbench_kernel(const int32_t *__restrict__ x0,
                              const int32_t *__restrict__ aux,
                              int32_t *__restrict__ out, int lanes,
                              Args a) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = lane < lanes;
    if (C == DYN_READ8) {
        for (int r = 0; r < DYN_ROWS; r++)
            smem[r * blockDim.x + threadIdx.x] =
                live ? (uint32_t)aux[(size_t)r * lanes + lane] : 0u;
        __syncthreads();
    } else if (C == SWITCH5) {
        for (int j = threadIdx.x; j < SWITCH_NODES; j += blockDim.x)
            smem[j] = (uint32_t)aux[j];
        __syncthreads();
    }
    if (!live) return;
    uint32_t acc = (uint32_t)x0[lane];
    if (C == PAGE_SWEEP40) {
        uint32_t pg[40];
#pragma unroll
        for (int w = 0; w < 40; w++) pg[w] = (uint32_t)aux[(size_t)w * lanes + lane];
#pragma unroll 1
        for (int t = 0; t < TRIPS; t++) {
#pragma unroll
            for (int u = 0; u < unroll_of(C); u++) {
                // an opaque mask: with a literal 31 ptxas proves idx < 32
                // and drops the compares against pages 32-39
                uint32_t idx = acc & a.mask31;
                uint32_t o = pg[0];
#pragma unroll
                for (int w = 1; w < 40; w++) {
                    o = idx == (uint32_t)w ? pg[w] : o;
                    KEEP(o);
                }
                acc = acc + o;
                KEEP(acc);
            }
        }
    } else if (C == DYN_READ8) {
        const volatile uint32_t *s = smem;
#pragma unroll 1
        for (int t = 0; t < TRIPS; t++) {
            const int row = t % DYN_ROWS;
#pragma unroll
            for (int u = 0; u < unroll_of(C); u++) {
                acc = acc + s[row * blockDim.x + threadIdx.x];
                KEEP(acc);
            }
        }
    } else if (C == SWITCH5) {
        const uint32_t inc[5] = {a.one, 2u * a.one, 3u * a.one, 4u * a.one,
                                 5u * a.one};
#pragma unroll 1
        for (int t = 0; t < SWITCH_NODES; t++) {
            switch (smem[t]) {
#define BRANCH(j)                                                       \
    case j:                                                             \
        _Pragma("unroll") for (int k = 0; k < 32; k++)                  \
            acc = add_kept(acc, inc[j], k & 1 ? a.on1 : a.on0);         \
        break;
                BRANCH(0)
                BRANCH(1)
                BRANCH(2)
                BRANCH(3)
                BRANCH(4)
#undef BRANCH
                default:
                    break;
            }
        }
    } else {
#pragma unroll 1
        for (int t = 0; t < TRIPS; t++) {
#pragma unroll
            for (int u = 0; u < unroll_of(C); u++)
                acc = body<C>(acc, (uint32_t)t, u, a);
        }
    }
    out[lane] = (int32_t)acc;
}

}  // namespace

template <int C>
static int launch(const int32_t *x0, const int32_t *aux, int32_t *out,
                  int lanes, int threads, Args a, cudaStream_t stream) {
    size_t shmem = 0;
    if (C == DYN_READ8) shmem = (size_t)DYN_ROWS * threads * sizeof(uint32_t);
    if (C == SWITCH5) shmem = SWITCH_NODES * sizeof(uint32_t);
    if (shmem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kbench_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shmem);
        if (e != cudaSuccess) return (int)e;
    }
    kbench_kernel<C><<<(lanes + threads - 1) / threads, threads, shmem,
                       stream>>>(x0, aux, out, lanes, a);
    return (int)cudaGetLastError();
}

// One launch of case `which` (the Case order above) over `lanes` lanes in
// blocks of `threads`.  x0/out: [lanes] int32; aux: [64, lanes] int32 for
// dyn_read8, [40, lanes] for page_sweep40, the [400] node table for
// switch5, unused otherwise.
extern "C" int opus_kbench_launch(int which, const void *x0, const void *aux,
                                  void *out, int lanes, int threads,
                                  void *stream) {
    if (lanes <= 0) return 0;
    if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
    const Args a = {1u, 3u, 2654435761u, 31u, 1u, 1u, 1.0001f, 1.0f};
    const int32_t *x = (const int32_t *)x0, *ax = (const int32_t *)aux;
    int32_t *o = (int32_t *)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (which) {
#define CASE(c) \
    case c:     \
        return launch<c>(x, ax, o, lanes, threads, a, s);
        CASE(ADD) CASE(MUL_I32) CASE(MUL_U32) CASE(DIV_U32)
        CASE(DIV_U32_CONST) CASE(SELECT) CASE(CMP_ADD) CASE(SHIFT_VAR)
        CASE(F32_MAD) CASE(CLZ) CASE(DYN_READ8) CASE(PAGE_SWEEP40)
        CASE(SWITCH5)
#undef CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}
