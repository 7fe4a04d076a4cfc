// Kernel K1: the mono CELT decode symbol pass for one 10/20 ms frame,
// one thread per stream, over the coded bands [start, end): start 0 for a
// CELT-only frame, 17 for the CELT half of a hybrid frame, which
// continues the range decoder that SILK leaves behind (the optional
// per-lane initial coder state; src/opus_decoder.c:432).
//
// Replaces the Pallas TPU kernel opus_tpu/models/celt_dec_kernel.py
// (_frame_kernel, launched by build_frame_fn).  What is kept is the
// integer semantics of that kernel and of its [B]-lane twin
// opus_tpu_torch/models/celt_dec_fused.py (the plain version this kernel
// is checked against): range decoding, coarse/fine energy, tf, spread,
// dynalloc, trim, allocation, the PVQ band tree (CWRS, theta,
// exp_rotation, folding, haar/hadamard), anti-collapse and energy
// finalise, error lanes included.  What is dropped is the TPU layout:
// the [8,128] lane tiles, the preorder node program, the gather-free page
// sweeps and the MXU wrapper matrices.  Each thread runs the pass as
// straight-line C (the scalar tier's structure, celt/{bands,alloc,
// energy,cwrs}.py), reads its packet bytes directly, and walks the band
// split tree with an explicit bounded stack.
//
// Bound on this card: serial integer work and local-memory traffic per
// stream (X, the fold buffer and the band scratch live in per-thread
// local memory), plus warp divergence between streams.  One thread per
// stream is the bring-up design; warp-cooperative bands are later work.
//
// The tables (eBands, logN, caps, alloc vectors, e_prob, the pulse
// cache rows and the CWRS U table) come in as one read-only int32 device
// tensor built by DecTabs.kernel_table(); this file holds no mode tables.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false (no fast math), so fp32 results track the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int QTHETA_OFFSET = 4;
constexpr int ALLOC_STEPS = 6;
constexpr int LAPLACE_CAP = 40;
constexpr int NB_MAX = 21;
constexpr int NX_MAX = 800;     // M * eBands[nb] at 20 ms
constexpr int NMAX = 176;       // widest band at 20 ms
constexpr int MAX_K = 128;
constexpr uint32_t CODE_BOT = 1u << 23;
constexpr uint32_t CODE_TOP = 1u << 31;

__constant__ int TELL_CORRECTION[8] = {35733, 38967, 42495, 46340,
                                       50535, 55109, 60097, 65535};
__constant__ int SMALL_ENERGY_ICDF[3] = {2, 1, 0};
__constant__ int TRIM_ICDF[11] = {126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0};
__constant__ int SPREAD_ICDF[4] = {25, 23, 2, 0};
__constant__ int TAPSET_ICDF[3] = {2, 1, 0};
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

// ---------------------------------------------------------------- tables
struct Tabs {
    int nb, lm, nv, urows, ucols, start, end;
    const int32_t *eBands, *logN, *caps, *allocV, *eprob, *rowoff, *rows;
    const uint32_t *u;
};

__device__ Tabs load_tabs(const int32_t *t) {
    Tabs T;
    T.nb = t[0];
    T.lm = t[1];
    T.nv = t[2];
    T.urows = t[3];
    T.ucols = t[4];
    T.start = t[5];
    T.end = t[6];
    T.eBands = t + t[7];
    T.logN = t + t[8];
    T.caps = t + t[9];
    T.allocV = t + t[10];
    T.eprob = t + t[11];
    T.rowoff = t + t[12];
    T.rows = t + t[13];
    T.u = reinterpret_cast<const uint32_t *>(t + t[14]);
    return T;
}

__device__ __forceinline__ const int32_t *cache_row(const Tabs &T, int lmn,
                                                    int band) {
    return T.rows + T.rowoff[(lmn + 1) * T.nb + band];
}

// U(k, n), saturated at 2^32-1
__device__ __forceinline__ uint32_t U(const Tabs &T, int k, int n) {
    return __ldg(T.u + k * T.ucols + n);
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
    const uint8_t *buf;
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

__device__ int isqrt24(int x) {
    int s = (int)sqrtf((float)x);
    s -= s * s > x;
    s += (s + 1) * (s + 1) <= x;
    return s;
}

__device__ __forceinline__ uint32_t lcg(uint32_t s) {
    return 1664525u * s + 1013904223u;
}

// ---------------------------------------------------------------- float ops
__device__ void haar1(float *x, int n0, int stride) {
    const float s = 0.70710678118654752440f;
    for (int i = 0; i < stride; i++)
        for (int j = 0; j < (n0 >> 1); j++) {
            int i0 = stride * 2 * j + i;
            float t1 = s * x[i0];
            float t2 = s * x[i0 + stride];
            x[i0] = t1 + t2;
            x[i0 + stride] = t1 - t2;
        }
}

__device__ const int *ordery(int stride) {
    return stride == 2 ? ORDERY2 : (stride == 4 ? ORDERY4 : ORDERY8);
}

__device__ void deinterleave_hadamard(float *x, float *tmp, int n0,
                                      int stride, int hadamard) {
    const int *ord = ordery(stride);
    for (int i = 0; i < stride; i++)
        for (int j = 0; j < n0; j++)
            tmp[(hadamard ? ord[i] : i) * n0 + j] = x[j * stride + i];
    for (int j = 0; j < n0 * stride; j++) x[j] = tmp[j];
}

__device__ void interleave_hadamard(float *x, float *tmp, int n0, int stride,
                                    int hadamard) {
    const int *ord = ordery(stride);
    for (int i = 0; i < stride; i++)
        for (int j = 0; j < n0; j++)
            tmp[j * stride + i] = x[(hadamard ? ord[i] : i) * n0 + j];
    for (int j = 0; j < n0 * stride; j++) x[j] = tmp[j];
}

__device__ void exp_rotation1(float *x, int len, int stride, float c,
                              float s) {
    for (int i = 0; i < len - stride; i++) {
        float x1 = x[i], x2 = x[i + stride];
        x[i + stride] = c * x2 + s * x1;
        x[i] = c * x1 - s * x2;
    }
    for (int i = len - 2 * stride - 1; i >= 0; i--) {
        float x1 = x[i], x2 = x[i + stride];
        x[i + stride] = c * x2 + s * x1;
        x[i] = c * x1 - s * x2;
    }
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
    for (int i = 0; i < stride; i++) {
        if (stride2) exp_rotation1(x + i * len, len, stride2, s, c);
        exp_rotation1(x + i * len, len, 1, c, s);
    }
}

__device__ void renormalise(float *x, int n, float gain) {
    float e = 0.f;
    for (int i = 0; i < n; i++) e += x[i] * x[i];
    e += 1e-15f;
    float g = gain * rsqrtf(e);
    for (int i = 0; i < n; i++) x[i] *= g;
}

// ---------------------------------------------------------------- band tree
struct Ctx {
    RD d;
    int rb;
    uint32_t seed;
    int spread;
    int iy[NMAX];
    float tmp[NMAX];
};

// cwrsi (cwrs.c:467): codebook index -> pulse vector, with the downward
// k searches over the U table
__device__ void cwrsi(const Tabs &T, int n, int k, uint32_t i, int kcap,
                      int *y) {
    int idx = 0;
    for (; n > 2; n--) {
        int is_a = k >= n;
        uint32_t col_k = U(T, k, n), col_k1 = U(T, k + 1, n);
        int s = i >= col_k1;
        int izero = !is_a && col_k <= i && i < col_k1;
        if (izero) {
            i -= col_k;
            y[idx++] = 0;
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
        int kn = upper;
        while (kn > 0 && U(T, kn, n) > i) kn--;
        i -= U(T, kn, n);
        int val = k - kn;
        y[idx++] = s ? -val : val;
        k = kn;
    }
    uint32_t p = 2u * (uint32_t)k + 1;
    int s = i >= p;
    if (s) i -= p;
    int k2 = (int)((i + 1) >> 1);
    if (k2 > 0) i -= 2u * (uint32_t)k2 - 1;
    int val = k - k2;
    y[idx++] = s ? -val : val;
    y[idx] = i ? -k2 : k2;
}

__device__ int quant_leaf(const Tabs &T, Ctx &c, int band, float *x,
                          const float *lb, int lb_has, int n, int b, int bb,
                          float gain, int fill, const int32_t *row) {
    int L = row[0];
    int bm1 = b - 1;
    int lo = 0;
    for (int j = 1; j <= L; j++) lo += bm1 > row[j];
    int hi = lo + 1 < L ? lo + 1 : L;
    int lo_val = lo == 0 ? -1 : row[lo];
    int q = (bm1 - lo_val <= row[hi] - bm1) ? lo : hi;
    int c_fit = 0;
    for (int j = 1; j <= L; j++) c_fit += c.rb >= row[j] + 1;
    if (q > c_fit) q = c_fit;
    if (q < 0) q = 0;
    c.rb -= q > 0 ? row[q] + 1 : 0;
    int kq = q < 8 ? q : (8 + (q & 7)) << ((q >> 3) - 1);
    if (kq != 0) {
        int kcap = L < 8 ? L : (8 + (L & 7)) << ((L >> 3) - 1);
        if (kcap > MAX_K) kcap = MAX_K;
        int kc = kq < kcap ? kq : kcap;
        uint64_t v = (uint64_t)U(T, kc, n) + U(T, kc + 1, n);
        uint32_t ft = v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
        uint32_t idx = rd_uint(c.d, ft);
        cwrsi(T, n, kq > 1 ? kq : 1, idx, kcap, c.iy);
        float ryy = 0.f;
        for (int j = 0; j < n; j++) ryy += (float)(c.iy[j] * c.iy[j]);
        float g = gain * rsqrtf(ryy > 1e-30f ? ryy : 1e-30f);
        for (int j = 0; j < n; j++) x[j] = (float)c.iy[j] * g;
        exp_rotation_dec(x, n, bb, kq, c.spread);
        if (bb <= 1) return 1;
        int n0 = n / bb, cm = 0;
        for (int ib = 0; ib < bb; ib++) {
            int t = 0;
            for (int j = 0; j < n0; j++) t |= c.iy[ib * n0 + j] != 0;
            cm |= t << ib;
        }
        return cm;
    }
    int cm_mask = (1 << bb) - 1;
    int fillm = fill & cm_mask;
    if (fillm == 0) {
        for (int j = 0; j < n; j++) x[j] = 0.f;
        return 0;
    }
    for (int j = 0; j < n; j++) {
        c.seed = lcg(c.seed);
        x[j] = lb_has ? lb[j] + ((c.seed & 0x8000) ? 1.0f / 256 : -1.0f / 256)
                      : (float)((int32_t)c.seed >> 20);
    }
    renormalise(x, n, gain);
    return lb_has ? fillm : cm_mask;
}

struct QPFrame {
    int n, lm, b, bb, fill, xo, lo, phase;
    float gain;
    int b0, bb2, fill_s, itheta, mbits, sbits, swap, rb_before, cm0, bv0;
    float mid, side;
};

// quant_partition decode (bands.c:973) with an explicit stack: depth is
// bounded by LM + 2 levels of the band split tree
__device__ int quant_partition(const Tabs &T, Ctx &c, int band, float *x,
                               const float *lb, int lb_has, int n, int lm,
                               int b, int bb, int fill) {
    QPFrame st[6];
    int top = 0, ret = 0;
    st[0].n = n;
    st[0].lm = lm;
    st[0].b = b;
    st[0].bb = bb;
    st[0].fill = fill;
    st[0].gain = 1.0f;
    st[0].xo = 0;
    st[0].lo = 0;
    st[0].phase = 0;
    while (top >= 0) {
        QPFrame &f = st[top];
        if (f.phase == 0) {
            const int32_t *row = cache_row(T, f.lm, band);
            int split = f.lm != -1 && f.n > 2 && f.b > row[row[0]] + 12;
            if (!split) {
                ret = quant_leaf(T, c, band, x + f.xo, lb + f.lo, lb_has,
                                 f.n, f.b, f.bb, f.gain, f.fill, row);
                top--;
                continue;
            }
            int n2 = f.n >> 1, lm2 = f.lm - 1;
            f.b0 = f.bb;
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
                if (f.b0 > 1) {
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
            if (f.b0 > 1 && (itheta & 0x3fff)) {
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
            QPFrame &ch = st[top + 1];
            ch.n = n2;
            ch.lm = lm2;
            ch.b = f.bv0;
            ch.bb = f.bb2;
            ch.fill = f.swap ? f.fill_s >> f.bb2 : f.fill_s;
            ch.gain = f.gain * (f.swap ? f.side : f.mid);
            ch.xo = f.xo + (f.swap ? n2 : 0);
            ch.lo = f.lo + (f.swap ? n2 : 0);
            ch.phase = 0;
            top++;
        } else if (f.phase == 1) {
            f.cm0 = ret;
            int n2 = f.n >> 1;
            int rebalance = f.bv0 - (f.rb_before - c.rb);
            int anchor = f.swap ? 16384 : 0;
            int extra = (rebalance > (3 << BITRES) && f.itheta != anchor)
                ? rebalance - (3 << BITRES) : 0;
            f.phase = 2;
            QPFrame &ch = st[top + 1];
            ch.n = n2;
            ch.lm = f.lm - 1;
            ch.b = (f.swap ? f.mbits : f.sbits) + extra;
            ch.bb = f.bb2;
            ch.fill = f.swap ? f.fill_s : f.fill_s >> f.bb2;
            ch.gain = f.gain * (f.swap ? f.mid : f.side);
            ch.xo = f.xo + (f.swap ? 0 : n2);
            ch.lo = f.lo + (f.swap ? 0 : n2);
            ch.phase = 0;
            top++;
        } else {
            int cm_x = f.swap ? ret : f.cm0;
            int cm_y = f.swap ? f.cm0 : ret;
            ret = cm_x | (cm_y << (f.b0 >> 1));
            top--;
        }
    }
    return ret;
}

// quant_band, mono decode (bands.c:1245): tf/hadamard wrappers around
// quant_partition.  lb: the band's folding source (n floats, modified).
__device__ int quant_band(const Tabs &T, Ctx &c, int band, float *x,
                          float *lb, int lb_has, int n, int b, int tr,
                          int tf_change, int fill) {
    if (n == 1) {
        int sign = 0;
        if (c.rb >= 1 << BITRES) {
            sign = (int)rd_bits(c.d, 1);
            c.rb -= 1 << BITRES;
        }
        x[0] = sign ? -1.0f : 1.0f;
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
        haar1(lb, n >> k, 1 << k);
        fill = BIT_INTERLEAVE_TABLE[fill & 0xF]
            | BIT_INTERLEAVE_TABLE[(fill >> 4) & 0xF] << 2;
    }
    bb = B0 >> recombine;
    n_b = (n / B0) << recombine;
    for (int t = 0; t < tdiv; t++) {
        haar1(lb, n_b, bb);
        fill |= fill << bb;
        bb <<= 1;
        n_b >>= 1;
    }
    if (b0f > 1)
        deinterleave_hadamard(lb, c.tmp, n_b0 >> recombine, b0f << recombine,
                              longb);
    int cm = quant_partition(T, c, band, x, lb, lb_has, n, lm, b, b0f, fill);
    // resynth side: x + cm
    bb = b0f;
    n_b = n_b0;
    if (bb > 1)
        interleave_hadamard(x, c.tmp, n_b >> recombine, bb << recombine,
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

// ---------------------------------------------------------------- the frame
__global__ void __launch_bounds__(64)
celt_dec_frame_kernel(const uint8_t *__restrict__ buf, int P,
                      const int32_t *__restrict__ lens,
                      const float *__restrict__ old_e,
                      const float *__restrict__ prevmin,
                      const int64_t *__restrict__ seed_in,
                      const int32_t *__restrict__ rc_in,
                      const int32_t *__restrict__ tab, float *X_t,
                      float *energies, int32_t *ints, float *pf_gain_out,
                      int B, int nx) {
    int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    const Tabs T = load_tabs(tab);
    const int nb = T.nb, lm = T.lm, M = 1 << lm;
    const int start = T.start, end = T.end;
    const int32_t *eB = T.eBands;
    Ctx c;
    float X[NX_MAX];
    float norm[NX_MAX];
    float lb[NMAX];
    float e[NB_MAX];
    int tf_res[NB_MAX], offsets[NB_MAX], bits1[NB_MAX], bits2[NB_MAX];
    int pulses[NB_MAX], ebits[NB_MAX], fine_priority[NB_MAX];
    int thresh[NB_MAX], collapse[NB_MAX];

    int len = lens[lane];
    if (rc_in)
        rd_load(c.d, buf + (size_t)lane * P, len, rc_in + lane * 10);
    else
        rd_init(c.d, buf + (size_t)lane * P, len);
    for (int i = 0; i < nb; i++) {
        e[i] = old_e[lane * nb + i];
        tf_res[i] = offsets[i] = pulses[i] = ebits[i] = 0;
        fine_priority[i] = collapse[i] = 0;
    }
    for (int j = 0; j < nx; j++) X[j] = 0.f;     // uncoded bands stay 0

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
            float prev = 0.f;
            for (int i = start; i < end; i++) {
                int t = rd_tell(c.d);
                int qi;
                if (total_bits - t >= 15) {
                    int pi = 2 * (i < 20 ? i : 20);
                    qi = laplace_decode(c.d, prob[pi] << 7, prob[pi + 1] << 6);
                } else if (total_bits - t >= 2) {
                    int s = rd_icdf(c.d, SMALL_ENERGY_ICDF, 3, 2);
                    qi = (s >> 1) ^ -(s & 1);
                } else if (total_bits - t >= 1) {
                    qi = -rd_bit_logp(c.d, 1);
                } else {
                    qi = -1;
                }
                float q = (float)qi;
                float old = e[i] > -9.0f ? e[i] : -9.0f;
                e[i] = coef * old + prev + q;
                prev = prev + q - beta * q;
            }
        }
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
                tf_res[i] = curr;
            }
            const int *ts = TF_SELECT_TABLE[lm];
            int it4 = 4 * is_transient, tf_select = 0;
            if (tf_select_rsv && ts[it4 + tf_changed] != ts[it4 + 2 + tf_changed])
                tf_select = rd_bit_logp(c.d, 1);
            for (int i = start; i < end; i++)
                tf_res[i] = ts[it4 + 2 * tf_select + tf_res[i]];
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
                int width = (eB[i + 1] - eB[i]) << lm;
                int qa = width << BITRES;
                int qb = (6 << BITRES) > width ? (6 << BITRES) : width;
                int quanta = qa < qb ? qa : qb;
                int boost = 0, loop_logp = dyn_logp;
                while (tellf + (loop_logp << BITRES) < total_bits8
                       && boost < T.caps[i]) {
                    int flag = rd_bit_logp(c.d, loop_logp);
                    tellf = rd_tell_frac(c.d);
                    if (!flag) break;
                    boost += quanta;
                    total_bits8 -= quanta;
                    loop_logp = 1;
                }
                offsets[i] = boost;
                if (boost > 0) dyn_logp = dyn_logp - 1 > 2 ? dyn_logp - 1 : 2;
            }
            trim = tellf + (6 << BITRES) <= total_bits8
                ? rd_icdf(c.d, TRIM_ICDF, 11, 7) : 5;
        }
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
            int trim_off[NB_MAX];
            for (int j = 0; j < nb; j++) {
                int w = eB[j + 1] - eB[j];
                int t = (3 * w << lm << BITRES) >> 4;
                thresh[j] = t > (1 << BITRES) ? t : (1 << BITRES);
                trim_off[j] = (w * (trim - 5 - lm) * (end - 1 - j)
                               * (1 << (lm + BITRES))) >> 6;
                if ((w << lm) == 1) trim_off[j] -= 1 << BITRES;
            }
            const int nv = T.nv;
            int lo = 1, hi = nv - 1;
            for (int it = 0; it < 6; it++) {
                if (lo > hi) continue;
                int mid = (lo + hi) >> 1;
                int psum = 0, done = 0;
                for (int j = end - 1; j >= start; j--) {
                    int bj = ((eB[j + 1] - eB[j]) * T.allocV[mid * nb + j])
                        << lm >> 2;
                    if (bj > 0) {
                        bj += trim_off[j];
                        if (bj < 0) bj = 0;
                    }
                    bj += offsets[j];
                    if (bj >= thresh[j] || done) {
                        done = 1;
                        psum += bj < T.caps[j] ? bj : T.caps[j];
                    } else if (bj >= 1 << BITRES) {
                        psum += 1 << BITRES;
                    }
                }
                if (psum > total) hi = mid - 1;
                else lo = mid + 1;
            }
            int hi_f = lo, lo_f = lo - 1;
            int skip_start = start;
            for (int j = start; j < end; j++) {
                int w = eB[j + 1] - eB[j];
                int lc = lo_f < 0 ? 0 : (lo_f > nv - 1 ? nv - 1 : lo_f);
                int hc = hi_f < 0 ? 0 : (hi_f > nv - 1 ? nv - 1 : hi_f);
                int b1 = (w * T.allocV[lc * nb + j]) << lm >> 2;
                int b2 = hi_f >= nv ? T.caps[j]
                    : (w * T.allocV[hc * nb + j]) << lm >> 2;
                if (b1 > 0) {
                    b1 += trim_off[j];
                    if (b1 < 0) b1 = 0;
                }
                if (b2 > 0) {
                    b2 += trim_off[j];
                    if (b2 < 0) b2 = 0;
                }
                if (lo_f > 0) b1 += offsets[j];
                b2 += offsets[j];
                if (offsets[j] > 0) skip_start = j;
                bits1[j] = b1;
                bits2[j] = b2 - b1 > 0 ? b2 - b1 : 0;
            }
            // ---- interp_bits2pulses (rate.c:249), mono decode
            const int alloc_floor = 1 << BITRES;
            lo = 0;
            hi = 1 << ALLOC_STEPS;
            for (int it = 0; it < ALLOC_STEPS; it++) {
                int mid = (lo + hi) >> 1;
                int psum = 0, done = 0;
                for (int j = end - 1; j >= start; j--) {
                    int tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS);
                    if (tmp >= thresh[j] || done) {
                        done = 1;
                        psum += tmp < T.caps[j] ? tmp : T.caps[j];
                    } else if (tmp >= alloc_floor) {
                        psum += alloc_floor;
                    }
                }
                if (psum > total) hi = mid;
                else lo = mid;
            }
            int psum = 0, done = 0;
            for (int j = end - 1; j >= start; j--) {
                int tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS);
                if (tmp < thresh[j] && !done) tmp = tmp >= alloc_floor ? alloc_floor : 0;
                else done = 1;
                if (tmp > T.caps[j]) tmp = T.caps[j];
                pulses[j] = tmp;
                psum += tmp;
            }
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
                int band_bits = pulses[j] + percoeff * (eB[j + 1] - eB[j]) + rem;
                int th = thresh[j] > alloc_floor + (1 << BITRES)
                    ? thresh[j] : alloc_floor + (1 << BITRES);
                if (band_bits >= th) {
                    if (rd_bit_logp(c.d, 1)) break;
                    psum += 1 << BITRES;
                    band_bits -= 1 << BITRES;
                }
                int keep = band_bits >= alloc_floor ? alloc_floor : 0;
                psum = psum - pulses[j] + keep;
                pulses[j] = keep;
                coded_bands--;
            }
            if (forced_stop) total += skip_rsv;
            int left = total - psum;
            int cb = coded_bands < 0 ? 0 : (coded_bands > nb ? nb : coded_bands);
            int den = eB[cb] - eB[start];
            if (den < 1) den = 1;
            int percoeff = floordiv(left, den);
            left -= den * percoeff;
            for (int j = start; j < end; j++)
                if (j < coded_bands) pulses[j] += percoeff * (eB[j + 1] - eB[j]);
            for (int j = start; j < end; j++) {
                if (j >= coded_bands) continue;
                int w = eB[j + 1] - eB[j];
                int take = left < w ? left : w;
                pulses[j] += take;
                left -= take;
            }
            balance = 0;
            const int log_m = lm << BITRES;
            for (int j = start; j < end; j++) {
                int n = (eB[j + 1] - eB[j]) << lm;
                int in_c = j < coded_bands;
                int bitj = pulses[j] + balance;
                int excess, bj, eb, fp;
                if (n > 1) {
                    excess = bitj - T.caps[j] > 0 ? bitj - T.caps[j] : 0;
                    bj = bitj - excess;
                    int nclogn = n * (T.logN[j] + log_m);
                    int offset = (nclogn >> 1) - n * FINE_OFFSET;
                    if (n == 2) offset += n << BITRES >> 2;
                    int off1 = bj + offset < (n * 2 << BITRES)
                        ? offset + (nclogn >> 2)
                        : (bj + offset < (n * 3 << BITRES)
                               ? offset + (nclogn >> 3) : offset);
                    eb = bj + off1 + (n << (BITRES - 1));
                    if (eb < 0) eb = 0;
                    eb = (eb / n) >> BITRES;
                    if (eb > (bj >> BITRES)) eb = bj >> BITRES;
                    if (eb > MAX_FINE_BITS) eb = MAX_FINE_BITS;
                    fp = eb * (n << BITRES) >= bj + off1;
                    bj -= eb << BITRES;
                } else {
                    excess = bitj - (1 << BITRES) > 0 ? bitj - (1 << BITRES) : 0;
                    bj = bitj - excess;
                    eb = 0;
                    fp = 1;
                }
                int extra_fine = excess >> BITRES;
                if (extra_fine > MAX_FINE_BITS - eb) extra_fine = MAX_FINE_BITS - eb;
                int extra_bits = extra_fine << BITRES;
                int eb2 = eb, excess2 = excess;
                if (excess > 0) {
                    eb2 = eb + extra_fine;
                    fp = extra_bits >= excess - balance;
                    excess2 = excess - extra_bits;
                }
                int unc_eb = pulses[j] >> BITRES;
                ebits[j] = in_c ? eb2 : unc_eb;
                fine_priority[j] = in_c ? fp : unc_eb < 1;
                pulses[j] = in_c ? bj : 0;
                if (in_c) balance = excess2;
            }
        }
        // ---- fine energy
        for (int i = start; i < end; i++) {
            int fq = ebits[i];
            if (fq <= 0) continue;
            int q2 = (int)rd_bits(c.d, fq);
            e[i] = e[i] + (((float)q2 + 0.5f) * ldexpf(1.0f, -fq) - 0.5f);
        }

        // ---- quant_all_bands (bands.c:1589), mono decode; norm holds
        // absolute positions and nothing below norm_offset
        {
            const int norm_offset = M * eB[start];
            const int norm_total = M * eB[nb - 1];
            for (int j = 0; j < norm_total; j++) norm[j] = 0.f;
            int tb8 = (len * 8 << BITRES) - ac_rsv;
            int B_l = is_transient ? M : 1;
            c.seed = (uint32_t)seed_in[lane];
            c.spread = spread;
            int lowband_offset = 0, update_lowband = 1;
            for (int i = start; i < end; i++) {
                int n = M * (eB[i + 1] - eB[i]);
                int tl = rd_tell_frac(c.d);
                if (i != start) balance -= tl;
                int remaining = tb8 - tl - 1;
                c.rb = remaining;
                int b = 0;
                if (i <= coded_bands - 1) {
                    int den = coded_bands - i;
                    den = den < 1 ? 1 : (den > 3 ? 3 : den);
                    int curr_balance = balance / den;   // truncating
                    b = remaining + 1 < pulses[i] + curr_balance
                        ? remaining + 1 : pulses[i] + curr_balance;
                    b = b < 0 ? 0 : (b > 16383 ? 16383 : b);
                }
                if (M * eB[i] - n >= norm_offset || i == start + 1)
                    if (update_lowband || lowband_offset == 0)
                        lowband_offset = i;
                if (i == start + 1) {
                    // special_hybrid_folding (bands.c): fill band
                    // start+1's fold window from the top of band start
                    int n1 = M * (eB[start + 1] - eB[start]);
                    for (int j = n1; j < n; j++)
                        norm[norm_offset + j] = norm[norm_offset + j - n + n1];
                }
                int tf_change = tf_res[i];
                int fold = lowband_offset != 0
                    && (spread != 3 || B_l > 1 || tf_change < 0);
                int x_cm = fold ? 0 : (1 << B_l) - 1;
                for (int j = 0; j < n; j++) lb[j] = 0.f;
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
                        cmv |= collapse[fi];
                    } while (++fi < fe_);
                    x_cm = cmv;
                    for (int j = 0; j < n; j++)
                        lb[j] = eff + j < norm_total ? norm[eff + j] : 0.f;
                }
                int base = M * eB[i];
                int cm = quant_band(T, c, i, X + base, lb, fold, n, b,
                                    is_transient, tf_change, x_cm);
                collapse[i] = cm & 0xFF;
                if (i != end - 1) {
                    float nrm = (float)sqrt((double)n);
                    for (int j = 0; j < n; j++) norm[base + j] = nrm * X[base + j];
                }
                balance = balance + pulses[i] + tl;
                update_lowband = b > (n << BITRES);
            }
        }
        // ---- anti-collapse bit + energy finalise
        if (ac_rsv > 0) ac_on = (int)rd_bits(c.d, 1);
        {
            int bl = len * 8 - rd_tell(c.d);
            for (int prio = 0; prio < 2; prio++)
                for (int i = start; i < end; i++) {
                    if (!(bl >= 1 && ebits[i] < MAX_FINE_BITS
                          && fine_priority[i] == prio))
                        continue;
                    int q2 = (int)rd_bits(c.d, 1);
                    e[i] = e[i] + ((float)q2 - 0.5f) * ldexpf(1.0f, -(ebits[i] + 1));
                    bl--;
                }
        }
        // ---- anti-collapse (bands.c:259)
        if (ac_on) {
            int kk = 1 << lm;
            for (int i = start; i < end; i++) {
                int n0 = eB[i + 1] - eB[i];
                int depth = floordiv(1 + pulses[i], n0) >> lm;
                float th = 0.5f * exp2f(-0.125f * (float)depth);
                float sqrt_1 = (float)(1.0 / sqrt((double)(n0 << lm)));
                float ediff = e[i] - prevmin[lane * nb + i];
                ediff = ediff > 0.f ? ediff : 0.f;
                float r = 2.0f * exp2f(-ediff);
                if (lm == 3) r = r * 1.41421356f;
                r = (th < r ? th : r) * sqrt_1;
                float *xs = X + (eB[i] << lm);
                int any = 0;
                for (int k = 0; k < kk; k++) {
                    if ((collapse[i] >> k) & 1) continue;
                    for (int j = 0; j < n0; j++) {
                        c.seed = lcg(c.seed);
                        xs[j * kk + k] = (c.seed & 0x8000) ? r : -r;
                    }
                    any = 1;
                }
                if (any) renormalise(xs, n0 << lm, 1.0f);
            }
        }
    }

    // ---- outputs
    for (int j = 0; j < nx; j++) X_t[(size_t)j * B + lane] = X[j];
    for (int i = 0; i < nb; i++) energies[lane * nb + i] = e[i];
    int32_t *o = ints + lane * 9;
    o[0] = silence;
    o[1] = is_transient;
    o[2] = intra;
    o[3] = ac_on;
    o[4] = pf_pitch;
    o[5] = pf_tapset;
    o[6] = c.d.error;
    o[7] = rd_tell(c.d);
    o[8] = (int32_t)c.d.rng;
    pf_gain_out[lane] = pf_gain;
}

}  // namespace

// rc_in: NULL, or [B, 10] int32 initial coder states (see rd_load)
extern "C" int opus_celt_dec_frame_launch(
    const void *buf, int P, const void *lens, const void *old_e,
    const void *prevmin, const void *seed, const void *rc_in,
    const void *tab, void *X_t, void *energies, void *ints, void *pf_gain,
    int B, int nx, void *stream) {
    if (B <= 0) return 0;
    if (nx > NX_MAX) return (int)cudaErrorInvalidValue;
    const int threads = 64;
    celt_dec_frame_kernel<<<(B + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t *)buf, P, (const int32_t *)lens,
        (const float *)old_e, (const float *)prevmin, (const int64_t *)seed,
        (const int32_t *)rc_in, (const int32_t *)tab, (float *)X_t,
        (float *)energies,
        (int32_t *)ints, (float *)pf_gain, B, nx);
    return (int)cudaGetLastError();
}

extern "C" const char *opus_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
