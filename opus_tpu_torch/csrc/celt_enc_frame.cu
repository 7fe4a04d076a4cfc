// Kernel K3: the mono CBR CELT encode symbol pass for one 20 ms frame,
// one thread per stream, from ec_enc_init to the packet bytes.
//
// Replaces the Pallas TPU kernel opus_tpu/models/celt_enc_kernel.py
// (_enc_frame_kernel, launched by build_enc_frame_fn).  It computes the
// same function as its [B]-lane plain version encode_frame_plain
// (opus_tpu_torch/models/celt_enc_kernel.py), operation for operation on
// floats: the three header bits, coarse energy as a two-pass intra/inter
// trial (dry tell-tracker trials, then the picked pass for real), tf
// encode, spread, the dynalloc boosts, trim, the allocation with
// encode-side skip decisions, fine energy, the PVQ band trees (theta,
// exp_rotation, the greedy pulse search, the CWRS index, ec_enc_uint),
// the anti-collapse bit, energy finalise and ec_enc_done.  Unlike the TPU
// kernel it also owns the carry resolution: digits and end-window bytes go
// to per-thread buffers and are resolved (last digit to first) and
// assembled into the stream's bytes at the end, so no torch range-encoder
// op runs on the card's main path.
//
// What is dropped is the TPU layout: [8,128] lane tiles, the preorder node
// program (an explicit stack of at most LM + 2 pending nodes here; encode
// needs no pop events), the gather-free page sweeps and the MXU wrap
// matmul (a per-output fmaf chain over the nonzero taps in index order,
// the JAX twin's BLAS order).
//
// Bound on this card: serial integer and float work per stream in
// registers and per-thread local memory (the band window, the PVQ
// scratch, 164 digits and 161 end bytes), plus warp divergence between
// streams; the greedy pulse search is O(n * k) per leaf.  One thread per
// stream is the bring-up design; warp-cooperative bands are later work.
//
// The tables (mode, pulse cache, CWRS U/V, Laplace chains, band variants
// and wrap taps, rotation cos/sin) come in as one int32 and one float32
// device tensor built by ETabs.kernel_tables(); this file holds no mode
// tables.  Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17
// -O3 -fmad=false (no fast math), so float results equal the plain
// version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int QTHETA_OFFSET = 4;
constexpr int ALLOC_STEPS = 6;
constexpr int NB_MAX = 21;
constexpr int NMAX = 176;
constexpr int MAX_K = 128;
constexpr int MAX_BYTES = 160;
constexpr int DCAP = MAX_BYTES + 4;
constexpr int ECAP = MAX_BYTES + 1;
constexpr int EW_SLOTS = 8;
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

// ---------------------------------------------------------------- tables
enum { S_EBANDS, S_LOGN, S_CAPS, S_ALLOCV, S_EPROB, S_ROWOFF, S_ROWS, S_U,
       S_V, S_LAPOFF, S_LAP, S_DEPTH, S_KCAP, S_VAR, S_EWIDX, S_ROTOFF,
       S_COUNT };
constexpr int HDR = 6;

struct Tabs {
    int nb, lm, nv, nx, urows, ucols;
    const int32_t *s[S_COUNT];
    const float *f;
};

__device__ Tabs load_tabs(const int32_t *t, const float *f) {
    Tabs T;
    T.nb = t[0];
    T.lm = t[1];
    T.nv = t[2];
    T.nx = t[3];
    T.urows = t[4];
    T.ucols = t[5];
    for (int i = 0; i < S_COUNT; i++) T.s[i] = t + t[HDR + i];
    T.f = f;
    return T;
}

__device__ __forceinline__ const int32_t *cache_row(const Tabs &T, int lmn,
                                                    int band) {
    return T.s[S_ROWS] + T.s[S_ROWOFF][(lmn + 1) * T.nb + band];
}

__device__ __forceinline__ uint32_t Utab(const Tabs &T, int k, int n) {
    return (uint32_t)T.s[S_U][k * T.ucols + n];
}

__device__ __forceinline__ uint32_t Vtab(const Tabs &T, int k, int n) {
    return (uint32_t)T.s[S_V][k * T.ucols + n];
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

// _tree_sum order (pairs (0,1), (2,3), ...; an odd last one carried)
__device__ float tree_sum(float *v, int n) {
    while (n > 1) {
        int m = n >> 1;
        for (int i = 0; i < m; i++) v[i] = v[2 * i] + v[2 * i + 1];
        if (n & 1) {
            v[m] = v[n - 1];
            n = m + 1;
        } else {
            n = m;
        }
    }
    return v[0];
}

// ----------------------------------------------------------- range encoder
// The deferred-carry encoder of ops/rc_enc_kernel.py: 9-bit digits and
// end-window bytes into per-thread buffers; appends past a buffer's end
// are dropped (the lane is then flagged at the end).  A dry encoder only
// tracks rng and nbits_total (the exact tell) and writes nothing.
struct Enc {
    uint32_t rng, val, end_window;
    int ndigits, nend, nend_bits, nbits_total;
    bool dry;
    uint16_t *dig;
    uint8_t *endb;
};

__device__ void enc_init(Enc &e, uint16_t *dig, uint8_t *endb) {
    e.rng = CODE_TOP;
    e.val = 0;
    e.end_window = 0;
    e.ndigits = e.nend = e.nend_bits = 0;
    e.nbits_total = 33;
    e.dry = false;
    e.dig = dig;
    e.endb = endb;
}

__device__ void enc_normalize(Enc &e) {
    for (int t = 0; t < 3 && e.rng <= CODE_BOT; t++) {
        if (!e.dry) {
            if (e.ndigits < DCAP) e.dig[e.ndigits] = (uint16_t)(e.val >> 23);
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
                if (e.nend < ECAP) e.endb[e.nend] = (uint8_t)(e.end_window & 255u);
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
    for (int t = 0; t < 2; t++) {
        if (l > 0) {
            if (e.ndigits < DCAP) e.dig[e.ndigits] = (uint16_t)(end >> 23);
            e.ndigits++;
            end = (end << 8) & (CODE_TOP - 1);
        }
        l -= 8;
    }
}

// Carry resolution + byte assembly (rc_enc_kernel.finalize): whole bytes
// left in the end window go to the end buffer; digits resolve last to
// first; the stream is the resolved digits from the front, the end bytes
// from the back and the window's leftover bits before them.  Returns the
// error flag (digits and end bytes do not fit).
__device__ int enc_finalize(Enc &e, uint8_t *out, int nbytes) {
    uint32_t window = e.end_window;
    int used = e.nend_bits, nend = e.nend;
    for (int t = 0; t < 4; t++) {
        if (used >= 8) {
            if (nend < ECAP) e.endb[nend] = (uint8_t)(window & 255u);
            nend++;
            window >>= 8;
            used -= 8;
        }
    }
    int nd = imin(e.ndigits, DCAP);
    int carry = 0;
    for (int j = nd - 1; j >= 0; j--) {
        int v = (int)e.dig[j] + carry;
        e.dig[j] = (uint16_t)(v & 255);
        carry = (v >> 8) & 1;
    }
    int lpos = nbytes - nend - 1;
    for (int pos = 0; pos < nbytes; pos++) {
        int byte = pos < e.ndigits ? (int)e.dig[pos] : 0;
        int ti = nbytes - 1 - pos;
        if (ti < nend && ti < ECAP) byte |= e.endb[ti];
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
        const int32_t *lap = T.s[S_LAP] + T.s[S_LAPOFF][2 * chain];
        int big_l = T.s[S_LAPOFF][2 * chain + 1];
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

// _quant_coarse_impl (quant_bands.c:156), mono, one active lane.  Returns
// the badness; writes the new energy memory and the error.
__device__ int coarse_impl(Enc &e, const Tabs &T, const float *x,
                           const float *old_e, float *new_old, float *err,
                           int budget, int tell0, int intra, float max_decay) {
    const int nb = T.nb, lm = T.lm;
    const float coef = intra ? 0.0f : PRED_COEF[lm];
    const float beta = intra ? BETA_INTRA : BETA_COEF[lm];
    const int32_t *pm = T.s[S_EPROB] + intra * 42;
    if (tell0 + 3 <= budget) enc_bit_logp(e, intra, 3);
    float prev = 0.0f;
    int badness = 0;
    for (int i = 0; i < nb; i++) {
        float old = fmaxf(-9.0f, old_e[i]);
        float f = x[i] - coef * old - prev;
        int qi = (int)floorf(0.5f + f);
        float decay_bound = fmaxf(-28.0f, old_e[i]) - max_decay;
        if (qi < 0 && x[i] < decay_bound)
            qi = imin(qi + (int)(decay_bound - x[i]), 0);
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
        err[i] = f - (float)qi;
        badness += qi0 > qi ? qi0 - qi : qi - qi0;
        float q = (float)qi;
        new_old[i] = coef * old + prev + q;
        prev = prev + q - beta * q;
    }
    return badness;
}

// quant_coarse_energy (quant_bands.c:260): dry intra and inter trials,
// then the picked pass for real.  Returns pick_intra.
__device__ int coarse_energy(Enc &e, const Tabs &T, const float *x,
                             const float *old_in, float *old_e, float *err,
                             int budget, int nbytes, float &delayed_intra) {
    const int nb = T.nb, lm = T.lm;
    float tmp[NB_MAX], tmp_err[NB_MAX];
    for (int i = 0; i < nb; i++) {
        float d = (x[i] - old_in[i]) * (x[i] - old_in[i]);
        tmp[i] = fminf(d, 200.0f);
    }
    float new_distortion = fminf(tree_sum(tmp, nb), 200.0f);
    int tell0 = enc_tell(e);
    int two_pass = tell0 + 3 <= budget;
    float max_decay = fminf(16.0f, (float)(0.125 * nbytes));
    int bad1 = 0, tf1 = 0;
    Enc d1 = e;
    d1.dry = true;
    if (two_pass)
        bad1 = coarse_impl(d1, T, x, old_in, tmp, tmp_err, budget, tell0, 1,
                           max_decay);
    tf1 = enc_tell_frac(d1);
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
__device__ void tf_encode(Enc &e, const Tabs &T, const int *tf_res,
                          int tf_select, int tr, int budget, int *tf_vals) {
    const int nb = T.nb, lm = T.lm;
    int tell = enc_tell(e);
    int logp0 = tr ? 2 : 4;
    int rsv = lm > 0 && tell + logp0 + 1 <= budget;
    budget -= rsv;
    int curr = 0, changed = 0;
    int out[NB_MAX];
    for (int i = 0; i < nb; i++) {
        int logp = i == 0 ? logp0 : (tr ? 4 : 5);
        if (tell + logp <= budget) {
            enc_bit_logp(e, tf_res[i] ^ curr, logp);
            tell = enc_tell(e);
            curr = tf_res[i];
        }
        out[i] = curr;
        changed |= curr;
    }
    const int *tab = TF_SELECT_TABLE[lm];
    int t4 = 4 * tr;
    if (rsv && tab[t4 + changed] != tab[t4 + 2 + changed])
        enc_bit_logp(e, tf_select, 1);
    else
        tf_select = 0;
    for (int i = 0; i < nb; i++) tf_vals[i] = tab[t4 + 2 * tf_select + out[i]];
}

__device__ __forceinline__ int alloc_col(const Tabs &T, int j, int v) {
    const int32_t *eB = T.s[S_EBANDS];
    int w = eB[j + 1] - eB[j];
    return (w * T.s[S_ALLOCV][v * T.nb + j]) << T.lm >> 2;
}

// compute_allocation + interp_bits2pulses, mono encode (rate.c:535/249),
// as celt_enc_fused._compute_allocation_enc.  Returns coded_bands.
__device__ int compute_allocation(Enc &e, const Tabs &T, const int *offsets,
                                  int trim, int total, int prev_cb,
                                  int &balance_out, int *bits, int *ebits,
                                  int *fine_priority) {
    const int nb = T.nb, lm = T.lm, nv = T.nv;
    const int32_t *eB = T.s[S_EBANDS];
    const int32_t *caps = T.s[S_CAPS];
    const int32_t *logN = T.s[S_LOGN];
    const int alloc_floor = 1 << BITRES;
    int thresh[NB_MAX], trim_off[NB_MAX], bits1[NB_MAX], bits2[NB_MAX];
    total = imax(total, 0);
    int skip_rsv = total >= (1 << BITRES) ? 1 << BITRES : 0;
    total -= skip_rsv;
    for (int j = 0; j < nb; j++) {
        int w = eB[j + 1] - eB[j];
        thresh[j] = imax((3 * w << lm << BITRES) >> 4, 1 << BITRES);
        int t = (w * (trim - 5 - lm) * (nb - 1 - j) * (1 << (lm + BITRES)))
            >> 6;
        if ((w << lm) == 1) t -= 1 << BITRES;
        trim_off[j] = t;
    }
    int lo = 1, hi = nv - 1;
    for (int it = 0; it < 6; it++) {
        int go = lo <= hi;
        int mid = (lo + hi) >> 1;
        int psum = 0, done = 0;
        int midc = mid < 0 ? 0 : (mid > nv - 1 ? nv - 1 : mid);
        for (int j = nb - 1; j >= 0; j--) {
            int bj = alloc_col(T, j, midc);
            if (bj > 0) bj = imax(bj + trim_off[j], 0);
            bj += offsets[j];
            int use = bj >= thresh[j] || done;
            psum += use ? imin(bj, caps[j])
                        : (bj >= (1 << BITRES) ? 1 << BITRES : 0);
            done |= use;
        }
        int over = psum > total;
        if (go && over) hi = mid - 1;
        if (go && !over) lo = mid + 1;
    }
    int hi_f = lo, lo_f = lo - 1;
    int skip_start = 0;
    int loc = lo_f < 0 ? 0 : (lo_f > nv - 1 ? nv - 1 : lo_f);
    int hic = hi_f < 0 ? 0 : (hi_f > nv - 1 ? nv - 1 : hi_f);
    for (int j = 0; j < nb; j++) {
        int b1 = alloc_col(T, j, loc);
        int b2 = hi_f >= nv ? caps[j] : alloc_col(T, j, hic);
        if (b1 > 0) b1 = imax(b1 + trim_off[j], 0);
        if (b2 > 0) b2 = imax(b2 + trim_off[j], 0);
        if (lo_f > 0) b1 += offsets[j];
        b2 += offsets[j];
        if (offsets[j] > 0) skip_start = j;
        bits1[j] = b1;
        bits2[j] = imax(b2 - b1, 0);
    }

    // ---- interp_bits2pulses ----
    lo = 0;
    hi = 1 << ALLOC_STEPS;
    for (int it = 0; it < ALLOC_STEPS; it++) {
        int mid = (lo + hi) >> 1;
        int psum = 0, done = 0;
        for (int j = nb - 1; j >= 0; j--) {
            int tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS);
            int use = tmp >= thresh[j] || done;
            psum += use ? imin(tmp, caps[j])
                        : (tmp >= alloc_floor ? alloc_floor : 0);
            done |= use;
        }
        if (psum > total) hi = mid;
        else lo = mid;
    }
    int psum = 0, done = 0;
    for (int j = nb - 1; j >= 0; j--) {
        int tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS);
        int low = tmp < thresh[j] && !done;
        int tmp2 = low ? (tmp >= alloc_floor ? alloc_floor : 0) : tmp;
        done |= !low;
        bits[j] = imin(tmp2, caps[j]);
        psum += bits[j];
    }
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
        int band_bits = bits[j] + percoeff * band_width + rem;
        int th = imax(thresh[j], alloc_floor + (1 << BITRES));
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
        psum = psum - bits[j] + keep;
        bits[j] = keep;
        coded--;
    }
    if (forced_stop) total += skip_rsv;

    int left = total - psum;
    int den = imax(eB[coded] - eB[0], 1);
    int percoeff = floordiv(left, den);
    left -= den * percoeff;
    for (int j = 0; j < coded; j++) bits[j] += percoeff * (eB[j + 1] - eB[j]);
    for (int j = 0; j < coded; j++) {
        int take = imin(left, eB[j + 1] - eB[j]);
        bits[j] += take;
        left -= take;
    }
    int balance = 0;
    const int log_m = lm << BITRES;
    for (int j = 0; j < nb; j++) {
        int n = (eB[j + 1] - eB[j]) << lm;
        int in_c = j < coded;
        int bitj = bits[j] + balance;
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
        int unc_eb = bits[j] >> BITRES;
        ebits[j] = in_c ? eb2 : unc_eb;
        fine_priority[j] = in_c ? fp : unc_eb < 1;
        bits[j] = in_c ? bj : 0;
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
    int pulse_cap = T.s[S_LOGN][band] + lm2 * (1 << BITRES);
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

// exp_rotation direction=+1 (vq.c:104): the stride-1 pass with (c, -s),
// then the stride2 pass with (s, -c); cos/sin from the table.
__device__ void exp_rotation_enc(const Tabs &T, float *x, int n, int sv,
                                 int k, int spread) {
    if (spread == 0 || 2 * k >= n || n < sv) return;
    const float *cs = T.f + T.s[S_ROTOFF][n] + (spread * (MAX_K + 1) + k) * 2;
    float c = cs[0], s = cs[1];
    int stride2 = 0;
    if (n >= 8 * sv) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * sv + (sv >> 2) < n) stride2++;
    }
    int len = n / sv;
    for (int seg = 0; seg < sv; seg++) {
        exp_rotation1(x + seg * len, len, 1, c, -s);
        if (stride2) exp_rotation1(x + seg * len, len, stride2, s, -c);
    }
}

// op_pvq_search (vq.c:205): projection, then one pulse at a time (first
// index of the maximum).  iy gets the signed pulses.
__device__ void pvq_search(const float *x, int n, int k, int kcap, int *iy,
                           float *xa, float *scratch, int &evals) {
    for (int j = 0; j < n; j++) {
        xa[j] = fabsf(x[j]);
        scratch[j] = xa[j];
    }
    float sum = tree_sum(scratch, n);
    int proj = k > (n >> 1);
    if (proj && !(sum > 1e-15f && sum < 64.0f)) {
        for (int j = 0; j < n; j++) xa[j] = j == 0 ? 1.0f : 0.0f;
        sum = 1.0f;
    }
    int isum = 0;
    if (proj) {
        float rcp = ((float)k + 0.8f) / sum;
        for (int j = 0; j < n; j++) {
            iy[j] = (int)floorf(rcp * xa[j]);
            isum += iy[j];
        }
    } else {
        for (int j = 0; j < n; j++) iy[j] = 0;
    }
    for (int j = 0; j < n; j++) scratch[j] = (float)(iy[j] * iy[j]);
    float yy = tree_sum(scratch, n);
    for (int j = 0; j < n; j++) scratch[j] = xa[j] * (float)iy[j];
    float xy = tree_sum(scratch, n);
    int pulses_left = proj ? k - isum : k;
    if (pulses_left > n + 3) {
        float tmpf = (float)pulses_left;
        yy = yy + tmpf * tmpf + tmpf * 2.0f * (float)iy[0];
        iy[0] += pulses_left;
        pulses_left = 0;
    }
    int cap = imin(kcap, n + 3);
    for (int t = 0; t < cap && t < pulses_left; t++) {
        float yy1 = yy + 1.0f;
        evals += n;
        int best = 0;
        float best_s = 0.0f;
        for (int j = 0; j < n; j++) {
            float rxy = xy + xa[j];
            float score = (rxy * rxy) / (yy1 + 2.0f * (float)iy[j]);
            if (j == 0 || score > best_s) {
                best_s = score;
                best = j;
            }
        }
        xy = xy + xa[best];
        yy = yy1 + 2.0f * (float)iy[best];
        iy[best]++;
    }
    for (int j = 0; j < n; j++)
        if (x[j] < 0) iy[j] = -iy[j];
}

// icwrs (cwrs.c:444) + ec_enc_uint(idx, V(n, k))
__device__ void encode_pulses(Enc &e, const Tabs &T, const int *iy, int n,
                              int k, int kcap) {
    int kc = imin(kcap + 2, T.urows - 1);
    uint32_t idx = iy[n - 1] < 0;
    int t_incl = iy[n - 1] < 0 ? -iy[n - 1] : iy[n - 1];
    for (int j = n - 2; j >= 0; j--) {
        int s_excl = t_incl;
        t_incl += iy[j] < 0 ? -iy[j] : iy[j];
        int nj = n - j;
        idx += Utab(T, imin(s_excl, kc), nj);
        if (iy[j] < 0) idx += Utab(T, imin(t_incl + 1, kc), nj);
    }
    enc_uint(e, idx, Vtab(T, imin(k, kcap), n));
}

// ------------------------------------------------------------ band tree
// quant_partition encode over one band's static split tree, preorder,
// with an explicit stack: only nodes this stream reaches are visited (a
// child exists where its parent split).  xw is the band's window; split
// nodes swap its halves in place when the side is coded first.
struct Node {
    int dd, off, isv1;
};

__device__ void band_tree(Enc &e, const Tabs &T, int band, int n_root,
                          float *xw, int &rb, int spread, int bb_root,
                          int b_band, int avoid, float *xs, float *xa,
                          float *scratch, int *iy, int &evals) {
    const int lm = T.lm;
    int st_swap[STACK], st_mbits[STACK], st_sbits[STACK], st_itheta[STACK],
        st_rb0[STACK];
    Node stack[STACK];
    int top = 0;
    stack[top++] = Node{0, 0, 0};
    while (top > 0) {
        Node nd_ = stack[--top];
        const int dd = nd_.dd, off = nd_.off;
        const int nd = n_root >> dd;
        const int lmd = lm - dd;
        int bb = bb_root;
        for (int t = 0; t < dd; t++) bb = (bb + 1) >> 1;
        int b;
        if (dd == 0) {
            b = b_band;
        } else {
            const int p = dd - 1;
            const int swap = st_swap[p];
            const int b_v0 = swap ? st_sbits[p] : st_mbits[p];
            if (nd_.isv1) {
                int rebalance = b_v0 - (st_rb0[p] - rb);
                int anchor = swap ? 16384 : 0;
                int extra = (rebalance > (3 << BITRES)
                             && st_itheta[p] != anchor)
                    ? rebalance - (3 << BITRES) : 0;
                b = (swap ? st_mbits[p] : st_sbits[p]) + extra;
            } else {
                b = b_v0;
            }
        }
        const int32_t *row = cache_row(T, lmd, band);
        const int L = row[0];
        if (lmd != -1 && nd > 2 && b > row[L] + 12) {
            const int n2 = nd >> 1;
            for (int j = 0; j < n2; j++) scratch[j] = xw[off + j] * xw[off + j];
            float emid = tree_sum(scratch, n2) + 1e-15f;
            for (int j = 0; j < n2; j++)
                scratch[j] = xw[off + n2 + j] * xw[off + n2 + j];
            float eside = tree_sum(scratch, n2) + 1e-15f;
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
            st_swap[dd] = swap;
            st_mbits[dd] = mbits;
            st_sbits[dd] = sbits;
            st_itheta[dd] = itheta;
            st_rb0[dd] = rb;
            if (swap) {
                for (int j = 0; j < n2; j++) {
                    float t = xw[off + j];
                    xw[off + j] = xw[off + n2 + j];
                    xw[off + n2 + j] = t;
                }
            }
            stack[top++] = Node{dd + 1, off + n2, 1};
            stack[top++] = Node{dd + 1, off, 0};
            continue;
        }
        // ---- leaf: bits -> pulses -> rotate / search / index ----
        const int bm1 = b - 1;
        int lo = 0, c_fit = 0;
        for (int r = 1; r <= L; r++) {
            lo += bm1 > row[r];
            c_fit += rb >= row[r] + 1;
        }
        const int hi = imin(lo + 1, L);
        const int lo_val = lo == 0 ? -1 : row[lo];
        int q = (bm1 - lo_val <= row[hi] - bm1) ? lo : hi;
        q = imax(imin(q, imax(c_fit, 0)), 0);
        if (q > 0) rb -= row[q] + 1;
        const int kq = q < 8 ? q : (8 + (q & 7)) << imax((q >> 3) - 1, 0);
        if (kq != 0) {
            const int kcap = T.s[S_KCAP][band * (lm + 2) + dd];
            for (int j = 0; j < nd; j++) xs[j] = xw[off + j];
            exp_rotation_enc(T, xs, nd, bb, kq, spread);
            pvq_search(xs, nd, kq, kcap, iy, xa, scratch, evals);
            encode_pulses(e, T, iy, nd, kq, kcap);
        }
    }
}

// ------------------------------------------------------------ the kernel
__global__ void __launch_bounds__(32)
celt_enc_frame_kernel(const float *__restrict__ X_t,
                      const float *__restrict__ fin,
                      const int32_t *__restrict__ iin,
                      const int32_t *__restrict__ itab,
                      const float *__restrict__ ftab, uint8_t *payload,
                      float *fout, int32_t *iout, int B, int nbytes) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= B) return;
    const Tabs T = load_tabs(itab, ftab);
    const int nb = T.nb, lm = T.lm;
    const int M = 1 << lm;
    const int32_t *eB = T.s[S_EBANDS];

    // ---- inputs: fin [2nb+1, B] f32, iin [7 + 2nb, B] i32 ----
    float ble_b[NB_MAX], old_in[NB_MAX], old_e[NB_MAX], err[NB_MAX];
    int tf_res[NB_MAX], offsets_cnt[NB_MAX];
    for (int i = 0; i < nb; i++) {
        ble_b[i] = fin[i * B + lane];
        old_in[i] = fin[(nb + i) * B + lane];
    }
    float delayed_intra = fin[2 * nb * B + lane];
    const int silence = iin[0 * B + lane] != 0;
    const int tr = iin[1 * B + lane] != 0;
    const int tf_select_in = iin[2 * B + lane];
    const int spread_calc = iin[3 * B + lane];
    const int trim_calc = iin[4 * B + lane];
    const int prev_cb = iin[5 * B + lane];
    const int consec_transient = iin[6 * B + lane];
    for (int i = 0; i < nb; i++) {
        tf_res[i] = iin[(7 + i) * B + lane];
        offsets_cnt[i] = iin[(7 + nb + i) * B + lane];
    }

    uint16_t dig[DCAP];
    uint8_t endb[ECAP];
    Enc e;
    enc_init(e, dig, endb);
    const int total_bits = nbytes * 8;
    const int budget = total_bits;

    // ---- header: silence, postfilter off, transient ----
    enc_bit_logp(e, silence, 15);
    if (silence) e.nbits_total += total_bits - enc_tell(e);
    if (enc_tell(e) + 16 <= total_bits) enc_bit_logp(e, 0, 1);
    if (lm > 0 && enc_tell(e) + 3 <= total_bits) enc_bit_logp(e, tr, 3);

    // ---- coarse energy ----
    const int pick_intra = coarse_energy(e, T, ble_b, old_in, old_e, err,
                                         budget, nbytes, delayed_intra);

    // ---- tf ----
    int tf_vals[NB_MAX];
    tf_encode(e, T, tf_res, tf_select_in, tr, budget, tf_vals);

    // ---- spread ----
    const int can_sp = enc_tell(e) + 4 <= total_bits;
    const int use_calc = can_sp && !tr && nbytes >= 10;
    const int spread = use_calc ? spread_calc : 2;
    if (can_sp) enc_icdf(e, spread, SPREAD_ICDF, 4, 5);

    // ---- dynalloc boosts ----
    int offsets[NB_MAX];
    int dyn_logp = 6;
    const int total_bits8 = total_bits << BITRES;
    int total_boost = 0;
    int tell_frac = enc_tell_frac(e);
    for (int i = 0; i < nb; i++) {
        int width = (eB[i + 1] - eB[i]) << lm;
        int quanta = imin(width << BITRES, imax(6 << BITRES, width));
        int cap_i = T.s[S_CAPS][i];
        int dlp = dyn_logp, boost = 0, coded_any = 0;
        for (int j = 0; j <= cap_i / quanta; j++) {
            if (!(tell_frac + (dlp << BITRES) < total_bits8 - total_boost
                  && boost < cap_i))
                break;
            int flag = j < offsets_cnt[i];
            enc_bit_logp(e, flag, dlp);
            tell_frac = enc_tell_frac(e);
            if (!flag) break;
            boost += quanta;
            total_boost += quanta;
            dlp = 1;
            coded_any = 1;
        }
        if (coded_any) dyn_logp = imax(2, dyn_logp - 1);
        offsets[i] = boost;
    }

    // ---- trim ----
    int trim = 5;
    if (tell_frac + (6 << BITRES) <= total_bits8 - total_boost) {
        trim = trim_calc;
        enc_icdf(e, trim, TRIM_ICDF, 11, 7);
    }
    tell_frac = enc_tell_frac(e);

    // ---- allocation + fine energy ----
    int bits = total_bits8 - tell_frac - 1;
    const int anti_rsv = (tr && lm >= 2 && bits >= ((lm + 2) << BITRES))
        ? 1 << BITRES : 0;
    bits -= anti_rsv;
    int pulses[NB_MAX], ebits[NB_MAX], fine_priority[NB_MAX];
    int balance;
    const int coded_bands = compute_allocation(e, T, offsets, trim, bits,
                                               prev_cb, balance, pulses,
                                               ebits, fine_priority);
    for (int i = 0; i < nb; i++) {
        if (!(ebits[i] > 0 && enc_tell(e) + ebits[i] <= total_bits)) continue;
        int ex = 1 << imin(imax(ebits[i], 0), MAX_FINE_BITS);
        float extra = (float)ex;
        int q2 = (int)floorf((err[i] + 0.5f) * extra);
        q2 = imin(imax(q2, 0), ex - 1);
        enc_bits(e, (uint32_t)q2, ebits[i]);
        float offs = ((float)q2 + 0.5f) * pow2neg(ebits[i]) - 0.5f;
        old_e[i] = old_e[i] + offs;
        err[i] = err[i] - offs;
    }

    // ---- PVQ bands ----
    float xin[NMAX], xw[NMAX], xs[NMAX], xa[NMAX], scratch[NMAX];
    int iy[NMAX];
    const int total_bits8b = nbytes * (8 << BITRES) - anti_rsv;
    int evals = 0;
    const int32_t *ewidx = T.s[S_EWIDX];
    for (int i = 0; i < nb; i++) {
        const int n = M * (eB[i + 1] - eB[i]);
        const int base = M * eB[i];
        const int tell = enc_tell_frac(e);
        if (i != 0) balance -= tell;
        const int remaining = total_bits8b - tell - 1;
        const int den = imin(imax(coded_bands - i, 1), 3);
        const int curr_balance = balance / den;        // C truncation
        int b = 0;
        if (i <= coded_bands - 1) {
            b = imin(remaining + 1, pulses[i] + curr_balance);
            b = b < 0 ? 0 : (b > 16383 ? 16383 : b);
        }
        for (int j = 0; j < n; j++) xin[j] = X_t[(size_t)(base + j) * B + lane];
        const int32_t *var = T.s[S_VAR] + i * NVAR * 4;
        int bb_root = 0, ewoff = -1;
        for (int v = 0; v < NVAR && var[4 * v] >= 0; v++) {
            if (var[4 * v] == tr && var[4 * v + 1] == tf_vals[i]) {
                bb_root = var[4 * v + 2];
                ewoff = var[4 * v + 3];
            }
        }
        if (ewoff < 0) {
            for (int j = 0; j < n; j++) xw[j] = xin[j];
        } else {
            for (int c = 0; c < n; c++) {
                const int32_t *ix = ewidx + (size_t)(ewoff + c) * EW_SLOTS;
                const float *cf = T.f + (size_t)(ewoff + c) * EW_SLOTS;
                float acc = 0.0f;
                for (int s = 0; s < EW_SLOTS; s++)
                    acc = fmaf(xin[ix[s]], cf[s], acc);
                xw[c] = acc;
            }
        }
        int rb = remaining;
        band_tree(e, T, i, n, xw, rb, spread, bb_root, b,
                  i == 0 ? tr : 0, xs, xa, scratch, iy, evals);
        balance += pulses[i] + tell;
    }

    // ---- anti-collapse flag ----
    if (anti_rsv > 0) enc_bits(e, consec_transient < 2, 1);

    // ---- energy finalise + done ----
    int bits_left = total_bits - enc_tell(e);
    for (int prio = 0; prio < 2; prio++) {
        for (int i = 0; i < nb; i++) {
            if (!(bits_left >= 1 && ebits[i] < MAX_FINE_BITS
                  && fine_priority[i] == prio))
                continue;
            int q2 = err[i] >= 0;
            enc_bits(e, (uint32_t)q2, 1);
            err[i] = err[i] - ((float)q2 - 0.5f) * pow2neg(ebits[i] + 1);
            bits_left--;
        }
    }
    enc_done(e);
    const int error = enc_finalize(e, payload + (size_t)lane * nbytes,
                                   nbytes);

    // ---- outputs: fout [2nb+1, B], iout [8, B]: INT_OUT, rng, error and
    // the count of pulse-search score evaluations (for the op bound) ----
    for (int i = 0; i < nb; i++) {
        fout[i * B + lane] = old_e[i];
        fout[(nb + i) * B + lane] = err[i];
    }
    fout[2 * nb * B + lane] = delayed_intra;
    iout[0 * B + lane] = pick_intra;
    iout[1 * B + lane] = coded_bands;
    iout[2 * B + lane] = spread;
    iout[3 * B + lane] = can_sp;
    iout[4 * B + lane] = use_calc;
    iout[5 * B + lane] = (int32_t)e.rng;
    iout[6 * B + lane] = error;
    iout[7 * B + lane] = evals;
}

}  // namespace

extern "C" int opus_celt_enc_frame_launch(
    const void *X_t, const void *fin, const void *iin, const void *itab,
    const void *ftab, void *payload, void *fout, void *iout, int B,
    int nbytes, void *stream) {
    if (B <= 0) return 0;
    if (nbytes <= 0 || nbytes > MAX_BYTES) return (int)cudaErrorInvalidValue;
    const int threads = 32;
    celt_enc_frame_kernel<<<(B + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
        (const float *)X_t, (const float *)fin, (const int32_t *)iin,
        (const int32_t *)itab, (const float *)ftab, (uint8_t *)payload,
        (float *)fout, (int32_t *)iout, B, nbytes);
    return (int)cudaGetLastError();
}
