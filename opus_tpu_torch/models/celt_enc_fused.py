"""Mono CBR CELT encoder pieces on [B] lanes in plain torch: the analysis
front end and the plan stages of the encode symbol pass.

Port of ``opus_tpu/models/celt_enc_fused.py`` (tables, DSP front end,
transient / dynalloc / tf / spreading / trim analysis, the Laplace and
coarse-energy encoders, tf encode, the allocation with encode-side skip
decisions, fine energy and energy finalise).  Every lane is one stream;
integers are int64 tensors, floats float32, uint32 wrap is emulated with
``& 0xFFFFFFFF``.  Per-band values are lists of [B] lanes, as in the JAX
module, so each line can be held against its counterpart.

The JAX module rebinds a module-level coder (``V``) to run its plan
functions on either range encoder; here the coder is an explicit first
argument (``ops.rc_enc_kernel.VK``).  Float ops keep the JAX twin's order
(separate multiplies and adds, ``_tree_sum`` pairings), because a float
difference in the symbol pass flips an integer decision.

Scope: mono, CBR, prefilter off, 48 kHz, complexity >= 5 semantics.
Reference: celt_encode_with_ec celt/celt_encoder.c:1726,
transient_analysis :267, dynalloc_analysis :1049, tf_analysis :663,
quant_coarse_energy celt/quant_bands.c:260, spreading_decision
celt/bands.c:470, interp_bits2pulses celt/rate.c:249,
ec_laplace_encode celt/laplace.c:51.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..celt.tables import E_MEANS, E_PROB_MODEL, _INV_TABLE
from ..ops.device_cache import const
from ..ops.mdct import _forward_basis
from .celt_dec_fused import (DecTabs, _haar1_arr, _lut, BITRES,
                             MAX_FINE_BITS, FINE_OFFSET, ALLOC_STEPS,
                             SPREAD_NONE, SPREAD_NORMAL, SPREAD_AGGRESSIVE,
                             PRED_COEF, BETA_COEF, BETA_INTRA,
                             SMALL_ENERGY_ICDF, TF_SELECT_TABLE)

PREEMPH = 0.85
SIG_SCALE = 32768.0
EPSILON = 1e-15

i64 = torch.int64
f32 = torch.float32


def _tree_sum(parts):
    """Pairwise sum in the JAX package's ``_tree_sum`` order."""
    parts = list(parts)
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _tree_sum_cols(x):
    """``_tree_sum`` over the columns of x [B, n]."""
    while x.shape[1] > 1:
        m = x.shape[1] // 2
        nxt = x[:, 0:2 * m:2] + x[:, 1:2 * m:2]
        if x.shape[1] % 2:
            nxt = torch.cat([nxt, x[:, -1:]], dim=1)
        x = nxt
    return x[:, 0]


# ===================================================================== #
# static tables                                                         #
# ===================================================================== #

@lru_cache(maxsize=None)
def _laplace_chain(fs0: int, decay: int):
    """Static (fl, fs) chains of ec_laplace_encode's magnitude walk
    (laplace.c:51): fl/fs after the while loop when it stops at i."""
    fl = fs0
    fs = ((32768 - 2 * 16 - fs0) * (16384 - decay)) >> 15
    fls = [0, fl]
    fss = [fs0, fs]
    i = 1
    while fs > 0:
        fs *= 2
        fl += fs + 2
        fs = (fs * decay) >> 15
        i += 1
        fls.append(fl)
        fss.append(fs)
    return tuple(fls), tuple(fss), i


@lru_cache(maxsize=None)
def _transient_tabs(n: int):
    """transient_analysis's 2-state masking filter as a Toeplitz operator
    (y = x @ toep)."""
    h = np.zeros(n, np.float64)
    m0 = m1 = 0.0
    for t in range(n):
        x = 1.0 if t == 0 else 0.0
        h[t] = m0 + x
        m00 = m0
        m0 = m0 - x + .5 * m1
        m1 = x - m00
    toep = np.zeros((n, n), np.float32)
    for t in range(n):
        toep[t, t:] = h[:n - t]
    return toep


@lru_cache(maxsize=None)
def _iir1_toeplitz(n: int, a: float):
    """y[i] = x[i] + a*y[i-1] as a Toeplitz matmul."""
    h = a ** np.arange(n, dtype=np.float64)
    toep = np.zeros((n, n), np.float32)
    for t in range(n):
        toep[t, t:] = h[:n - t]
    return toep


class EncTabs(DecTabs):
    """Static tables of the encoder (extends the decoder's)."""

    def __init__(self, fs: int, frame_size: int):
        super().__init__(fs, frame_size)
        mode = self.mode
        n = frame_size
        ov = mode.overlap
        self.basis_l = _forward_basis(n, ov).astype(np.float32)
        self.basis_s = _forward_basis(mode.shortMdctSize, ov).astype(
            np.float32)
        m = self.M
        nb = self.nb
        bm = np.zeros(n, np.int32)
        msk = np.zeros((n, nb), np.float32)
        for i in range(nb):
            bm[m * self.eBands[i]:m * self.eBands[i + 1]] = i
            msk[m * self.eBands[i]:m * self.eBands[i + 1], i] = 1.0
        self.band_map = bm
        self.band_mask = msk
        self.noise_floor = [
            0.0625 * self.logN[i] + .5 + (9 - 24)      # lsb_depth = 24
            - E_MEANS[i] + .0062 * (i + 5) * (i + 5)
            for i in range(nb)]


def _c(tabs, name, make, device):
    return const(("enc", int(tabs.mode.Fs), tabs.lm, name), make, device)


# ===================================================================== #
# DSP front end                                                         #
# ===================================================================== #

def _encode_dsp(pcm, mem, hist, tabs: EncTabs, clip_mask):
    """Pre-emphasis + long and short MDCT (matmuls against the fixed
    bases) + band energies.  pcm [B, N] in [-1, 1]; returns full [B,
    N+ov], freq_l/freq_s [B, N], be_l/be_s/ble_l/ble_s [B, nb], mem,
    hist."""
    dev = pcm.device
    n = tabs.mode.shortMdctSize << tabs.lm
    nshort = 1 << tabs.lm
    n2s = tabs.mode.shortMdctSize
    ov = tabs.mode.overlap
    b = pcm.shape[0]

    x = pcm * SIG_SCALE
    x = torch.where(clip_mask[:, None], x.clamp(-65536.0, 65536.0), x)
    inp = x - torch.cat([mem[:, None], PREEMPH * x[:, :-1]], dim=1)
    new_mem = PREEMPH * x[:, -1]
    full = torch.cat([hist, inp], dim=1)
    new_hist = full[:, n:]

    basis_l = _c(tabs, "basis_l", lambda: tabs.basis_l, dev)
    freq_l = torch.matmul(full, basis_l)
    if tabs.lm > 0:
        basis_s = _c(tabs, "basis_s", lambda: tabs.basis_s, dev)
        segs = full.unfold(1, n2s + ov, n2s)[:, :nshort]
        spec = torch.matmul(segs, basis_s)
        freq_s = spec.transpose(1, 2).reshape(b, n)
    else:
        freq_s = freq_l
    mask = _c(tabs, "band_mask", lambda: tabs.band_mask, dev)
    means = _c(tabs, "e_means",
               lambda: np.asarray(E_MEANS[:tabs.nb], np.float32), dev)

    def band_e(freq):
        be = torch.sqrt(1e-27 + torch.matmul(freq * freq, mask))
        return be, torch.log2(be) - means

    be_l, ble_l = band_e(freq_l)
    be_s, ble_s = band_e(freq_s)
    return dict(full=full, freq_l=freq_l, freq_s=freq_s, be_l=be_l,
                ble_l=ble_l, be_s=be_s, ble_s=ble_s, mem=new_mem,
                hist=new_hist)


def _transient_analysis(inp, tabs: EncTabs):
    """transient_analysis (celt_encoder.c:267), mono, tone detect off, on
    the [B, N] window after the overlap.  Returns (is_transient [B] bool,
    tf_estimate [B] f32)."""
    dev = inp.device
    n = inp.shape[1]
    len2 = n // 2
    tmp = torch.matmul(inp, _c(tabs, ("tr_toep", n),
                               lambda: _transient_tabs(n), dev))
    tmp = torch.cat([torch.zeros_like(tmp[:, :12]), tmp[:, 12:]], dim=1)
    x2 = tmp[:, 0::2] * tmp[:, 0::2] + tmp[:, 1::2] * tmp[:, 1::2]
    mean = x2.sum(dim=1)
    fdecay = 0.0625                                 # no weak transients
    fwd = torch.matmul(x2, _c(tabs, ("iir1", len2, 1.0 - fdecay),
                              lambda: _iir1_toeplitz(len2, 1.0 - fdecay),
                              dev))
    t2f = fdecay * fwd
    bwd = torch.matmul(t2f.flip(1), _c(tabs, ("iir1", len2, 0.875),
                                       lambda: _iir1_toeplitz(len2, 0.875),
                                       dev)).flip(1)
    t2 = 0.125 * bwd
    max_e = t2.amax(dim=1)
    mean = torch.sqrt(torch.clamp(mean * max_e * 0.5 * len2, min=0.0))
    norm = len2 / (1e-15 + 0.5 * mean) / 2.0
    idxs = torch.arange(12, len2 - 5, 4, device=dev)
    vals = t2[:, idxs]
    tab = _c(tabs, "inv_table", lambda: np.asarray(_INV_TABLE, np.int64),
             dev)
    ti = torch.floor(64.0 * norm[:, None] * (vals + 1e-15)).clamp(
        0, 127).to(i64)
    unmask = tab[ti].sum(dim=1)
    mask_metric = torch.div(64 * unmask * 4, 6 * (len2 - 17),
                            rounding_mode="floor")
    is_transient = mask_metric > 200
    tf_max = torch.clamp(torch.sqrt(torch.clamp(
        27.0 * mask_metric.to(f32), min=0.0)) - 42.0, min=0.0)
    tf_estimate = torch.sqrt(torch.clamp(
        0.0069 * torch.clamp(tf_max, max=163.0) - 0.139, min=0.0))
    return is_transient, tf_estimate


def _patch_transient(ble_l, old_log_e, nb: int):
    """patch_transient_decision (celt_encoder.c:473), mono."""
    spread_old = [old_log_e[0]]
    for i in range(1, nb):
        spread_old.append(torch.maximum(spread_old[i - 1] - 1.0,
                                        old_log_e[i]))
    diffs = [torch.clamp(ble_l[i] - spread_old[i], min=0.0)
             for i in range(2, nb - 1)]
    return _tree_sum(diffs) / len(diffs) > 1.0


# ===================================================================== #
# Laplace + coarse energy                                               #
# ===================================================================== #

def _laplace_encode(vk, e, qi, fs0: int, decay: int, active):
    """ec_laplace_encode with static fs0/decay.  Returns (e, value) —
    the value possibly clamped like the reference."""
    fls, fss, big_l = _laplace_chain(fs0, decay)
    is_zero = qi == 0
    s = torch.where(qi < 0, -1, 0)
    aval = qi.abs()
    i_stop = torch.clamp(aval, max=big_l).clamp(0, big_l)
    fl_i = _lut(fls, i_stop)
    fs_i = _lut(fss, i_stop)
    fs_a = fs_i + 1
    fl_a = fl_i + torch.where(s == 0, fs_a, 0)
    ndi_max = (32768 - fl_i + 1 - 1 - s) >> 1
    di = torch.minimum(aval - big_l, ndi_max - 1)
    fl_b = fl_i + (2 * di + 1 + s)
    fs_b = torch.clamp(32768 - fl_b, max=1)
    val_b = (big_l + di + s) ^ s
    hit_end = aval >= big_l
    fl = torch.where(is_zero, 0, torch.where(hit_end, fl_b, fl_a))
    fs = torch.where(is_zero, fs0, torch.where(hit_end, fs_b, fs_a))
    value = torch.where(is_zero, 0, torch.where(hit_end, val_b, qi))
    e = vk.re_encode_bin(e, fl, fl + fs, 15, active)
    return e, value


def _coarse_impl(vk, e, x_bands, old_e, budget, tell0, pm, coef: float,
                 beta: float, intra_bit, max_decay, nb: int, active):
    """_quant_coarse_impl (quant_bands.c:156), mono.  x_bands/old_e: lists
    of nb [B] f32.  Returns (e, new_old_e, error, badness)."""
    can_bit = active & (tell0 + 3 <= budget)
    e = vk.re_enc_bit_logp(e, intra_bit, 3, can_bit)
    prev = torch.zeros_like(x_bands[0])
    badness = torch.zeros_like(budget)
    new_old = list(old_e)
    error = [None] * nb
    for i in range(nb):
        x = x_bands[i]
        old = torch.clamp(old_e[i], min=-9.0)
        f = x - coef * old - prev
        qi = torch.floor(0.5 + f).to(i64)
        decay_bound = torch.clamp(old_e[i], min=-28.0) - max_decay
        low = (qi < 0) & (x < decay_bound)
        qi = torch.where(low, torch.clamp(
            qi + (decay_bound - x).to(i64), max=0), qi)
        qi0 = qi
        tell = vk.re_tell(e)
        bits_left = budget - tell - 3 * (nb - i)
        tight = (bits_left < 30) if i != 0 else torch.zeros_like(active)
        qi = torch.where(tight & (bits_left < 24), torch.clamp(qi, max=1),
                         qi)
        qi = torch.where(tight & (bits_left < 16), torch.clamp(qi, min=-1),
                         qi)
        big = active & (budget - tell >= 15)
        med = active & ~big & (budget - tell >= 2)
        sml = active & ~big & ~med & (budget - tell >= 1)
        pi = 2 * min(i, 20)
        e, v_big = _laplace_encode(vk, e, qi, int(pm[pi]) << 7,
                                   int(pm[pi + 1]) << 6, big)
        qi_med = qi.clamp(-1, 1)
        sym = (2 * qi_med) ^ -(qi_med < 0).to(i64)
        e = vk.re_enc_icdf(e, sym, SMALL_ENERGY_ICDF, 2, med)
        qi_sml = torch.clamp(qi, max=0)
        e = vk.re_enc_bit_logp(e, -qi_sml, 1, sml)
        qi = torch.where(big, v_big, torch.where(
            med, qi_med, torch.where(sml, qi_sml, -1)))
        error[i] = f - qi.to(f32)
        badness = badness + torch.where(active, (qi0 - qi).abs(), 0)
        q = qi.to(f32)
        tmp = coef * old + prev + q
        new_old[i] = torch.where(active, tmp, old_e[i])
        prev = prev + q - beta * q
    return e, new_old, error, badness


# ===================================================================== #
# dynalloc analysis                                                     #
# ===================================================================== #

def _median3(a, b, c):
    return torch.maximum(torch.minimum(torch.maximum(a, b), c),
                         torch.minimum(a, b))


def _median5(v0, v1, v2, v3, v4):
    t0, t1 = torch.minimum(v0, v1), torch.maximum(v0, v1)
    t3, t4 = torch.minimum(v3, v4), torch.maximum(v3, v4)
    return _median3(torch.maximum(t0, t3), v2, torch.minimum(t1, t4))


def _dynalloc_analysis(ble, ble2, tabs: EncTabs, is_transient,
                       eff_bytes: int):
    """dynalloc_analysis (celt_encoder.c:1049), mono, no tone/analysis/
    surround, vbr=0.  ble/ble2: lists of nb [B] lanes.  Returns (offsets,
    importance, spread_weight (lists of nb int64 lanes), max_depth,
    tot_boost)."""
    nb = tabs.nb
    lm = tabs.lm
    nf = tabs.noise_floor
    depth_terms = [ble[i] - nf[i] for i in range(nb)]
    max_depth = depth_terms[0]
    for i in range(1, nb):
        max_depth = torch.maximum(max_depth, depth_terms[i])
    max_depth = torch.clamp(max_depth, min=-31.9)

    mask = list(depth_terms)
    for i in range(1, nb):
        mask[i] = torch.maximum(mask[i], mask[i - 1] - 2.0)
    for i in range(nb - 2, -1, -1):
        mask[i] = torch.maximum(mask[i], mask[i + 1] - 3.0)
    spread_weight = []
    for i in range(nb):
        smr = depth_terms[i] - torch.maximum(
            torch.clamp(max_depth - 12.0, min=0.0), mask[i])
        shift = (-torch.floor(0.5 + smr).to(i64)).clamp(0, 5)
        spread_weight.append(32 >> shift)

    zi = torch.zeros_like(ble[0], dtype=i64)
    offsets = [zi for _ in range(nb)]
    importance = [zi + 13 for _ in range(nb)]
    tot_boost = zi
    if not eff_bytes >= 30 + 5 * lm:
        return offsets, importance, spread_weight, max_depth, tot_boost

    ble3 = list(ble2)
    f = [None] * nb
    f[0] = ble3[0]
    last = zi
    for i in range(1, nb):
        last = torch.where(ble3[i] > ble3[i - 1] + 0.5, i, last)
        f[i] = torch.minimum(f[i - 1] + 1.5, ble3[i])
    for i in range(nb - 2, -1, -1):
        f[i] = torch.where(i <= last - 1, torch.minimum(
            f[i], torch.minimum(f[i + 1] + 2.0, ble3[i])), f[i])
    offset = 1.0
    lo_med = _median3(ble3[0], ble3[1], ble3[2]) - offset
    hi_med = _median3(ble3[nb - 3], ble3[nb - 2], ble3[nb - 1]) - offset
    for i in range(2, nb - 2):
        f[i] = torch.maximum(f[i], _median5(*ble3[i - 2:i + 3]) - offset)
    f[0] = torch.maximum(f[0], lo_med)
    f[1] = torch.maximum(f[1], lo_med)
    f[nb - 2] = torch.maximum(f[nb - 2], hi_med)
    f[nb - 1] = torch.maximum(f[nb - 1], hi_med)
    for i in range(nb):
        f[i] = torch.clamp(ble[i] - torch.clamp(f[i], min=nf[i]), min=0.0)
        importance[i] = torch.floor(
            0.5 + 13.0 * torch.exp2(torch.clamp(f[i], max=4.0))).to(i64)
        f[i] = torch.where(is_transient, f[i], 0.5 * f[i])
        if i < 8:
            f[i] = f[i] * 2.0
        if i >= 12:
            f[i] = 0.5 * f[i]
    if eff_bytes > 320:
        f[0] = f[0] + min(1.5, 1e-3 * (eff_bytes - 320))
    capped = torch.zeros_like(is_transient)
    capv = (2 * eff_bytes // 3) << BITRES << 3
    for i in range(nb):
        fi = torch.clamp(f[i], max=4.0)
        width = int(tabs.width[i])
        if width < 6:
            boost = fi.to(i64)
            boost_bits = boost * width << BITRES
        elif width > 48:
            boost = (fi * 8.0).to(i64)
            boost_bits = torch.div(boost * width << BITRES, 8,
                                   rounding_mode="floor")
        else:
            boost = (fi * width / 6.0).to(i64)
            boost_bits = boost * 6 << BITRES
        # vbr == 0: cap the total boost at 2/3 of the frame; on the capping
        # band the reference stores the remaining budget in bits
        # (celt_encoder.c:1259), a normative unit mismatch
        over = ((tot_boost + boost_bits) >> BITRES >> 3) > 2 * eff_bytes // 3
        hit = ~capped & over
        offsets[i] = torch.where(capped, 0,
                                 torch.where(hit, capv - tot_boost, boost))
        tot_boost = torch.where(capped, tot_boost, torch.where(
            hit, capv, tot_boost + boost_bits))
        capped = capped | hit
    return offsets, importance, spread_weight, max_depth, tot_boost


def _quanta(width: int):
    return min(width << BITRES, max(6 << BITRES, width))


# ===================================================================== #
# tf analysis + encode                                                  #
# ===================================================================== #

def _l1_vec(x, bias_lm, bias):
    l1 = x.abs().sum(dim=1)
    return l1 + bias_lm * bias * l1


def _tf_analysis(X, tabs: EncTabs, is_transient, tf_estimate, lam: int,
                 importance):
    """tf_analysis (celt_encoder.c:663), mono.  X: [B, Ncoded].  Returns
    (tf_res: list of nb [B] in {0, 1}, tf_select [B])."""
    nb = tabs.nb
    lm = tabs.lm
    m = tabs.M
    bias = 0.04 * torch.clamp(0.5 - tf_estimate, min=-0.25)
    metric = []
    for i in range(nb):
        base = int(tabs.eBands[i]) * m
        n = int(tabs.width[i])
        narrow = int(tabs.eBands[i + 1] - tabs.eBands[i]) == 1
        xs = X[:, base:base + n]
        best_l1_t = _l1_vec(xs, lm, bias)
        best_lv_t = torch.zeros_like(best_l1_t, dtype=i64)
        if not narrow:
            l1 = _l1_vec(_haar1_arr(xs, n >> lm, 1 << lm), lm + 1, bias)
            best_lv_t = torch.where(l1 < best_l1_t, -1, best_lv_t)
            best_l1_t = torch.minimum(l1, best_l1_t)
        tmp = xs
        for k in range(lm):
            tmp = _haar1_arr(tmp, n >> k, 1 << k)
            l1 = _l1_vec(tmp, lm - k - 1, bias)
            best_lv_t = torch.where(l1 < best_l1_t, k + 1, best_lv_t)
            best_l1_t = torch.minimum(l1, best_l1_t)
        best_l1_n = _l1_vec(xs, 0, bias)
        best_lv_n = torch.zeros_like(best_l1_n, dtype=i64)
        tmp = xs
        for k in range(lm if narrow else lm + 1):
            tmp = _haar1_arr(tmp, n >> k, 1 << k)
            l1 = _l1_vec(tmp, k + 1, bias)
            best_lv_n = torch.where(l1 < best_l1_n, k + 1, best_lv_n)
            best_l1_n = torch.minimum(l1, best_l1_n)
        mt = torch.where(is_transient, 2 * best_lv_t, -2 * best_lv_n)
        if narrow:
            mt = mt - ((mt == 0) | (mt == -2 * lm)).to(i64)
        metric.append(mt)

    t4 = 4 * is_transient.to(i64)
    tab = TF_SELECT_TABLE[lm]

    def _viterbi_cost(sel_lanes):
        c0v = _lut(tab, t4 + 2 * sel_lanes)
        c1v = _lut(tab, t4 + 2 * sel_lanes + 1)
        lam_t = torch.where(is_transient, 0, lam)
        cost0 = importance[0] * (metric[0] - 2 * c0v).abs()
        cost1 = importance[0] * (metric[0] - 2 * c1v).abs() + lam_t
        paths0, paths1 = [], []
        for i in range(1, nb):
            from0, from1 = cost0, cost1 + lam
            p0 = (from0 >= from1).to(i64)
            curr0 = torch.minimum(from0, from1)
            from0b, from1b = cost0 + lam, cost1
            p1 = (from0b >= from1b).to(i64)
            curr1 = torch.minimum(from0b, from1b)
            cost0 = curr0 + importance[i] * (metric[i] - 2 * c0v).abs()
            cost1 = curr1 + importance[i] * (metric[i] - 2 * c1v).abs()
            paths0.append(p0)
            paths1.append(p1)
        return cost0, cost1, paths0, paths1

    z = torch.zeros_like(metric[0])
    c0_s0, c1_s0, _, _ = _viterbi_cost(z)
    c0_s1, c1_s1, _, _ = _viterbi_cost(z + 1)
    sel0 = torch.minimum(c0_s0, c1_s0)
    sel1 = torch.minimum(c0_s1, c1_s1)
    tf_select = ((sel1 < sel0) & is_transient).to(i64)
    cost0, cost1, paths0, paths1 = _viterbi_cost(tf_select)
    tf_res = [None] * nb
    tf_res[nb - 1] = (cost0 >= cost1).to(i64)
    for i in range(nb - 2, -1, -1):
        tf_res[i] = torch.where(tf_res[i + 1] == 1, paths1[i], paths0[i])
    return tf_res, tf_select


def _tf_encode(vk, e, tf_res, tf_select, is_transient, tabs: EncTabs,
               total_bits, active):
    """tf_encode (celt_encoder.c:824).  Returns (e, tf values from
    TF_SELECT_TABLE, tf_select)."""
    nb = tabs.nb
    lm = tabs.lm
    budget = total_bits
    tell = vk.re_tell(e)
    logp0 = torch.where(is_transient, 2, 4)
    tf_select_rsv = ((lm > 0) & (tell + logp0 + 1 <= budget)).to(i64)
    budget = budget - tf_select_rsv
    curr = torch.zeros_like(tell)
    tf_changed = torch.zeros_like(tell)
    tf_out = list(tf_res)
    for i in range(nb):
        logp = logp0 if i == 0 else torch.where(is_transient, 4, 5)
        can = active & (tell + logp <= budget)
        e = vk.re_enc_bit_logp(e, tf_out[i] ^ curr, logp, can)
        tell = vk.re_tell(e)
        curr = torch.where(can, tf_out[i], curr)
        tf_out[i] = curr
        tf_changed = tf_changed | curr
    tab = TF_SELECT_TABLE[lm]
    t4 = 4 * is_transient.to(i64)
    differs = _lut(tab, t4 + tf_changed) != _lut(tab, t4 + 2 + tf_changed)
    code_sel = active & (tf_select_rsv != 0) & differs
    e = vk.re_enc_bit_logp(e, tf_select, 1, code_sel)
    tf_select = torch.where(code_sel, tf_select, 0)
    vals = [_lut(tab, t4 + 2 * tf_select + t) for t in tf_out]
    return e, vals, tf_select


# ===================================================================== #
# spreading decision + trim analysis                                    #
# ===================================================================== #

def _spreading_decision(X, tabs: EncTabs, spread_weight, update_hf, state):
    """spreading_decision (bands.c:470), mono.  state: dict of average,
    hf_average, tapset_decision, last_decision ([B] int64).  Returns
    (decision [B], new state)."""
    nb = tabs.nb
    m = tabs.M
    sum_ = torch.zeros_like(state["average"])
    nb_bands = torch.zeros_like(sum_)
    hf_sum = torch.zeros_like(sum_)
    for i in range(nb):
        n = int(tabs.width[i])
        if n <= 8:
            continue
        base = int(tabs.eBands[i]) * m
        seg = X[:, base:base + n]
        x2n = seg * seg * n
        t0 = (x2n < 0.25).sum(dim=1)
        t1 = (x2n < 0.0625).sum(dim=1)
        t2 = (x2n < 0.015625).sum(dim=1)
        if i > nb - 4:
            hf_sum = hf_sum + torch.div(32 * (t1 + t0), n,
                                        rounding_mode="floor")
        tmp = (2 * t2 >= n).to(i64) + (2 * t1 >= n).to(i64) \
            + (2 * t0 >= n).to(i64)
        sum_ = sum_ + tmp * spread_weight[i]
        nb_bands = nb_bands + spread_weight[i]
    new_state = dict(state)
    # end == nb: the divisor c*(4 - nbEBands + end) is 4 (mono)
    hf = torch.where(hf_sum != 0, torch.div(hf_sum, 4, rounding_mode="floor"),
                     hf_sum)
    hf_avg = torch.where(update_hf, (state["hf_average"] + hf) >> 1,
                         state["hf_average"])
    hf2 = hf_avg + torch.where(state["tapset_decision"] == 2, 4, torch.where(
        state["tapset_decision"] == 0, -4, 0))
    tapset = torch.where(hf2 > 22, 2, torch.where(hf2 > 18, 1, 0))
    new_state["hf_average"] = hf_avg
    new_state["tapset_decision"] = torch.where(update_hf, tapset,
                                               state["tapset_decision"])
    s = torch.div(sum_ << 8, nb_bands.clamp_min(1), rounding_mode="floor")
    s = (s + state["average"]) >> 1
    new_state["average"] = s
    s = (3 * s + (((3 - state["last_decision"]) << 7) + 64) + 2) >> 2
    decision = torch.where(s < 80, SPREAD_AGGRESSIVE, torch.where(
        s < 256, SPREAD_NORMAL, torch.where(s < 384, 1, SPREAD_NONE)))
    return decision, new_state


def _alloc_trim_analysis(ble, tabs: EncTabs, tf_estimate, equiv_rate: int):
    """alloc_trim_analysis (celt_encoder.c:865), mono, no analysis."""
    nb = tabs.nb
    if equiv_rate < 64000:
        trim = 4.0
    elif equiv_rate < 80000:
        trim = 4.0 + (1.0 / 16) * ((equiv_rate - 64000) >> 10)
    else:
        trim = 5.0
    diff = _tree_sum([ble[i] * (2 + 2 * i - nb) for i in range(nb - 1)])
    diff = diff / (nb - 1)
    t = trim - torch.clamp((diff + 1.0) / 6.0, -2.0, 2.0)
    t = t - 2.0 * tf_estimate
    return torch.floor(0.5 + t).to(i64).clamp(0, 10)


# ===================================================================== #
# allocation (encode-side skip decisions)                               #
# ===================================================================== #

def _interp_bits2pulses_enc(vk, e, tabs: EncTabs, bits1, bits2, thresh,
                            total, skip_rsv, skip_start, prev_cb, active):
    """interp_bits2pulses, mono encode (rate.c:249).  Returns (e,
    coded_bands, balance, bits, ebits, fine_priority)."""
    nb = tabs.nb
    alloc_floor = 1 << BITRES
    eB = [int(v) for v in tabs.eBands]
    caps = tabs.caps
    signal_bandwidth = nb - 1
    lo = torch.zeros_like(total)
    hi = torch.full_like(total, 1 << ALLOC_STEPS)
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = torch.zeros_like(total)
        done = torch.zeros_like(active)
        for j in range(nb - 1, -1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            use = (tmp >= thresh[j]) | done
            psum = psum + torch.where(use, torch.clamp(tmp, max=caps[j]),
                                      torch.where(tmp >= alloc_floor,
                                                  alloc_floor, 0))
            done = done | use
        over = psum > total
        hi = torch.where(over, mid, hi)
        lo = torch.where(over, lo, mid)
    psum = torch.zeros_like(total)
    done = torch.zeros_like(active)
    bits = [None] * nb
    for j in range(nb - 1, -1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        low = (tmp < thresh[j]) & ~done
        tmp2 = torch.where(low, torch.where(tmp >= alloc_floor, alloc_floor,
                                            0), tmp)
        done = done | ~low
        bits[j] = torch.clamp(tmp2, max=caps[j])
        psum = psum + bits[j]

    coded_bands = torch.full_like(total, nb)
    finished = ~active
    forced_stop = torch.zeros_like(active)
    for j in range(nb - 1, 0, -1):
        is_cur = ~finished & (coded_bands == j + 1) & (j > skip_start)
        at_skip = ~finished & (coded_bands == j + 1) & (j <= skip_start)
        finished = finished | at_skip
        forced_stop = forced_stop | at_skip
        left = total - psum
        den = eB[j + 1] - eB[0]
        percoeff = torch.div(left, den, rounding_mode="floor")
        leftr = left - den * percoeff
        rem = torch.clamp(leftr - (eB[j] - eB[0]), min=0)
        band_width = eB[j + 1] - eB[j]
        band_bits = bits[j] + percoeff * band_width + rem
        th = max(thresh[j], alloc_floor + (1 << BITRES))
        cand = is_cur & (band_bits >= th)
        # encode-side stop decision (rate.c:282-299)
        depth_threshold = torch.where(coded_bands > 17, torch.where(
            j < prev_cb, 7, 9), 0)
        stop_rule = (coded_bands <= 2) | (
            (band_bits > ((depth_threshold * band_width
                           << tabs.lm << BITRES) >> 4))
            & (j <= signal_bandwidth))
        stop = cand & stop_rule
        e = vk.re_enc_bit_logp(e, stop.to(i64), 1, cand)
        finished = finished | stop
        adj = cand & ~stop
        psum = torch.where(adj, psum + (1 << BITRES), psum)
        band_bits = torch.where(adj, band_bits - (1 << BITRES), band_bits)
        cont = is_cur & ~stop
        keep = torch.where(band_bits >= alloc_floor, alloc_floor, 0)
        psum = torch.where(cont, psum - bits[j] + keep, psum)
        bits[j] = torch.where(cont, keep, bits[j])
        coded_bands = torch.where(cont, coded_bands - 1, coded_bands)
    total = total + torch.where(forced_stop, skip_rsv, 0)

    left = total - psum
    den = _lut([eB[c] - eB[0] for c in range(nb + 1)],
               coded_bands.clamp(0, nb)).clamp_min(1)
    percoeff = torch.div(left, den, rounding_mode="floor")
    left = left - den * percoeff
    in_coded = [j < coded_bands for j in range(nb)]
    for j in range(nb):
        bits[j] = bits[j] + torch.where(in_coded[j],
                                        percoeff * (eB[j + 1] - eB[j]), 0)
    for j in range(nb):
        take = torch.clamp(left, max=eB[j + 1] - eB[j])
        bits[j] = bits[j] + torch.where(in_coded[j], take, 0)
        left = torch.where(in_coded[j], left - take, left)

    ebits = [None] * nb
    fine_priority = [None] * nb
    balance = torch.zeros_like(total)
    log_m = tabs.lm << BITRES
    for j in range(nb):
        n = (eB[j + 1] - eB[j]) << tabs.lm
        in_c = in_coded[j]
        bitj = bits[j] + balance
        if n > 1:
            excess = torch.clamp(bitj - caps[j], min=0)
            bj = bitj - excess
            nclogn = n * (tabs.logN[j] + log_m)
            offset = (nclogn >> 1) - n * FINE_OFFSET
            if n == 2:
                offset += n << BITRES >> 2
            off1 = torch.where(
                bj + offset < (n * 2 << BITRES), offset + (nclogn >> 2),
                torch.where(bj + offset < (n * 3 << BITRES),
                            offset + (nclogn >> 3), offset))
            eb_ = torch.clamp(bj + off1 + (n << (BITRES - 1)), min=0)
            eb_ = torch.div(eb_, n, rounding_mode="floor") >> BITRES
            eb_ = torch.where(eb_ > (bj >> BITRES), bj >> BITRES, eb_)
            eb_ = torch.clamp(eb_, max=MAX_FINE_BITS)
            fp = (eb_ * (n << BITRES) >= bj + off1).to(i64)
            bj = bj - (eb_ << BITRES)
        else:
            excess = torch.clamp(bitj - (1 << BITRES), min=0)
            bj = bitj - excess
            eb_ = torch.zeros_like(total)
            fp = torch.ones_like(total)
        has_ex = excess > 0
        extra_fine = torch.minimum(excess >> BITRES, MAX_FINE_BITS - eb_)
        eb2 = eb_ + torch.where(has_ex, extra_fine, 0)
        extra_bits = extra_fine << BITRES
        fp = torch.where(has_ex, (extra_bits >= excess - balance).to(i64), fp)
        excess2 = torch.where(has_ex, excess - extra_bits, excess)
        unc_eb = bits[j] >> BITRES
        ebits[j] = torch.where(in_c, eb2, unc_eb)
        fine_priority[j] = torch.where(in_c, fp, (unc_eb < 1).to(i64))
        bits[j] = torch.where(in_c, bj, 0)
        balance = torch.where(in_c, excess2, balance)
    return e, coded_bands, balance, bits, ebits, fine_priority


def _compute_allocation_enc(vk, e, tabs: EncTabs, offsets, trim, total,
                            prev_cb, active):
    """compute_allocation, mono encode (rate.c:535)."""
    nb = tabs.nb
    eB = tabs.eBands
    total = torch.clamp(total, min=0)
    skip_rsv = torch.where(total >= (1 << BITRES), 1 << BITRES, 0)
    total = total - skip_rsv
    widths = [int(v) for v in (eB[1:] - eB[:-1])]
    thresh = [max((3 * widths[j] << tabs.lm << BITRES) >> 4, 1 << BITRES)
              for j in range(nb)]
    trim_off = []
    for j in range(nb):
        t = (widths[j] * (trim - 5 - tabs.lm) * (nb - 1 - j)
             * (1 << (tabs.lm + BITRES))) >> 6
        if (widths[j] << tabs.lm) == 1:
            t = t - (1 << BITRES)
        trim_off.append(t)
    caps = tabs.caps
    allocV = tabs.allocV
    nv = allocV.shape[0]
    cols = [[int(widths[j] * allocV[v, j]) << tabs.lm >> 2
             for v in range(nv)] for j in range(nb)]

    lo = torch.ones_like(total)
    hi = torch.full_like(total, nv - 1)
    for _ in range(6):
        go = lo <= hi
        mid = (lo + hi) >> 1
        psum = torch.zeros_like(total)
        done = torch.zeros_like(active)
        for j in range(nb - 1, -1, -1):
            bitsj = _lut(cols[j], mid.clamp(0, nv - 1))
            bitsj = torch.where(bitsj > 0,
                                torch.clamp(bitsj + trim_off[j], min=0),
                                bitsj)
            bitsj = bitsj + offsets[j]
            use = (bitsj >= thresh[j]) | done
            psum = psum + torch.where(use, torch.clamp(bitsj, max=caps[j]),
                                      torch.where(bitsj >= (1 << BITRES),
                                                  1 << BITRES, 0))
            done = done | use
        over = psum > total
        hi = torch.where(go & over, mid - 1, hi)
        lo = torch.where(go & ~over, mid + 1, lo)
    hi_f = lo
    lo_f = lo - 1
    bits1 = []
    bits2 = []
    skip_start = torch.zeros_like(total)
    for j in range(nb):
        b1 = _lut(cols[j], lo_f.clamp(0, nv - 1))
        b2 = torch.where(hi_f >= nv, caps[j],
                         _lut(cols[j], hi_f.clamp(0, nv - 1)))
        b1 = torch.where(b1 > 0, torch.clamp(b1 + trim_off[j], min=0), b1)
        b2 = torch.where(b2 > 0, torch.clamp(b2 + trim_off[j], min=0), b2)
        b1 = b1 + torch.where(lo_f > 0, offsets[j], 0)
        b2 = b2 + offsets[j]
        skip_start = torch.where(offsets[j] > 0, j, skip_start)
        bits1.append(b1)
        bits2.append(torch.clamp(b2 - b1, min=0))
    return _interp_bits2pulses_enc(vk, e, tabs, bits1, bits2, thresh, total,
                                   skip_rsv, skip_start, prev_cb, active)


# ===================================================================== #
# fine energy + finalise                                                #
# ===================================================================== #

def _pow2(ebits):
    """2 ** -ebits exactly (0 <= ebits < 32), as f32 lanes."""
    tab = const("pow2_neg", lambda: np.ldexp(np.float32(1.0), -np.arange(
        32)).astype(np.float32), ebits.device)
    return tab[ebits.clamp(0, 31)]


def _quant_fine_energy(vk, e, error, ebits, old_e, nbytes: int, nb: int,
                       active):
    """quant_fine_energy (quant_bands.c:360), mono.  Returns (e, error,
    old_e)."""
    error = list(error)
    old_e = list(old_e)
    for i in range(nb):
        can = active & (ebits[i] > 0) \
            & (vk.re_tell(e) + ebits[i] <= nbytes * 8)
        extra = (1 << ebits[i].clamp(0, MAX_FINE_BITS)).to(f32)
        q2 = torch.floor((error[i] + 0.5) * extra).to(i64)
        q2 = torch.minimum(q2.clamp_min(0), (extra - 1).to(i64))
        e = vk.re_enc_bits(e, torch.where(can, q2, 0),
                           torch.where(can, ebits[i], 0), can)
        offs = (q2.to(f32) + 0.5) * _pow2(ebits[i]) - 0.5
        old_e[i] = torch.where(can, old_e[i] + offs, old_e[i])
        error[i] = torch.where(can, error[i] - offs, error[i])
    return e, error, old_e


def _quant_energy_finalise(vk, e, error, ebits, fine_priority, bits_left,
                           nb: int, active):
    """quant_energy_finalise (quant_bands.c:401), mono.  As in the JAX
    twin, only the error is updated (not the energy memory)."""
    error = list(error)
    for prio in range(2):
        for i in range(nb):
            can = active & (bits_left >= 1) \
                & (ebits[i] < MAX_FINE_BITS) & (fine_priority[i] == prio)
            q2 = (error[i] >= 0).to(i64)
            e = vk.re_enc_bits(e, torch.where(can, q2, 0),
                               torch.where(can, 1, 0), can)
            offs = (q2.to(f32) - 0.5) * _pow2(ebits[i] + 1)
            error[i] = torch.where(can, error[i] - offs, error[i])
            bits_left = bits_left - can.to(i64)
    return e, error


# ===================================================================== #
# state                                                                 #
# ===================================================================== #

def fused_celt_enc_init(batch: int, tabs: EncTabs, device="cuda"):
    """Per-stream encoder state (the JAX ``fused_celt_enc_init`` dict, with
    each per-band list as one [B, nb] tensor)."""
    z = torch.zeros(batch, dtype=f32, device=device)
    zi = torch.zeros(batch, dtype=i64, device=device)
    nb = tabs.nb
    return dict(
        mem=z, hist=torch.zeros((batch, tabs.mode.overlap), dtype=f32,
                                device=device),
        overlap_max=z, spec_avg=z,
        old_band_e=torch.zeros((batch, nb), dtype=f32, device=device),
        old_log_e=torch.full((batch, nb), -28.0, dtype=f32, device=device),
        old_log_e2=torch.full((batch, nb), -28.0, dtype=f32, device=device),
        energy_error=torch.zeros((batch, nb), dtype=f32, device=device),
        delayed_intra=torch.ones(batch, dtype=f32, device=device),
        consec_transient=zi, last_coded_bands=zi,
        tonal_average=torch.full_like(zi, 256), hf_average=zi,
        tapset_decision=zi,
        spread_decision=torch.full_like(zi, SPREAD_NORMAL))
