"""CELT decode symbol pass on [B] lanes in plain torch, mono or with two
coded channels: the plain version of kernel K1
(``opus_tpu_torch/csrc/celt_dec_frame.cu``, its C = 1 and C = 2
instantiations).

Port of ``opus_tpu/models/celt_dec_fused.py`` (tables and helpers, the
plan, the band tree, anti-collapse and the frame driver), with the C = 2
paths of the JAX package's scalar tier, which alone decodes stereo: the
energies interleaved over the channels (``opus_tpu/celt/decoder.py:67``,
:98, :114), the allocation's caps, thresholds, intensity and dual-stereo
reservations (``opus_tpu/celt/alloc.py``), and ``compute_theta``'s
stereo branch, ``quant_band_stereo``, ``stereo_merge`` and dual stereo
(``opus_tpu/celt/bands.py``).  The channel count changes the plan's
arithmetic and the band loop's body; everything else is one path.
Every lane is one stream; integer state is int64 tensors holding
int32/uint32 values (uint32 wrap emulated with ``& 0xFFFFFFFF``), float
state is float32.

The band-split recursion walks the same static binary tree as the JAX
twin: whether a lane splits at a node is a per-lane mask, and the mid/
side visit order is handled with per-lane parameter swaps.  Unlike the
traced JAX graph, eager torch can skip a node, a leaf kind or a rotation
variant that no lane takes, which leaves every lane's result unchanged
because all range-coder and context updates are masked per lane.

Scope: any coded band range [start, end) (start 0 for CELT-only frames,
17 for the CELT half of a hybrid frame, which continues from SILK's
range decoder), no loss handling, no QEXT payload.
Reference: celt/celt_decoder.c:1209-1560, bands.c, rate.c, cwrs.c, vq.c.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..celt import cwrs
from ..celt.modes import mode_create, get_pulses
from ..celt.tables import E_PROB_MODEL, LOG2_FRAC_TABLE
from ..ops import rc_kernel as K
from ..ops.device_cache import const
from ..ops.rc_kernel import M32, ilog

BITRES = 3
MAX_FINE_BITS = 8
FINE_OFFSET = 21
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
ALLOC_STEPS = 6
SPREAD_NONE = 0
SPREAD_NORMAL = 2
SPREAD_AGGRESSIVE = 3
LAPLACE_CAP = 40        # iteration cap; overflow sets error

PRED_COEF = (29440 / 32768., 26112 / 32768., 21248 / 32768.,
             16384 / 32768.)
BETA_COEF = (30147 / 32768., 22282 / 32768., 12124 / 32768., 6554 / 32768.)
BETA_INTRA = 4915 / 32768.
SMALL_ENERGY_ICDF = (2, 1, 0)
TRIM_ICDF = (126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0)
SPREAD_ICDF = (25, 23, 2, 0)
TAPSET_ICDF = (2, 1, 0)
TF_SELECT_TABLE = ((0, -1, 0, -1, 0, -1, 0, -1),
                   (0, -1, 0, -2, 1, 0, 1, -1),
                   (0, -2, 0, -3, 2, 0, 1, -1),
                   (0, -2, 0, -3, 3, 0, 1, -1))
EXP2_TABLE8 = (16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048)
BIT_INTERLEAVE_TABLE = (0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3)
BIT_DEINTERLEAVE_TABLE = (0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                          0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF)
ORDERY_TABLE = {2: (1, 0), 4: (3, 0, 2, 1), 8: (7, 0, 4, 3, 6, 1, 5, 2)}
NORM = 1.0
EPS = 1e-15
SQRT_HALF = math.sqrt(0.5)

i64 = torch.int64
f32 = torch.float32
_U32_SAT = (1 << 32) - 1
_MAX_K = 128


# ===================================================================== #
# literal-table helpers                                                 #
# ===================================================================== #

def _lut(vals, idx):
    """vals[idx] for a python int table and an in-range int64 index."""
    return torch.as_tensor(vals, dtype=i64, device=idx.device)[idx]


def _isqrt(x):
    """floor(sqrt(x)) exactly for 0 <= x < 2**24."""
    s = torch.sqrt(x.to(f32)).to(i64)
    s = s - (s * s > x).to(i64)
    return s + ((s + 1) * (s + 1) <= x).to(i64)


def _frac_mul16(a, b):
    return (16384 + a * b) >> 15


def _bitexact_cos(x):
    x2 = (4096 + x * x) >> 13
    x2 = (32767 - x2) + _frac_mul16(
        x2, -7651 + _frac_mul16(x2, 8277 + _frac_mul16(-626, x2)))
    return 1 + x2


def _bitexact_log2tan(isin, icos):
    lc = ilog(icos)
    ls = ilog(isin)
    icos = icos << (15 - lc)
    isin = isin << (15 - ls)
    return ((ls - lc) * (1 << 11)
            + _frac_mul16(isin, _frac_mul16(isin, -2597) + 7932)
            - _frac_mul16(icos, _frac_mul16(icos, -2597) + 7932))


@lru_cache(maxsize=None)
def _lcg_tabs(n: int):
    """Closed-form LCG chains: seed_j = a_pows[j]*seed0 + c_sums[j]
    (mod 2^32) after j celt_lcg_rand steps."""
    a_p = np.zeros(n + 1, np.uint64)
    c_s = np.zeros(n + 1, np.uint64)
    a_p[0] = 1
    for j in range(1, n + 1):
        a_p[j] = (a_p[j - 1] * 1664525) & 0xFFFFFFFF
        c_s[j] = (c_s[j - 1] * 1664525 + 1013904223) & 0xFFFFFFFF
    return a_p.astype(np.uint32), c_s.astype(np.uint32)


def _to_i32(u):
    """uint32 value held in int64 -> its int32 reading."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u)


def _sudiv(a, den):
    """C truncating division by a positive divisor."""
    return torch.div(a, den, rounding_mode="trunc")


# ===================================================================== #
# [B, n] array helpers                                                  #
# ===================================================================== #

def _haar1_arr(x, n0: int, stride: int):
    """haar1 (bands.c:623): first n0*stride columns viewed as [n0,
    stride], butterflies on row pairs (2j, 2j+1)."""
    b, n = x.shape
    reg = n0 * stride
    head = x[:, :reg].reshape(b, n0 // 2, 2, stride)
    t = SQRT_HALF * head
    y = torch.stack([t[:, :, 0, :] + t[:, :, 1, :],
                     t[:, :, 0, :] - t[:, :, 1, :]], dim=2)
    head = y.reshape(b, reg)
    if reg == n:
        return head
    return torch.cat([head, x[:, reg:]], dim=1)


@lru_cache(maxsize=None)
def _hadamard_perm(stride: int, hadamard: bool, inverse: bool):
    """Row permutation for (de)interleave_hadamard."""
    perm = np.arange(stride)
    if hadamard:
        ordery = ORDERY_TABLE[stride]
        if inverse:
            perm = np.asarray(ordery)
        else:
            for i in range(stride):
                perm[ordery[i]] = i
    return tuple(int(v) for v in perm)


def _deinterleave_hadamard_arr(x, n0: int, stride: int, hadamard: bool):
    b, n = x.shape
    m = x.reshape(b, n0, stride).transpose(1, 2)
    m = m[:, list(_hadamard_perm(stride, hadamard, False)), :]
    return m.reshape(b, n)


def _interleave_hadamard_arr(x, n0: int, stride: int, hadamard: bool):
    b, n = x.shape
    m = x.reshape(b, stride, n0)
    m = m[:, list(_hadamard_perm(stride, hadamard, True)), :]
    return m.transpose(1, 2).reshape(b, n)


def _exp_rotation1(x, stride: int, c, s):
    """exp_rotation1 (vq.c:83) on x [B, S, length] in place, per-lane
    c/s [B]: the forward then backward pass of pair rotations."""
    length = x.shape[2]
    cb = c[:, None]
    sb = s[:, None]
    steps = list(range(length - stride)) \
        + list(range(length - 2 * stride - 1, -1, -1))
    for i in steps:
        x1 = x[:, :, i]
        x2 = x[:, :, i + stride]
        y2 = cb * x2 + sb * x1
        y1 = cb * x1 - sb * x2
        x[:, :, i + stride] = y2
        x[:, :, i] = y1


def _exp_rotation_dec(x, n: int, stride_lanes, stride_vals, k, spread,
                      active):
    """exp_rotation direction=-1 (vq.c:104) on [B, n] with per-lane
    stride/spread/k; only lanes with spread != 0 and 2k < n rotate."""
    factor = torch.where(spread == 1, 15.0,
                         torch.where(spread == 2, 10.0, 5.0)).to(f32)
    kf = k.to(f32)
    gain = n / (n + factor * kf)
    theta = 0.5 * gain * gain
    c = torch.cos((0.5 * math.pi) * theta)
    s = torch.cos((0.5 * math.pi) * (1.0 - theta))
    do = active & (spread != SPREAD_NONE) & (2 * k < n)
    out = x
    b = x.shape[0]
    for sv in stride_vals:
        if n < sv:
            continue
        m = do & (stride_lanes == sv)
        if not bool(m.any()):
            continue
        stride2 = 0
        if n >= 8 * sv:
            stride2 = 1
            while (stride2 * stride2 + stride2) * sv + (sv >> 2) < n:
                stride2 += 1
        segs = x.reshape(b, sv, n // sv).clone()
        if stride2:
            _exp_rotation1(segs, stride2, s, c)
        _exp_rotation1(segs, 1, c, s)
        out = torch.where(m[:, None], segs.reshape(b, n), out)
    return out


def _collapse_mask_arr(iy, n: int, b_lanes, b_vals, active):
    """extract_collapse_mask (bands.c:167) on iy [B, n]."""
    out = torch.ones_like(b_lanes)
    for bv in b_vals:
        if bv <= 1:
            cm = torch.ones_like(b_lanes)
        else:
            nz = (iy.reshape(iy.shape[0], bv, n // bv) != 0).any(dim=2)
            w = torch.as_tensor([1 << j for j in range(bv)], dtype=i64,
                                device=iy.device)
            cm = (nz.to(i64) * w).sum(dim=1)
        out = torch.where(active & (b_lanes == bv), cm, out)
    return out


def _renormalise_arr(x, gain, active):
    e = (x * x).sum(dim=1) + EPS
    g = gain * torch.rsqrt(e)
    return torch.where(active[:, None], x * g[:, None], x)


# ===================================================================== #
# static mode tables                                                    #
# ===================================================================== #

@lru_cache(maxsize=None)
def _u_col(n: int, cap: int) -> tuple:
    """U(t, n) for t in 0..cap, saturated at 2**32-1 (valid streams only
    reach combos whose codebook fits in 32 bits)."""
    return tuple(min(cwrs.pvq_u(t, n), _U32_SAT) for t in range(cap + 1))


@lru_cache(maxsize=None)
def _v_row(n: int, cap: int) -> tuple:
    """V(n, k) for k in 0..cap (saturated, see _u_col)."""
    return tuple(min(cwrs.pvq_v(n, k), _U32_SAT) for k in range(cap + 1))


def _cwrs_table(fn, rows: int, cols: int) -> np.ndarray:
    """[rows, cols] int64: fn(n, k) (``cwrs.pvq_u`` or ``pvq_v``) at
    [k, n], saturated at 2**32-1, for the kernels' CWRS tables."""
    return np.array([[min(fn(n, k), _U32_SAT) for n in range(cols)]
                     for k in range(rows)], np.int64)


class DecTabs:
    """Static per-(fs, frame_size) tables of the decoder: a numpy copy of
    ``opus_tpu.models.celt_dec_fused.DecTabs`` (whose module imports jax),
    plus the flat int32 table that kernel K1 reads on the card."""

    def __init__(self, fs: int, frame_size: int, start: int = 0,
                 end: int | None = None):
        mode = mode_create(fs, frame_size)
        self.mode = mode
        lm = 0
        while mode.shortMdctSize << lm != frame_size:
            lm += 1
        self.lm = lm
        m = 1 << lm
        self.M = m
        nb = mode.nbEBands
        self.nb = nb
        self.start = start
        self.end_band = nb if end is None else end
        assert 0 <= start < self.end_band <= nb
        self.eBands = np.asarray(mode.eBands[:nb + 1], np.int32)
        self.width = ((self.eBands[1:] - self.eBands[:-1]) * m).astype(int)
        self.logN = [int(v) for v in mode.logN[:nb]]
        self.allocV = np.asarray(mode.allocVectors, np.uint8).reshape(
            mode.nbAllocVectors, nb).astype(int)
        caps8 = np.asarray(mode.cache.caps, np.uint8)
        self.caps = [
            (int(caps8[lm * 2 * nb + i]) + 64) * int(self.width[i]) >> 2
            for i in range(nb)]
        # the caps of a two-channel frame (celt.c init_caps with C = 2)
        self.caps2 = [
            (int(caps8[(2 * lm + 1) * nb + i]) + 64) * 2 * int(self.width[i])
            >> 2 for i in range(nb)]
        idx = np.asarray(mode.cache.index, np.int16).reshape(-1, nb)
        bits_tab = np.asarray(mode.cache.bits, np.uint8)
        self.cache_rows = {}
        for lmn in range(-1, lm + 1):
            for band in range(nb):
                off = int(idx[lmn + 1, band])
                ln = int(bits_tab[off])
                self.cache_rows[(lmn, band)] = [
                    int(v) for v in bits_tab[off:off + ln + 1]]
        self.e_prob = [[int(v) for v in E_PROB_MODEL[lm][intra]]
                       for intra in range(2)]
        self.nx = m * int(self.eBands[nb])        # coded spectrum length
        self.fold_plan = _fold_plan(m, [int(v) for v in self.eBands],
                                    start)

    def kernel_table(self) -> np.ndarray:
        """Flat int32 table for kernel K1: a header [nb, lm, nv, urows,
        ucols, start, end] and the offsets of eBands, logN, caps, allocV,
        e_prob, the cache row offsets, the cache rows, the CWRS U table
        and the two-channel caps (read by load_tabs in
        csrc/celt_dec_frame.cu).  U is stored
        column by column ([ucols][urows], U(k, n) at n * urows + k), so a
        warp's search over consecutive k reads consecutive words.  uint32
        entries are stored as their int32 bits."""
        nb, lm = self.nb, self.lm
        nv = self.allocV.shape[0]
        rows = []
        row_off = []
        pos = 0
        for lmn in range(-1, lm + 1):
            for band in range(nb):
                r = self.cache_rows[(lmn, band)]
                row_off.append(pos)
                rows.extend(r)
                pos += len(r)
        ucols = int(self.width.max())             # largest band / node n
        u = _cwrs_table(cwrs.pvq_u, _MAX_K + 2, ucols + 1)
        parts = [
            ("eBands", np.asarray(self.eBands, np.int64)),
            ("logN", np.asarray(self.logN, np.int64)),
            ("caps", np.asarray(self.caps, np.int64)),
            ("allocV", self.allocV.reshape(-1).astype(np.int64)),
            ("eprob", np.asarray(self.e_prob, np.int64).reshape(-1)),
            ("rowoff", np.asarray(row_off, np.int64)),
            ("rows", np.asarray(rows, np.int64)),
            ("u", u.T.reshape(-1)),
            ("caps2", np.asarray(self.caps2, np.int64)),
        ]
        header = [nb, lm, nv, _MAX_K + 2, ucols + 1, self.start,
                  self.end_band]
        hdr_len = len(header) + len(parts)
        offs = []
        pos = hdr_len
        for _name, arr in parts:
            offs.append(pos)
            pos += arr.size
        flat = np.concatenate(
            [np.asarray(header + offs, np.int64)] + [a for _n, a in parts])
        return flat.astype(np.uint32).view(np.int32)


# ===================================================================== #
# planning pass: header -> allocation -> fine energy                    #
# ===================================================================== #

def _laplace_decode(d, buf, lens, fs0, decay, active):
    """ec_laplace_decode (laplace.c); fs0/decay: int lanes."""
    fm, d = K.rk_decode(d, 32768, active)
    ge = active & (fm >= fs0)
    val = ge.to(i64)
    fl = torch.where(ge, fs0, 0)
    ft1 = ((32768 - 2 * 16 - fs0) * (16384 - decay)) >> 15
    fs = torch.where(ge, ft1 + 1, fs0)
    running = ge
    for _ in range(LAPLACE_CAP):
        cond = running & (fs > 1) & (fm >= fl + 2 * fs)
        if not bool(cond.any()):
            break
        fs2 = fs * 2
        fs = torch.where(cond, (((fs2 - 2) * decay) >> 15) + 1, fs)
        fl = torch.where(cond, fl + fs2, fl)
        val = torch.where(cond, val + 1, val)
        running = cond
    overflow = ge & (fs > 1) & (fm >= fl + 2 * fs)
    di = torch.where(ge & (fs <= 1), (fm - fl) >> 1, 0)
    val = val + di
    fl = fl + 2 * di
    neg = ge & (fm < fl + fs)
    val = torch.where(ge, torch.where(neg, -val, val), 0)
    fl = torch.where(ge & ~neg, fl + fs, fl)
    fh = torch.clamp(fl + fs, max=32768)
    d = K.rk_update(d, buf, lens, fl, fh, 32768, active)
    d = dict(d)
    d["error"] = d["error"] | (overflow & active).to(i64)
    return val, d


def _caps(tabs: DecTabs, C: int):
    """The band caps of a frame with C coded channels (celt.c init_caps)."""
    return tabs.caps if C == 1 else tabs.caps2


def _coarse_energy(d, buf, lens, tabs: DecTabs, old_e, intra, total_bits,
                   active):
    """unquant_coarse_energy (quant_bands.c) over C = len(old_e) channels:
    band by band, channel 0 then 1, each with its own running prediction.
    old_e: per channel a list of nb [B] f32 lanes; returns the updated
    lists."""
    lm = tabs.lm
    intra_b = intra != 0
    coef = torch.where(intra_b, 0.0, PRED_COEF[lm]).to(f32)
    beta = torch.where(intra_b, BETA_INTRA, BETA_COEF[lm]).to(f32)
    old_e = [list(o) for o in old_e]
    prev = [torch.zeros_like(old_e[0][0]) for _ in old_e]
    for i in range(tabs.start, tabs.end_band):
        pi = 2 * min(i, 20)
        fs0 = torch.where(intra_b, tabs.e_prob[1][pi] << 7,
                          tabs.e_prob[0][pi] << 7)
        decay = torch.where(intra_b, tabs.e_prob[1][pi + 1] << 6,
                            tabs.e_prob[0][pi + 1] << 6)
        for c, oe in enumerate(old_e):
            tell = K.rk_tell(d)
            big = active & (total_bits - tell >= 15)
            med = active & ~big & (total_bits - tell >= 2)
            tiny = active & ~big & ~med & (total_bits - tell >= 1)
            qi_l, d = _laplace_decode(d, buf, lens, fs0, decay, big)
            s_m, d = K.rk_dec_icdf(d, buf, lens, SMALL_ENERGY_ICDF, 2, med)
            qi_m = (s_m >> 1) ^ -(s_m & 1)
            b_t, d = K.rk_dec_bit_logp(d, buf, lens, 1, tiny)
            qi = torch.where(big, qi_l, torch.where(
                med, qi_m, torch.where(tiny, -b_t, -1)))
            q = qi.to(f32)
            old = torch.clamp(oe[i], min=-9.0)
            oe[i] = torch.where(active, coef * old + prev[c] + q, oe[i])
            prev[c] = torch.where(active, prev[c] + q - beta * q, prev[c])
    return old_e, d


def _tf_decode(d, buf, lens, tabs: DecTabs, is_transient, total_bits,
               active):
    """tf_decode (celt_decoder.c).  Returns list of nb tf_change lanes."""
    lm = tabs.lm
    tsel = TF_SELECT_TABLE[lm]
    budget = total_bits
    tell = K.rk_tell(d)
    logp0 = torch.where(is_transient, 2, 4)
    tf_select_rsv = (lm > 0) & (tell + logp0 + 1 <= budget)
    budget = budget - tf_select_rsv.to(i64)
    curr = torch.zeros_like(tell)
    tf_changed = torch.zeros_like(tell)
    tf_res = [torch.zeros_like(tell) for _ in range(tabs.start)]
    for i in range(tabs.start, tabs.end_band):
        lo_logp = 2 if i == tabs.start else 4
        hi_logp = 4 if i == tabs.start else 5
        logp = torch.where(is_transient, lo_logp, hi_logp)
        can = active & (tell + logp <= budget)
        bit, d = K.rk_dec_bit_logp(d, buf, lens, logp, can)
        curr = torch.where(can, curr ^ bit, curr)
        tell = K.rk_tell(d)
        tf_changed = tf_changed | curr
        tf_res.append(curr)
    tf_res += [torch.zeros_like(tell)
               for _ in range(tabs.nb - tabs.end_band)]
    it4 = 4 * is_transient.to(i64)
    t_a = _lut(tsel, it4 + 0 + tf_changed)
    t_b = _lut(tsel, it4 + 2 + tf_changed)
    sel_bit, d = K.rk_dec_bit_logp(d, buf, lens, 1,
                                   active & tf_select_rsv & (t_a != t_b))
    out = [_lut(tsel, it4 + 2 * sel_bit + t) for t in tf_res]
    return out, d


def _dynalloc(d, buf, lens, tabs: DecTabs, total_bits, active, C: int = 1):
    """dynalloc boost decode with C coded channels (the quanta over every
    channel's coefficients, the caps of C); returns (offsets list[nb],
    trim, state)."""
    total_bits8 = total_bits << BITRES
    tellf = K.rk_tell_frac(d)
    dynalloc_logp = torch.full_like(tellf, 6)
    offsets = [torch.zeros_like(tellf) for _ in range(tabs.start)]
    caps = _caps(tabs, C)
    for i in range(tabs.start, tabs.end_band):
        width = C * int(tabs.width[i])
        quanta = min(width << BITRES, max(6 << BITRES, width))
        cap_i = int(caps[i])
        boost = torch.zeros_like(tellf)
        loop_logp = dynalloc_logp
        running = active
        while True:
            can = running & (tellf + (loop_logp << BITRES) < total_bits8) \
                & (boost < cap_i)
            if not bool(can.any()):
                break
            flag, d = K.rk_dec_bit_logp(d, buf, lens, loop_logp, can)
            tellf = K.rk_tell_frac(d)
            got = can & (flag != 0)
            boost = torch.where(got, boost + quanta, boost)
            total_bits8 = torch.where(got, total_bits8 - quanta,
                                      total_bits8)
            loop_logp = torch.where(got, 1, loop_logp)
            running = got
        offsets.append(boost)
        dynalloc_logp = torch.where(boost > 0,
                                    torch.clamp(dynalloc_logp - 1, min=2),
                                    dynalloc_logp)
    offsets += [torch.zeros_like(tellf)
                for _ in range(tabs.nb - tabs.end_band)]
    can_trim = active & (tellf + (6 << BITRES) <= total_bits8)
    trim_v, d = K.rk_dec_icdf(d, buf, lens, TRIM_ICDF, 7, can_trim)
    trim = torch.where(can_trim, trim_v, 5)
    return offsets, trim, d


def _compute_allocation(d, buf, lens, tabs: DecTabs, offsets, trim, total,
                        active, C: int = 1):
    """compute_allocation, decode (rate.c:535; alloc.py:195) with C coded
    channels: at C = 2 the intensity and dual-stereo reservations."""
    nb = tabs.nb
    start, end = tabs.start, tabs.end_band
    eB = tabs.eBands
    total = torch.clamp(total, min=0)
    skip_rsv = torch.where(total >= (1 << BITRES), 1 << BITRES, 0)
    total = total - skip_rsv
    intensity_rsv = dual_rsv = None
    if C == 2:
        i_rsv0 = LOG2_FRAC_TABLE[end - start]
        has_i = total >= i_rsv0
        intensity_rsv = torch.where(has_i, i_rsv0, 0)
        total = total - intensity_rsv
        dual_rsv = torch.where(has_i & (total >= (1 << BITRES)),
                               1 << BITRES, 0)
        total = total - dual_rsv
    widths = [int(v) for v in (eB[1:] - eB[:-1])]
    thresh = [max((3 * widths[j] << tabs.lm << BITRES) >> 4, C << BITRES)
              for j in range(nb)]
    trim_off = []
    for j in range(nb):
        t = (C * widths[j] * (trim - 5 - tabs.lm) * (end - 1 - j)
             * (1 << (tabs.lm + BITRES))) >> 6
        if (widths[j] << tabs.lm) == 1:
            t = t - (C << BITRES)
        trim_off.append(t)
    caps = _caps(tabs, C)
    allocV = tabs.allocV
    nv = allocV.shape[0]
    cols = [[C * widths[j] * int(allocV[v, j]) << tabs.lm >> 2
             for v in range(nv)] for j in range(nb)]
    alloc_floor = C << BITRES

    lo = torch.ones_like(total)
    hi = torch.full_like(total, nv - 1)
    for _ in range(6):   # ilog2(nbAllocVectors) iterations suffice
        go = lo <= hi
        mid = (lo + hi) >> 1
        psum = torch.zeros_like(total)
        done = torch.zeros_like(total, dtype=torch.bool)
        for j in range(end - 1, start - 1, -1):
            bitsj = _lut(cols[j], mid.clamp(0, nv - 1))
            bitsj = torch.where(bitsj > 0,
                                torch.clamp(bitsj + trim_off[j], min=0),
                                bitsj)
            bitsj = bitsj + offsets[j]
            use = (bitsj >= thresh[j]) | done
            psum = psum + torch.where(
                use, torch.clamp(bitsj, max=caps[j]),
                torch.where(bitsj >= alloc_floor, alloc_floor, 0))
            done = done | use
        over = psum > total
        hi = torch.where(go & over, mid - 1, hi)
        lo = torch.where(go & ~over, mid + 1, lo)
    hi_f = lo
    lo_f = lo - 1
    zt = torch.zeros_like(total)
    bits1 = [zt for _ in range(start)]
    bits2 = [zt for _ in range(start)]
    skip_start = torch.full_like(total, start)
    for j in range(start, end):
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
    bits1 += [zt for _ in range(nb - end)]
    bits2 += [zt for _ in range(nb - end)]
    return _interp_bits2pulses(d, buf, lens, tabs, bits1, bits2, thresh,
                               total, skip_rsv, skip_start, active, C,
                               intensity_rsv, dual_rsv)


def _interp_bits2pulses(d, buf, lens, tabs: DecTabs, bits1, bits2, thresh,
                        total, skip_rsv, skip_start, active, C: int = 1,
                        intensity_rsv=None, dual_rsv=None):
    """interp_bits2pulses, decode (rate.c:249; alloc.py:27) with C coded
    channels: at C = 2 the intensity band and the dual-stereo flag coded
    after the skip loop, and the fine bits of a band shared by both
    channels.  Returns (coded_bands, balance, pulses, ebits,
    fine_priority, intensity, dual_stereo, state); intensity and
    dual_stereo are None at C = 1."""
    nb = tabs.nb
    start, end = tabs.start, tabs.end_band
    alloc_floor = C << BITRES
    eB = [int(v) for v in tabs.eBands]
    caps = _caps(tabs, C)
    lo = torch.zeros_like(total)
    hi = torch.full_like(total, 1 << ALLOC_STEPS)
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = torch.zeros_like(total)
        done = torch.zeros_like(total, dtype=torch.bool)
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            use = (tmp >= thresh[j]) | done
            psum = psum + torch.where(
                use, torch.clamp(tmp, max=caps[j]),
                torch.where(tmp >= alloc_floor, alloc_floor, 0))
            done = done | use
        over = psum > total
        hi = torch.where(over, mid, hi)
        lo = torch.where(over, lo, mid)
    psum = torch.zeros_like(total)
    done = torch.zeros_like(total, dtype=torch.bool)
    bits = [torch.zeros_like(total)] * nb
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        low = (tmp < thresh[j]) & ~done
        tmp2 = torch.where(low, torch.where(tmp >= alloc_floor,
                                            alloc_floor, 0), tmp)
        done = done | ~low
        tmp2 = torch.clamp(tmp2, max=caps[j])
        bits[j] = tmp2
        psum = psum + tmp2

    coded_bands = torch.full_like(total, end)
    finished = ~active
    forced_stop = torch.zeros_like(total, dtype=torch.bool)
    # down to j == start, where skipping always stops at skip_start
    # (rate.c interp_bits2pulses; skip_start >= start)
    for j in range(end - 1, start - 1, -1):
        is_cur = (~finished) & (coded_bands == j + 1) & (j > skip_start)
        at_skip = (~finished) & (coded_bands == j + 1) & (j <= skip_start)
        finished = finished | at_skip
        forced_stop = forced_stop | at_skip
        left = total - psum
        den = eB[j + 1] - eB[start]
        percoeff = torch.div(left, den, rounding_mode="floor")
        leftr = left - den * percoeff
        rem = torch.clamp(leftr - (eB[j] - eB[start]), min=0)
        band_width = eB[j + 1] - eB[j]
        band_bits = bits[j] + percoeff * band_width + rem
        th = max(thresh[j], alloc_floor + (1 << BITRES))
        reads = is_cur & (band_bits >= th)
        bit, d = K.rk_dec_bit_logp(d, buf, lens, 1, reads)
        stop = reads & (bit != 0)
        finished = finished | stop
        adj = reads & ~stop
        psum = torch.where(adj, psum + (1 << BITRES), psum)
        band_bits = torch.where(adj, band_bits - (1 << BITRES), band_bits)
        cont = is_cur & ~stop
        keep = torch.where(band_bits >= alloc_floor, alloc_floor, 0)
        reclaimed = psum - bits[j] + keep
        if C == 2:
            # the intensity reservation shrinks with the coded bands
            new_rsv = torch.where(intensity_rsv > 0,
                                  LOG2_FRAC_TABLE[j - start], intensity_rsv)
            reclaimed = reclaimed - intensity_rsv + new_rsv
            intensity_rsv = torch.where(cont, new_rsv, intensity_rsv)
        psum = torch.where(cont, reclaimed, psum)
        bits[j] = torch.where(cont, keep, bits[j])
        coded_bands = torch.where(cont, coded_bands - 1, coded_bands)
    # the skip-bit reservation returns to the pool only when skipping
    # stopped at skip_start without coding a stop bit (rate.c:331)
    total = total + torch.where(forced_stop, skip_rsv, 0)

    intensity = dual = None
    if C == 2:
        # the intensity band and the dual-stereo flag (alloc.py:119-136)
        rd_i = active & (intensity_rsv > 0)
        iv, d = K.rk_dec_uint(d, buf, lens, torch.where(
            rd_i, coded_bands + 1 - start, 2), rd_i)
        intensity = torch.where(rd_i, start + iv, 0)
        no_i = intensity <= start
        total = total + torch.where(no_i, dual_rsv, 0)
        dual_rsv = torch.where(no_i, 0, dual_rsv)
        rd_d = active & (dual_rsv > 0)
        dv, d = K.rk_dec_bit_logp(d, buf, lens, 1, rd_d)
        dual = rd_d & (dv != 0)

    left = total - psum
    den = _lut([max(eB[c] - eB[start], 0) for c in range(nb + 1)],
               coded_bands.clamp(0, nb))
    den = torch.clamp(den, min=1)
    percoeff = torch.div(left, den, rounding_mode="floor")
    left = left - den * percoeff
    in_coded = [None] * nb
    for j in range(start, end):
        in_c = j < coded_bands
        bits[j] = bits[j] + torch.where(in_c, percoeff * (eB[j + 1] - eB[j]),
                                        0)
        in_coded[j] = in_c
    for j in range(start, end):
        take = torch.clamp(left, max=eB[j + 1] - eB[j])
        bits[j] = bits[j] + torch.where(in_coded[j], take, 0)
        left = torch.where(in_coded[j], left - take, left)

    zt_ = torch.zeros_like(total)
    ebits = [zt_] * nb
    fine_priority = [zt_] * nb
    balance = torch.zeros_like(total)
    log_m = tabs.lm << BITRES
    for j in range(start, end):
        n = (eB[j + 1] - eB[j]) << tabs.lm
        in_c = in_coded[j]
        bitj = bits[j] + balance
        if n > 1:
            excess = torch.clamp(bitj - caps[j], min=0)
            bj = bitj - excess
            # N * C, plus one where a stereo band codes its angle
            den = n if C == 1 else 2 * n + (
                (~dual) & (j < intensity) & (n > 2)).to(i64)
            nclogn = den * (tabs.logN[j] + log_m)
            offset = (nclogn >> 1) - den * FINE_OFFSET
            if n == 2:
                offset = offset + (den << BITRES >> 2)
            off1 = torch.where(
                bj + offset < (den * 2 << BITRES), offset + (nclogn >> 2),
                torch.where(bj + offset < (den * 3 << BITRES),
                            offset + (nclogn >> 3), offset))
            eb_ = torch.clamp(bj + off1 + (den << (BITRES - 1)), min=0)
            eb_ = torch.div(eb_, den, rounding_mode="floor") >> BITRES
            eb_ = torch.where(C * eb_ > (bj >> BITRES),
                              bj >> (C - 1) >> BITRES, eb_)
            eb_ = torch.clamp(eb_, max=MAX_FINE_BITS)
            fp = (eb_ * (den << BITRES) >= bj + off1).to(i64)
            bj = bj - (C * eb_ << BITRES)
        else:
            excess = torch.clamp(bitj - (C << BITRES), min=0)
            bj = bitj - excess
            eb_ = torch.zeros_like(total)
            fp = torch.ones_like(total)
        has_ex = excess > 0
        extra_fine = torch.minimum(excess >> (C - 1 + BITRES),
                                   MAX_FINE_BITS - eb_)
        eb2 = eb_ + torch.where(has_ex, extra_fine, 0)
        extra_bits = extra_fine * C << BITRES
        fp = torch.where(has_ex, (extra_bits >= excess - balance).to(i64),
                         fp)
        excess2 = torch.where(has_ex, excess - extra_bits, excess)
        unc_eb = bits[j] >> (C - 1) >> BITRES
        ebits[j] = torch.where(in_c, eb2, unc_eb)
        fine_priority[j] = torch.where(in_c, fp, (unc_eb < 1).to(i64))
        bits[j] = torch.where(in_c, bj, 0)
        balance = torch.where(in_c, excess2, balance)
    return (coded_bands, balance, bits, ebits, fine_priority, intensity,
            dual, d)


def _postfilter(d, buf, lens, total_bits, live):
    """The postfilter header (celt_decoder.c:1232): (pitch, gain, tapset,
    state)."""
    pf_read = live & (K.rk_tell(d) + 16 <= total_bits)
    pf_on, d = K.rk_dec_bit_logp(d, buf, lens, 1, pf_read)
    pf = pf_read & (pf_on != 0)
    octave, d = K.rk_dec_uint(d, buf, lens, 6, pf)
    pbits, d = K.rk_dec_bits(d, buf, lens, torch.where(pf, 4 + octave, 0),
                             pf)
    pf_pitch = torch.where(pf, (16 << octave) + pbits - 1, 0)
    qg, d = K.rk_dec_bits(d, buf, lens, torch.where(pf, 3, 0), pf)
    tp_read = pf & (K.rk_tell(d) + 2 <= total_bits)
    tapset, d = K.rk_dec_icdf(d, buf, lens, TAPSET_ICDF, 2, tp_read)
    pf_tapset = torch.where(tp_read, tapset, 0)
    pf_gain = torch.where(pf, 0.09375 * (qg + 1).to(f32), 0.0)
    return pf_pitch, pf_gain, pf_tapset, d


def fused_plan(d, buf, lens, tabs: DecTabs, old_e, active):
    """Header through fine energy (celt_decoder.c:1209-1462) with C =
    len(old_e) coded channels.

    old_e: per channel a list of nb [B] f32 lanes.  Returns (plan dict,
    state); the plan's energies are per channel lists, and at C = 2 it
    holds the intensity band and the dual-stereo flag."""
    C = len(old_e)
    total_bits = lens * 8

    tell = K.rk_tell(d)
    sil_read = active & (tell == 1)
    sil_bit, d = K.rk_dec_bit_logp(d, buf, lens, 15, sil_read)
    silence = torch.where(tell >= total_bits, 1,
                          torch.where(sil_read, sil_bit, 0))
    d = dict(d)
    d["nbits_total"] = torch.where(
        silence != 0, total_bits - K.rk_tell(d) + d["nbits_total"],
        d["nbits_total"])
    live = active & (silence == 0)

    # ---- postfilter (only read when start == 0, celt_decoder.c:1232) --
    if tabs.start == 0:
        pf_pitch, pf_gain, pf_tapset, d = _postfilter(d, buf, lens,
                                                      total_bits, live)
    else:
        pf_pitch = pf_tapset = torch.zeros_like(lens)
        pf_gain = torch.zeros(lens.shape, dtype=f32, device=lens.device)

    # ---- transient + intra ----
    tell = K.rk_tell(d)
    tr_read = live & (tell + 3 <= total_bits) & (tabs.lm > 0)
    tr, d = K.rk_dec_bit_logp(d, buf, lens, 3, tr_read)
    is_transient = torch.where(tr_read, tr, 0)
    tell = K.rk_tell(d)
    in_read = live & (tell + 3 <= total_bits)
    intra, d = K.rk_dec_bit_logp(d, buf, lens, 3, in_read)
    intra = torch.where(in_read, intra, 0)

    # ---- coarse energy + tf + spread ----
    old_e, d = _coarse_energy(d, buf, lens, tabs, old_e, intra,
                              total_bits, live)
    tf_res, d = _tf_decode(d, buf, lens, tabs, is_transient != 0,
                           total_bits, live)
    tell = K.rk_tell(d)
    sp_read = live & (tell + 4 <= total_bits)
    spv, d = K.rk_dec_icdf(d, buf, lens, SPREAD_ICDF, 5, sp_read)
    spread = torch.where(sp_read, spv, SPREAD_NORMAL)

    # ---- dynalloc + trim + allocation ----
    offsets, trim, d = _dynalloc(d, buf, lens, tabs, total_bits, live, C)
    bits_left = (lens * 8 << BITRES) - K.rk_tell_frac(d) - 1
    ac_rsv = torch.where((is_transient != 0) & (tabs.lm >= 2)
                         & (bits_left >= ((tabs.lm + 2) << BITRES)),
                         1 << BITRES, 0)
    bits_left = bits_left - ac_rsv
    (coded_bands, balance, pulses, ebits, fine_priority, intensity, dual,
     d) = _compute_allocation(d, buf, lens, tabs, offsets, trim, bits_left,
                              live, C)

    # ---- fine energy: every channel of a band (at C = 2 only while both
    # fit, decoder.py:98) ----
    for i in range(tabs.start, tabs.end_band):
        fq = ebits[i]
        has = live & (fq > 0)
        if C == 2:
            has = has & (K.rk_tell(d) + C * fq <= total_bits)
        for oe in old_e:
            q2, d = K.rk_dec_bits(d, buf, lens, torch.where(has, fq, 0), has)
            offs = (q2.to(f32) + 0.5) * torch.exp2(-fq.to(f32)) - 0.5
            oe[i] = torch.where(has, oe[i] + offs, oe[i])

    return dict(silence=silence, pf_pitch=pf_pitch, pf_gain=pf_gain,
                pf_tapset=pf_tapset, is_transient=is_transient,
                intra=intra, energies=old_e, tf_res=tf_res,
                spread=spread, offsets=offsets, trim=trim,
                coded_bands=coded_bands, balance=balance, pulses=pulses,
                ebits=ebits, fine_priority=fine_priority,
                intensity=intensity, dual_stereo=dual,
                anti_collapse_rsv=ac_rsv, live=live), d


# ===================================================================== #
# CWRS: codebook index -> pulse vector                                  #
# ===================================================================== #

@lru_cache(maxsize=None)
def _cwrsi_tabs_np(n: int, kcap: int):
    """Per step j (nj = n - j, j in 0..n-3): the U(t, nj) column, U(nj,
    nj) and nj."""
    cols = np.stack([np.asarray(_u_col(n - j, kcap + 1), np.int64)
                     for j in range(n - 2)])
    qs = [min(cwrs.pvq_u(n - j, n - j), _U32_SAT) if n - j <= kcap + 1
          else _U32_SAT for j in range(n - 2)]
    return cols, qs


def _cwrsi(n: int, k, idx, kcap: int):
    """cwrsi (cwrs.c:467) on lanes: n static >= 2, k/idx [B] int64.  The
    scalar downward k searches become prefix counts over the static U
    column (strictly increasing in t >= 1).  Returns iy [B, n]."""
    i = idx
    ys = []
    if n > 2:
        cols_np, qs = _cwrsi_tabs_np(n, kcap)
        cols = const(("cwrsi", n, kcap), lambda: cols_np, i.device)
        for j in range(n - 2):
            col = cols[j]
            nj = n - j
            is_a = k >= nj
            col_k = col[k.clamp(0, kcap + 1)]
            col_k1 = col[(k + 1).clamp(0, kcap + 1)]
            s = i >= col_k1
            izero = (~is_a) & (col_k <= i) & (i < col_k1)
            i1 = i - torch.where(izero, col_k, torch.where(s, col_k1, 0))
            cnt = (i1[:, None] >= col[None, :kcap + 1]).sum(dim=1)
            upper = torch.where(is_a, torch.where(qs[j] > i1, nj - 1, k),
                                k - 1).clamp_min(0)
            k_new = torch.minimum((cnt - 1).clamp_min(0), upper)
            p_fin = col[k_new.clamp(0, kcap + 1)]
            i = torch.where(izero, i1, i1 - p_fin)
            val = k - k_new
            ys.append(torch.where(izero, 0, torch.where(s, -val, val)))
            k = torch.where(izero, k, k_new)
    # n == 2
    p = 2 * k + 1
    s = i >= p
    i = i - torch.where(s, p, 0)
    k0 = k
    k2 = (i + 1) >> 1
    i = i - torch.where(k2 > 0, 2 * k2 - 1, 0)
    val = k0 - k2
    ys.append(torch.where(s, -val, val))
    ys.append(torch.where(i != 0, -k2, k2))
    return torch.stack(ys, dim=1)


def _decode_pulses(d, buf, lens, n: int, k, kcap: int, active):
    """decode_pulses (cwrs.c): dec_uint(V(n,k)) + cwrsi -> iy [B, n]."""
    vrow = const(("vrow", n, kcap),
                lambda: np.asarray(_v_row(n, kcap), np.int64), k.device)
    ft = vrow[k.clamp(0, kcap)]
    idx, d = K.rk_dec_uint(d, buf, lens, ft, active)
    return _cwrsi(n, torch.clamp(k, min=1), idx, kcap), d


# ===================================================================== #
# quant_partition / quant_band over the static split tree               #
# ===================================================================== #

def _compute_qn_vec(n2: int, b, offset: int, pulse_cap: int):
    """compute_qn (bands.c) for a split into halves of n2."""
    return compute_qn_n2(2 * n2 - 1, b, offset, pulse_cap)


def compute_qn_n2(n2x: int, b, offset: int, pulse_cap: int):
    """compute_qn with N2 = n2x (2N - 1 for a split of N; a stereo band of
    N takes 2N - 1, and 2 at N = 2)."""
    qb = _sudiv(b + n2x * offset, n2x)
    qb = torch.minimum(b - pulse_cap - (4 << BITRES), qb)
    qb = torch.clamp(qb, max=8 << BITRES)
    exp_v = _lut(EXP2_TABLE8, qb & 0x7)
    sh = (14 - (qb >> BITRES)).clamp(0, 31)
    qn = ((exp_v >> sh) + 1) >> 1 << 1
    return torch.where(qb < (1 << BITRES >> 1), 1, qn)


def _compute_theta_mono(d, buf, lens, ctx, tabs: DecTabs, band: int,
                        n2: int, b, bb2, b0, lm2: int, fill, active):
    """compute_theta, mono decode (bands.c:700).  Returns (b, fill, sctx,
    d, ctx)."""
    pulse_cap = tabs.logN[band] + lm2 * (1 << BITRES)
    offset = (pulse_cap >> 1) - QTHETA_OFFSET
    qn = _compute_qn_vec(n2, b, offset, pulse_cap)
    tell0 = K.rk_tell_frac(d)
    has_theta = active & (qn != 1)
    # uniform path (b0 > 1)
    uin = has_theta & (b0 > 1)
    th_u, d = K.rk_dec_uint(d, buf, lens, qn + 1, uin)
    # triangular pdf path (b0 == 1)
    tri = has_theta & (b0 <= 1)
    qh = qn >> 1
    ft = (qh + 1) * (qh + 1)
    fm, d = K.rk_decode(d, ft, tri)
    low = fm < ((qh * (qh + 1)) >> 1)
    th_lo = (_isqrt(8 * fm + 1) - 1) >> 1
    th_hi = (2 * (qn + 1)
             - _isqrt(8 * torch.clamp(ft - fm - 1, min=0) + 1)) >> 1
    th_t = torch.where(low, th_lo, th_hi)
    fs_t = torch.where(low, th_t + 1, qn + 1 - th_t)
    fl_t = torch.where(low, (th_t * (th_t + 1)) >> 1,
                       ft - (((qn + 1 - th_t) * (qn + 2 - th_t)) >> 1))
    d = K.rk_update(d, buf, lens, fl_t, fl_t + fs_t, ft, tri)
    itheta = torch.where(uin, th_u, torch.where(tri, th_t, 0))
    itheta = torch.div(itheta * 16384, torch.clamp(qn, min=1),
                       rounding_mode="floor")
    qalloc = K.rk_tell_frac(d) - tell0
    b = b - qalloc
    ctx = dict(ctx)
    ctx["rb"] = ctx["rb"] - torch.where(active, qalloc, 0)

    th0 = itheta == 0
    th1 = itheta == 16384
    imid = torch.where(th0, 32767,
                       torch.where(th1, 0, _bitexact_cos(itheta)))
    iside = torch.where(th0, 0, torch.where(
        th1, 32767, _bitexact_cos(16384 - itheta)))
    delta_m = _frac_mul16((n2 - 1) << 7, _bitexact_log2tan(iside, imid))
    delta = torch.where(th0, -16384, torch.where(th1, 16384, delta_m))
    fill = torch.where(active & th0, fill & ((1 << bb2) - 1), fill)
    fill = torch.where(active & th1, fill & (((1 << bb2) - 1) << bb2),
                       fill)
    sctx = dict(itheta=itheta, imid=imid, iside=iside, delta=delta)
    return b, fill, sctx, d, ctx


def _quant_partition(d, buf, lens, ctx, tabs: DecTabs, band: int, n: int,
                     lm_node: int, b, bb, bb_vals, lb, lb_has, gain, fill,
                     active):
    """quant_partition decode (bands.c:973) over the static split tree.

    lb: [B, n] f32 folding source (meaningful where lb_has).  Returns
    (cm, x [B, n], d, ctx)."""
    row = tabs.cache_rows[(lm_node, band)]
    bsz = b.shape[0]
    dev = b.device
    split = torch.zeros_like(active)
    if lm_node != -1 and n > 2:
        split = active & (b > row[row[0]] + 12)
    x_split = cm_split = None
    if bool(split.any()):
        n2 = n >> 1
        lm2 = lm_node - 1
        b0 = bb
        fill_s = torch.where(bb == 1, (fill & 1) | (fill << 1), fill)
        bb2 = (bb + 1) >> 1
        bb2_vals = tuple(sorted({(v + 1) >> 1 for v in bb_vals}))
        b_s, fill_s, sctx, d, ctx = _compute_theta_mono(
            d, buf, lens, ctx, tabs, band, n2, b, bb2, b0, lm2, fill_s,
            split)
        itheta = sctx["itheta"]
        mid = sctx["imid"].to(f32) * (1.0 / 32768.0)
        side = sctx["iside"].to(f32) * (1.0 / 32768.0)
        delta = sctx["delta"]
        nonzero_th = (itheta & 0x3fff) != 0
        d_hi = delta - (delta >> (4 - lm2))
        d_lo = torch.clamp(delta + (n2 << BITRES >> (5 - lm2)), max=0)
        delta = torch.where((b0 > 1) & nonzero_th,
                            torch.where(itheta > 8192, d_hi, d_lo), delta)
        mbits = torch.clamp(torch.minimum(
            b_s, torch.div(b_s - delta, 2, rounding_mode="floor")), min=0)
        sbits = b_s - mbits
        swap = split & (mbits < sbits)
        sw = swap[:, None]
        lb_lo, lb_hi = lb[:, :n2], lb[:, n2:]
        rb_before = ctx["rb"]
        b_v0 = torch.where(swap, sbits, mbits)
        g_v0 = gain * torch.where(swap, side, mid)
        f_v0 = torch.where(swap, fill_s >> bb2, fill_s)
        cm0, x0, d, ctx = _quant_partition(
            d, buf, lens, ctx, tabs, band, n2, lm2, b_v0, bb2, bb2_vals,
            torch.where(sw, lb_hi, lb_lo), lb_has, g_v0, f_v0, split)
        spent = rb_before - ctx["rb"]
        rebalance = b_v0 - spent
        anchor = torch.where(swap, 16384, 0)
        extra = torch.where(split & (rebalance > (3 << BITRES))
                            & (itheta != anchor),
                            rebalance - (3 << BITRES), 0)
        b_v1 = torch.where(swap, mbits, sbits) + extra
        g_v1 = gain * torch.where(swap, mid, side)
        f_v1 = torch.where(swap, fill_s, fill_s >> bb2)
        cm1, x1, d, ctx = _quant_partition(
            d, buf, lens, ctx, tabs, band, n2, lm2, b_v1, bb2, bb2_vals,
            torch.where(sw, lb_lo, lb_hi), lb_has, g_v1, f_v1, split)
        x_split = torch.cat([torch.where(sw, x1, x0),
                             torch.where(sw, x0, x1)], dim=1)
        cm_x = torch.where(swap, cm1, cm0)
        cm_y = torch.where(swap, cm0, cm1)
        cm_split = cm_x | (cm_y << (b0 >> 1))
    leaf_active = active & ~split

    # ---- leaf: PVQ / noise / fold ----
    x_leaf = torch.zeros((bsz, n), dtype=f32, device=dev)
    cm_leaf = torch.zeros_like(b)
    if bool(leaf_active.any()):
        L = row[0]
        rowj = const(("row", lm_node, band), lambda: np.asarray(row, np.int64),
                    dev)
        bm1 = b - 1
        lo = (bm1[:, None] > rowj[None, 1:L + 1]).sum(dim=1)
        hi = torch.clamp(lo + 1, max=L)
        lo_val = torch.where(lo == 0, -1, rowj[lo.clamp(0, L)])
        hi_val = rowj[hi]
        q = torch.where(bm1 - lo_val <= hi_val - bm1, lo, hi)
        # bit-budget reduction loop, closed form
        c_fit = (ctx["rb"][:, None] >= rowj[None, 1:L + 1] + 1).sum(dim=1)
        q = torch.clamp(torch.minimum(q, c_fit), min=0)
        bits_used = torch.where(q > 0, rowj[q.clamp(0, L)] + 1, 0)
        ctx = dict(ctx)
        ctx["rb"] = ctx["rb"] - torch.where(leaf_active, bits_used, 0)
        kq = torch.where(q < 8, q,
                         (8 + (q & 7)) << ((q >> 3) - 1).clamp_min(0))
        kcap = min(int(get_pulses(L)), _MAX_K)
        pvq = leaf_active & (kq != 0)
        if bool(pvq.any()):
            iy, d = _decode_pulses(d, buf, lens, n, kq, kcap, pvq)
            ryy = (iy * iy).to(f32).sum(dim=1)
            g = gain * torch.rsqrt(torch.clamp(ryy, min=1e-30))
            x_pvq = iy.to(f32) * g[:, None]
            x_pvq = _exp_rotation_dec(x_pvq, n, bb, bb_vals, kq,
                                      ctx["spread"], pvq)
            cm_pvq = _collapse_mask_arr(iy, n, bb, bb_vals, pvq)
            x_leaf = torch.where(pvq[:, None], x_pvq, x_leaf)
            cm_leaf = torch.where(pvq, cm_pvq, cm_leaf)

        # q == 0: noise / fold (closed-form LCG chains)
        cm_mask = (1 << bb) - 1
        fillm = fill & cm_mask
        act_nf = leaf_active & (kq == 0) & (fillm != 0)
        if bool(act_nf.any()):
            fold = act_nf & lb_has
            noise = act_nf & ~fold
            seed = ctx["seed"]
            a_p, c_s = _lcg_tabs(n)
            ap = const(("lcg_a", n), lambda: a_p[1:n + 1].astype(np.int64),
                      dev)
            cs = const(("lcg_c", n), lambda: c_s[1:n + 1].astype(np.int64),
                      dev)
            seeds = (ap[None, :] * seed[:, None] + cs[None, :]) & M32
            nval = (_to_i32(seeds) >> 20).to(f32)
            fval = lb + torch.where((seeds & 0x8000) != 0, 1.0 / 256,
                                    -1.0 / 256)
            x_nf = torch.where(fold[:, None], fval, nval)
            ctx["seed"] = torch.where(
                act_nf, (int(a_p[n]) * seed + int(c_s[n])) & M32, seed)
            x_nf = _renormalise_arr(x_nf, gain, act_nf)
            cm_nf = torch.where(fold, fillm, torch.where(noise, cm_mask, 0))
            x_leaf = torch.where(act_nf[:, None], x_nf, x_leaf)
            cm_leaf = torch.where(act_nf, cm_nf, cm_leaf)

    if x_split is None:
        return cm_leaf, x_leaf, d, ctx
    x_out = torch.where(split[:, None], x_split, x_leaf)
    cm_out = torch.where(split, cm_split, cm_leaf)
    return cm_out, x_out, d, ctx


def _fill_interleave(fill):
    lo = _lut(BIT_INTERLEAVE_TABLE, fill & 0xF)
    hi = _lut(BIT_INTERLEAVE_TABLE, (fill >> 4) & 0xF)
    return lo | (hi << 2)


def _quant_band_n1(d, buf, lens, ctx, active):
    can = active & (ctx["rb"] >= (1 << BITRES))
    sign, d = K.rk_dec_bits(d, buf, lens, torch.where(can, 1, 0), can)
    ctx = dict(ctx)
    ctx["rb"] = ctx["rb"] - torch.where(can, 1 << BITRES, 0)
    x0 = torch.where(sign != 0, -NORM, NORM).to(f32)
    return torch.ones_like(sign), x0[:, None], d, ctx


@lru_cache(maxsize=None)
def _band_variants(lm: int, n: int):
    """Static (transient, tf) -> transform plan enumeration for one
    band."""
    out = []
    for tv in (0, 1):
        row = TF_SELECT_TABLE[lm]
        vals = sorted({row[4 * tv + c] for c in range(4)})
        for tfv in vals:
            b0 = (1 << lm) if tv else 1
            recombine = max(tfv, 0)
            n_b = n // b0
            bb = b0 >> recombine
            n_b <<= recombine
            tdiv = 0
            tfc = tfv
            while (n_b & 1) == 0 and tfc < 0:
                bb <<= 1
                n_b >>= 1
                tdiv += 1
                tfc += 1
            out.append(dict(tv=tv, tfv=tfv, B0=b0, recombine=recombine,
                            tdiv=tdiv, b0_final=bb, n_b0=n_b,
                            long=(b0 == 1)))
    return tuple(out)


def _quant_band_mono(d, buf, lens, ctx, tabs: DecTabs, band: int, n: int,
                     b, transient, tf_change, lb, lb_has, fill, active,
                     gain=None):
    """quant_band, mono decode (bands.c:1245).  lb: [B, n]; gain: [B]
    f32 (1 by default; a stereo band's side takes its own).  Returns (cm,
    x [B, n], d, ctx)."""
    if n == 1:
        return _quant_band_n1(d, buf, lens, ctx, active)
    variants = _band_variants(tabs.lm, n)
    masks = [active & (transient == v["tv"]) & (tf_change == v["tfv"])
             for v in variants]
    taken = [bool(m.any()) for m in masks]

    # ---- input-side transforms (lowband + fill) ----
    lb_f = lb
    fill_f = fill
    bb_lanes = torch.zeros_like(fill)
    bb_vals = set()
    for v, m, tk in zip(variants, masks, taken):
        if not tk:
            continue
        lbv = lb
        fillv = fill
        for kk in range(v["recombine"]):
            lbv = _haar1_arr(lbv, n >> kk, 1 << kk)
            fillv = _fill_interleave(fillv)
        bb = v["B0"] >> v["recombine"]
        n_b = (n // v["B0"]) << v["recombine"]
        for _ in range(v["tdiv"]):
            lbv = _haar1_arr(lbv, n_b, bb)
            fillv = fillv | (fillv << bb)
            bb <<= 1
            n_b >>= 1
        if v["b0_final"] > 1:
            lbv = _deinterleave_hadamard_arr(
                lbv, v["n_b0"] >> v["recombine"],
                v["b0_final"] << v["recombine"], v["long"])
        lb_f = torch.where(m[:, None], lbv, lb_f)
        fill_f = torch.where(m, fillv, fill_f)
        bb_lanes = torch.where(m, v["b0_final"], bb_lanes)
        bb_vals.add(v["b0_final"])

    cm, x, d, ctx = _quant_partition(
        d, buf, lens, ctx, tabs, band, n, tabs.lm, b, bb_lanes,
        tuple(sorted(bb_vals)), lb_f, lb_has,
        torch.ones_like(b, dtype=f32) if gain is None else gain, fill_f,
        active)

    # ---- resynth-side transforms (x + cm) ----
    x_out = x
    cm_out = cm
    for v, m, tk in zip(variants, masks, taken):
        if not tk:
            continue
        xv = x
        cmv = cm
        bb = v["b0_final"]
        n_b = v["n_b0"]
        if bb > 1:
            xv = _interleave_hadamard_arr(xv, n_b >> v["recombine"],
                                          bb << v["recombine"], v["long"])
        for _ in range(v["tdiv"]):
            bb >>= 1
            n_b <<= 1
            cmv = cmv | (cmv >> bb)
            xv = _haar1_arr(xv, n_b, bb)
        for kk in range(v["recombine"]):
            cmv = _lut(BIT_DEINTERLEAVE_TABLE, cmv.clamp(0, 15))
            xv = _haar1_arr(xv, n >> kk, 1 << kk)
        bb <<= v["recombine"]
        cmv = cmv & ((1 << bb) - 1)
        x_out = torch.where(m[:, None], xv, x_out)
        cm_out = torch.where(m, cmv, cm_out)
    return cm_out, x_out, d, ctx


def _fold_plan(M: int, eB: list, start: int = 0):
    """Static per-band folding windows (bands.c:1766-1776): for band i,
    one (lowband_offset lo, window start eff, fold range [fs_, fe_))
    entry per band lo that lowband_offset can hold.  Windows are absolute
    positions in the norm buffer, which holds nothing below norm_offset =
    M*eB[start], so eff is clamped there."""
    norm_offset = M * eB[start]
    plans = []
    for i in range(len(eB) - 1):
        n = M * (eB[i + 1] - eB[i])
        entries = []
        for lo in range(start + 1, i + 1):
            if not (M * eB[lo] - M * (eB[lo + 1] - eB[lo]) >= norm_offset
                    or lo == start + 1):
                continue
            eff = max(norm_offset, M * eB[lo] - n)
            fs_ = lo
            while True:
                fs_ -= 1
                if M * eB[fs_] <= eff:
                    break
            fe_ = lo - 1
            while True:
                fe_ += 1
                if not (fe_ < i and M * eB[fe_] < eff + n):
                    break
            entries.append((lo, eff, fs_, max(fe_, fs_ + 1)))
        plans.append(tuple(entries))
    return tuple(plans)


def _hybrid_fold(norm, tabs: DecTabs):
    """special_hybrid_folding (bands.c; scalar celt/bands.py:1196):
    before band start+1, copy the n2 - n1 norm coefficients below
    norm_offset + n1 to norm_offset + n1, so band start+1's fold window
    is full.  A no-op when the two bands have one width (start 0)."""
    M, eB, start = tabs.M, [int(v) for v in tabs.eBands], tabs.start
    off = M * eB[start]
    n1 = M * (eB[start + 1] - eB[start])
    n2 = M * (eB[start + 2] - eB[start + 1])
    if n2 <= n1:
        return norm
    norm = norm.clone()
    norm[:, off + n1:off + n2] = norm[:, off + 2 * n1 - n2:off + n1]
    return norm


def _compute_theta_stereo(d, buf, lens, ctx, tabs: DecTabs, band: int,
                          n: int, b, bb, fill, intensity, disable_inv: bool,
                          active):
    """compute_theta's stereo branch, decode (bands.py:588-749): the step
    pdf for N > 2, a uniform angle for N = 2, the inversion bit where the
    intensity band is reached.  Returns (b, fill, inv, itheta, imid,
    iside, delta, qalloc, d)."""
    lm = tabs.lm
    pulse_cap = tabs.logN[band] + lm * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE if n == 2
                                 else QTHETA_OFFSET)
    # compute_qn with stereo: N2 = 2N - 1, less one at N = 2
    qn = compute_qn_n2(2 * n - 1 - (1 if n == 2 else 0), b, offset,
                       pulse_cap)
    qn = torch.where(band >= intensity, 1, qn)
    tell0 = K.rk_tell_frac(d)
    has = active & (qn != 1)
    if n > 2:
        # the step pdf (bands.py:640-656)
        x0 = qn >> 1
        ft = 3 * (x0 + 1) + x0
        fs, d = K.rk_decode(d, torch.where(has, ft, 1), has)
        low = fs < (x0 + 1) * 3
        xq = torch.where(low, torch.div(fs, 3, rounding_mode="floor"),
                         x0 + 1 + (fs - (x0 + 1) * 3))
        fl = torch.where(xq <= x0, 3 * xq, (xq - 1 - x0) + (x0 + 1) * 3)
        fh = torch.where(xq <= x0, 3 * (xq + 1), (xq - x0) + (x0 + 1) * 3)
        d = K.rk_update(d, buf, lens, fl, fh, ft, has)
        th = xq
    else:
        th, d = K.rk_dec_uint(d, buf, lens, qn + 1, has)
    itheta = torch.where(has, torch.div(th * 16384, torch.clamp(qn, min=1),
                                        rounding_mode="floor"), 0)
    # qn == 1: the inversion flag (bands.py:712-719)
    one = active & (qn == 1)
    inv_rd = one & (b > (2 << BITRES)) & (ctx["rb"] > (2 << BITRES))
    inv_bit, d = K.rk_dec_bit_logp(d, buf, lens, 2, inv_rd)
    inv = inv_rd & (inv_bit != 0) & (not disable_inv)
    qalloc = K.rk_tell_frac(d) - tell0
    b = b - qalloc
    th0 = itheta == 0
    th1 = itheta == 16384
    imid = torch.where(th0, 32767,
                       torch.where(th1, 0, _bitexact_cos(itheta)))
    iside = torch.where(th0, 0, torch.where(
        th1, 32767, _bitexact_cos(16384 - itheta)))
    delta_m = _frac_mul16((n - 1) << 7, _bitexact_log2tan(iside, imid))
    delta = torch.where(th0, -16384, torch.where(th1, 16384, delta_m))
    fill = torch.where(active & th0, fill & ((1 << bb) - 1), fill)
    fill = torch.where(active & th1, fill & (((1 << bb) - 1) << bb), fill)
    return b, fill, inv, itheta, imid, iside, delta, qalloc, d


def _stereo_merge(x, y, mid, active):
    """stereo_merge (bands.py:538) on lanes: mid [B] f32."""
    xp = (y * x).sum(dim=1)
    side = (y * y).sum(dim=1)
    xp = mid * xp
    mm = mid * mid
    el = mm + side - 2 * xp
    er = mm + side + 2 * xp
    copy = (er < 6e-4) | (el < 6e-4)
    lgain = 1.0 / torch.sqrt(torch.where(copy, 1.0, el))
    rgain = 1.0 / torch.sqrt(torch.where(copy, 1.0, er))
    l_ = mid[:, None] * x
    xm = lgain[:, None] * (l_ - y)
    ym = rgain[:, None] * (l_ + y)
    xm = torch.where(copy[:, None], x, xm)
    ym = torch.where(copy[:, None], x, ym)
    a = active[:, None]
    return torch.where(a, xm, x), torch.where(a, ym, y)


def _quant_band_stereo(d, buf, lens, ctx, tabs: DecTabs, band: int, n: int,
                       b, transient, tf_change, lb, lb_has, fill, intensity,
                       disable_inv: bool, active):
    """quant_band_stereo, decode (bands.py:1084) for N > 1: the angle, then
    mid and side as mono bands (the larger first), the N = 2 rotation,
    the merge, the inversion.  Returns (cm, x [B, n], y [B, n], mid_out
    [B, n] (the vector lowband_out holds, before the merge), d, ctx)."""
    bb = torch.where(transient != 0, tabs.M, 1)
    orig_fill = fill
    b, fill, inv, itheta, imid, iside, delta, qalloc, d = \
        _compute_theta_stereo(d, buf, lens, ctx, tabs, band, n, b, bb, fill,
                              intensity, disable_inv, active)
    mid = imid.to(f32) * (1.0 / 32768.0)
    side = iside.to(f32) * (1.0 / 32768.0)
    ctx = dict(ctx)
    if n == 2:
        sbits = torch.where((itheta != 0) & (itheta != 16384),
                            1 << BITRES, 0)
        mbits = b - sbits
        cflip = itheta > 8192
        ctx["rb"] = ctx["rb"] - torch.where(active, qalloc + sbits, 0)
        srd = active & (sbits != 0)
        sgn, d = K.rk_dec_bits(d, buf, lens, torch.where(srd, 1, 0), srd)
        sign = (1 - 2 * torch.where(srd, sgn, 0)).to(f32)
        cm, v, d, ctx = _quant_band_mono(
            d, buf, lens, ctx, tabs, band, 2, mbits, transient, tf_change,
            lb, lb_has, orig_fill, active)
        r = torch.stack([-sign * v[:, 1], sign * v[:, 0]], dim=1)
        cf = cflip[:, None]
        x = torch.where(cf, r, v) * mid[:, None]
        y = torch.where(cf, v, r) * side[:, None]
        xo = torch.stack([x[:, 0] - y[:, 0], x[:, 1] - y[:, 1]], dim=1)
        yo = torch.stack([x[:, 0] + y[:, 0], x[:, 1] + y[:, 1]], dim=1)
        mid_out = v
    else:
        mbits = torch.clamp(torch.minimum(
            b, torch.div(b - delta, 2, rounding_mode="floor")), min=0)
        sbits = b - mbits
        ctx["rb"] = ctx["rb"] - torch.where(active, qalloc, 0)
        rb0 = ctx["rb"]
        swap = mbits < sbits           # the side first
        sw = swap[:, None]
        one = torch.ones_like(mid)
        bb_fill = fill >> bb
        b1 = torch.where(swap, sbits, mbits)
        cm1, v1, d, ctx = _quant_band_mono(
            d, buf, lens, ctx, tabs, band, n, b1, transient, tf_change,
            lb, lb_has & ~swap, torch.where(swap, bb_fill, fill), active,
            gain=torch.where(swap, side, one))
        reb = b1 - (rb0 - ctx["rb"])
        anchor = torch.where(swap, 16384, 0)
        extra = torch.where((reb > (3 << BITRES)) & (itheta != anchor),
                            reb - (3 << BITRES), 0)
        b2 = torch.where(swap, mbits, sbits) + extra
        cm2, v2, d, ctx = _quant_band_mono(
            d, buf, lens, ctx, tabs, band, n, b2, transient, tf_change,
            lb, lb_has & swap, torch.where(swap, fill, bb_fill), active,
            gain=torch.where(swap, one, side))
        cm = cm1 | cm2
        x = torch.where(sw, v2, v1)
        y = torch.where(sw, v1, v2)
        mid_out = x
        xo, yo = _stereo_merge(x, y, mid, active)
    yo = torch.where(inv[:, None], -yo, yo)
    return cm, xo, yo, mid_out, d, ctx


def _quant_band_two(d, buf, lens, ctx, tabs: DecTabs, band: int, n: int, b,
                    transient, tf_change, lbs, lb_has, cms, dual, intensity,
                    disable_inv: bool, active):
    """One band of a two-channel frame (bands.py:1287-1345): N = 1 (a sign
    each), dual stereo (each channel a mono band on half the bits, from
    its own fold) or mid/side.  Returns ([x, y], [cm_x, cm_y], the vector
    the fold memory keeps, d, ctx)."""
    xb = torch.zeros((b.shape[0], n), dtype=f32, device=b.device)
    yb = torch.zeros_like(xb)
    out1 = xb
    cmx = torch.zeros_like(cms[0])
    cmy = torch.zeros_like(cms[0])
    if n == 1:
        cmx, xb, d, ctx = _quant_band_n1(d, buf, lens, ctx, active)
        cmy, yb, d, ctx = _quant_band_n1(d, buf, lens, ctx, active)
        return [xb, yb], [cmx, cmy], xb, d, ctx
    if bool(dual.any()):
        half = b >> 1
        c1, v1, d, ctx = _quant_band_mono(
            d, buf, lens, ctx, tabs, band, n, half, transient, tf_change,
            lbs[0], lb_has, cms[0], dual)
        c2, v2, d, ctx = _quant_band_mono(
            d, buf, lens, ctx, tabs, band, n, half, transient, tf_change,
            lbs[1], lb_has, cms[1], dual)
        dm = dual[:, None]
        xb = torch.where(dm, v1, xb)
        yb = torch.where(dm, v2, yb)
        out1 = torch.where(dm, v1, out1)
        cmx = torch.where(dual, c1, cmx)
        cmy = torch.where(dual, c2, cmy)
    ms = active & ~dual
    if bool(ms.any()):
        c, xs, ys, mo, d, ctx = _quant_band_stereo(
            d, buf, lens, ctx, tabs, band, n, b, transient, tf_change,
            lbs[0], lb_has, cms[0] | cms[1], intensity, disable_inv, ms)
        mm = ms[:, None]
        xb = torch.where(mm, xs, xb)
        yb = torch.where(mm, ys, yb)
        out1 = torch.where(mm, mo, out1)
        cmx = torch.where(ms, c, cmx)
        cmy = torch.where(ms, c, cmy)
    return [xb, yb], [cmx, cmy], out1, d, ctx


def quant_all_bands(d, buf, lens, tabs: DecTabs, plan, total_bits8, balance,
                    seed, active, C: int = 1, disable_inv: bool = False):
    """bands.c:1589 (bands.py:1210), decode over bands [start, end) with C
    coded channels.  total_bits8: per-lane 8th-bits budget (len*8*8 -
    anti_collapse_rsv); disable_inv: the decoder's flag (C = 2).  Returns
    (X, per channel [B, nx], zero outside the coded bands; collapse, per
    channel list[nb]; seed, d)."""
    nb = tabs.nb
    start, end = tabs.start, tabs.end_band
    M = tabs.M
    eB = [int(v) for v in tabs.eBands]
    norm_offset = M * eB[start]
    norm_total = M * eB[nb - 1]
    bsz = balance.shape[0]
    dev = balance.device
    # the fold memory of each channel (the second one only dual stereo
    # writes)
    norms = [torch.zeros((bsz, norm_total), dtype=f32, device=dev)
             for _ in range(C)]
    collapse = [[torch.zeros_like(balance) for _ in range(nb)]
                for _ in range(C)]
    X = [[torch.zeros((bsz, norm_offset), dtype=f32, device=dev)]
         for _ in range(C)]
    transient = plan["is_transient"]
    B_lanes = torch.where(transient != 0, M, 1)
    spread = plan["spread"]
    coded_bands = plan["coded_bands"]
    pulses = plan["pulses"]
    intensity = plan["intensity"]
    dual = plan["dual_stereo"] & active if C == 2 else None
    ctx = dict(rb=torch.zeros_like(balance), seed=seed, spread=spread)
    lowband_offset = torch.zeros_like(balance)
    update_lowband = torch.ones_like(balance, dtype=torch.bool)
    folds = tabs.fold_plan

    for i in range(start, end):
        n = M * (eB[i + 1] - eB[i])
        tell = K.rk_tell_frac(d)
        if i != start:
            balance = balance - tell
        remaining_bits = total_bits8 - tell - 1
        ctx["rb"] = remaining_bits
        in_coded = i <= coded_bands - 1
        den = torch.clamp(coded_bands - i, 1, 3)
        curr_balance = _sudiv(balance, den)
        b = torch.where(in_coded, torch.clamp(torch.minimum(
            remaining_bits + 1, pulses[i] + curr_balance), 0, 16383), 0)

        # lowband_offset update (per-lane); bands.c:1738
        if M * eB[i] - n >= norm_offset or i == start + 1:
            upd = active & (update_lowband | (lowband_offset == 0))
            lowband_offset = torch.where(upd, i, lowband_offset)
        if i == start + 1:
            norms = [_hybrid_fold(nm, tabs) for nm in norms]

        tf_change = plan["tf_res"][i]
        # folding source selection
        fold_cond = active & (lowband_offset != 0) \
            & ((spread != SPREAD_AGGRESSIVE) | (B_lanes > 1)
               | (tf_change < 0))
        if C == 2:
            # dual stereo ends at the intensity band: the fold memory
            # becomes the average of the two (bands.py:1305-1309)
            stop = dual & (intensity == i)
            if bool(stop.any()):
                a, z = norm_offset, M * eB[i]
                avg = 0.5 * (norms[0][:, a:z] + norms[1][:, a:z])
                norms[0] = norms[0].clone()
                norms[0][:, a:z] = torch.where(stop[:, None], avg,
                                               norms[0][:, a:z])
                dual = dual & ~stop
        lbs = [torch.zeros((bsz, n), dtype=f32, device=dev)] * C
        cms = [torch.where(fold_cond, 0, (1 << B_lanes) - 1)] * C
        for lo, eff, fs_, fe_ in folds[i]:
            mv = fold_cond & (lowband_offset == lo)
            for c in range(C):
                cmv = torch.zeros_like(cms[c])
                for fi in range(fs_, fe_):
                    cmv = cmv | collapse[c][fi]
                # norm window [eff, eff+n) (zero-padded past norm_total)
                if eff + n <= norm_total:
                    win = norms[c][:, eff:eff + n]
                else:
                    win = torch.cat([norms[c][:, eff:], torch.zeros(
                        (bsz, eff + n - norm_total), dtype=f32,
                        device=dev)], dim=1)
                lbs[c] = torch.where(mv[:, None], win, lbs[c])
                cms[c] = torch.where(mv, cmv, cms[c])

        if C == 1:
            cm, x_band, d, ctx = _quant_band_mono(
                d, buf, lens, ctx, tabs, i, n, b, transient, tf_change,
                lbs[0], fold_cond, cms[0], active)
            xs, cm_c, out1 = [x_band], [cm], x_band
        else:
            xs, cm_c, out1, d, ctx = _quant_band_two(
                d, buf, lens, ctx, tabs, i, n, b, transient, tf_change, lbs,
                fold_cond, cms, dual, intensity, disable_inv, active)
        for c in range(C):
            collapse[c][i] = torch.where(active, cm_c[c] & 0xFF, 0)
            X[c].append(xs[c])
        if i != end - 1:
            base = M * eB[i]
            nrm = math.sqrt(n)
            norms[0] = norms[0].clone()
            norms[0][:, base:base + n] = torch.where(
                active[:, None], nrm * out1, norms[0][:, base:base + n])
            if C == 2:
                norms[1] = norms[1].clone()
                norms[1][:, base:base + n] = torch.where(
                    dual[:, None], nrm * xs[1], norms[1][:, base:base + n])
        balance = balance + pulses[i] + tell
        update_lowband = b > (n << BITRES)

    tail = torch.zeros((bsz, tabs.nx - M * eB[end]), dtype=f32, device=dev)
    return ([torch.cat(x + [tail], dim=1) for x in X], collapse,
            ctx["seed"], d)


# ===================================================================== #
# anti-collapse + finalize + top level                                  #
# ===================================================================== #

def _anti_collapse(tabs: DecTabs, X, collapse, pulses, energies, prevmin,
                   seed, active, bands=None):
    """anti_collapse (bands.c:259), mono decode.  energies: the finalised
    band energies (as libopus, the scalar decoder and the Pallas kernel
    use them; celt_dec_fused passes the pre-finalise ones); prevmin: list
    of nb [B] f32, min(prev1, prev2) per band; bands: the (lo, hi) range
    to fill (default the coded bands; a stereo frame runs one band of
    one channel at a time)."""
    lm = tabs.lm
    kk = 1 << lm
    eB = [int(v) for v in tabs.eBands]
    bsz = seed.shape[0]
    dev = seed.device
    lo_b, hi_b = (tabs.start, tabs.end_band) if bands is None else bands
    segs = [X[:, :eB[lo_b] << lm]]
    kb = torch.arange(kk, device=dev)
    for i in range(lo_b, hi_b):
        n0 = eB[i + 1] - eB[i]
        depth = torch.div(1 + pulses[i], n0,
                          rounding_mode="floor") >> lm
        thresh = 0.5 * torch.exp2(-0.125 * depth.to(f32))
        sqrt_1 = 1.0 / math.sqrt(n0 << lm)
        ediff = torch.clamp(energies[i] - prevmin[i], min=0.0)
        r = 2.0 * torch.exp2(-ediff)
        if lm == 3:
            r = r * 1.41421356
        r = torch.minimum(thresh, r) * sqrt_1
        base = eB[i] << lm
        nband = n0 << lm
        # each missing block k advances the seed by n0 steps, in order
        miss = active[:, None] & (((collapse[i][:, None] >> kb) & 1) == 0)
        pre = torch.cumsum(miss.to(i64), dim=1) - miss.to(i64)
        a_p, c_s = _lcg_tabs(n0 * kk)
        ap = const(("lcg_a0", n0 * kk), lambda: a_p.astype(np.int64), dev)
        cs = const(("lcg_c0", n0 * kk), lambda: c_s.astype(np.int64), dev)
        idx = (pre * n0)[:, :, None] \
            + torch.arange(n0, device=dev)[None, None, :] + 1
        seeds = (ap[idx] * seed[:, None, None] + cs[idx]) & M32
        v = torch.where((seeds & 0x8000) != 0, r[:, None, None],
                        -r[:, None, None])                   # [B, K, n0]
        seg = X[:, base:base + nband].reshape(bsz, n0, kk)
        seg = torch.where(miss[:, None, :], v.transpose(1, 2), seg)
        seg = seg.reshape(bsz, nband)
        total = pre[:, -1] + miss[:, -1].to(i64)
        sidx = (total * n0).clamp(0, n0 * kk)
        seed = (ap[sidx] * seed + cs[sidx]) & M32
        seg = _renormalise_arr(seg, torch.ones_like(r), miss.any(dim=1))
        segs.append(seg)
    segs.append(X[:, eB[hi_b] << lm:])
    return torch.cat(segs, dim=1), seed


def fused_celt_decode_frame(buf, lens, old_e, prevmin, seed,
                            tabs: DecTabs, active, d0=None,
                            disable_inv: bool = False):
    """Full CELT frame symbol decode: plan + bands + anti-collapse +
    energy finalise (celt_decoder.c:1209-1560 below packet parse), mono
    or with two coded channels.

    buf: [B, P] packet bytes; lens/seed: [B]; old_e/prevmin: lists of nb
    [B] f32, one list for a mono frame or a list of two (one a channel)
    for a two-channel frame.  d0: optional live range-decoder state to
    continue from in place of ``rk_init`` (a hybrid frame's CELT half
    continues SILK's coder, src/opus_decoder.c:432); disable_inv: the
    decoder's flag (set on a decoder with one output channel,
    opus_decoder.py:42).  Returns (out dict, final range-decoder state);
    out's X is [B, nx] (mono) or [B, 2, nx], its energies and collapse
    masks are laid out as old_e."""
    C = 2 if isinstance(old_e[0], (list, tuple)) else 1
    old_e, prevmin = (old_e, prevmin) if C == 2 else ([old_e], [prevmin])
    d = K.rk_init(buf, lens) if d0 is None else d0
    plan, d = fused_plan(d, buf, lens, tabs, old_e, active)
    live = plan["live"]
    total_bits8 = (lens * 8 << BITRES) - plan["anti_collapse_rsv"]
    Xs, collapse, seed, d = quant_all_bands(
        d, buf, lens, tabs, plan, total_bits8, plan["balance"], seed, live,
        C, disable_inv)
    # anti-collapse flag
    ac_read = live & (plan["anti_collapse_rsv"] > 0)
    ac_on, d = K.rk_dec_bits(d, buf, lens, torch.where(ac_read, 1, 0),
                             ac_read)
    # energy finalise (quant_bands.c unquant_energy_finalise): a band takes
    # one bit a channel while C bits are left
    energies = [list(e) for e in plan["energies"]]
    bits_left = lens * 8 - K.rk_tell(d)
    for prio in (0, 1):
        for i in range(tabs.start, tabs.end_band):
            can = live & (bits_left >= C) \
                & (plan["ebits"][i] < MAX_FINE_BITS) \
                & (plan["fine_priority"][i] == prio)
            for e in energies:
                q2, d = K.rk_dec_bits(d, buf, lens, torch.where(can, 1, 0),
                                      can)
                off = (q2.to(f32) - 0.5) \
                    * torch.exp2(-(plan["ebits"][i] + 1).to(f32))
                e[i] = torch.where(can, e[i] + off, e[i])
            bits_left = bits_left - C * can.to(i64)
    # anti-collapse application: one LCG, band by band and channel by
    # channel (at C = 1 all bands in one call)
    do_ac = live & (ac_on != 0)
    spans = [(tabs.start, tabs.end_band)] if C == 1 else [
        (i, i + 1) for i in range(tabs.start, tabs.end_band)]
    for span in spans:
        for c in range(C):
            xa, seed = _anti_collapse(tabs, Xs[c], collapse[c],
                                      plan["pulses"], energies[c],
                                      prevmin[c], seed, do_ac, bands=span)
            Xs[c] = torch.where(do_ac[:, None], xa, Xs[c])
    if C == 1:
        X, collapse, energies = Xs[0], collapse[0], energies[0]
    else:
        X = torch.stack(Xs, dim=1)
    out = dict(plan, X=X, collapse=collapse, energies=energies,
               anti_collapse_on=ac_on, seed=seed)
    return out, d


def fused_celt_init_state(batch: int, tabs: DecTabs, device="cpu",
                          out_channels: int = 1):
    """Per-stream decoder state (celt_decoder.c reset values) as a dict
    of tensors: old_e/prev1/prev2 [B, nb], seed [B], the postfilter
    phases, the synthesis state ``dsp``, and the loss state of the
    packet-loss concealment (``celt/plc.py``): the background energies
    [B, nb], the loss counters (2.5 ms units), ``skip_plc``, the last
    frame's type, the fold flag and the extrapolated overlap it folds
    (``fold`` [B, overlap]), the last PLC period and LPC ([B, 24] f64),
    the final range of the last decoded packet and whether the lane has
    decoded one.  Both channels' energy memory is kept, as libopus keeps
    2 x nbEBands, so a stream may switch between mono and stereo packets:
    the second channel's old_e (``e_copy``), ``prev1_1``, ``prev2_1`` and
    ``background_1`` (a mono frame copies its energies there).
    out_channels=2: the second output channel's synthesis state,
    concealment LPC and fold (``dsp_1``, ``plc_lpc_1``, ``fold_1``)."""
    from .batched_decode import init_state as dsp_init

    nb = tabs.nb
    zf = torch.zeros(batch, dtype=f32, device=device)
    zi = torch.zeros(batch, dtype=i64, device=device)
    low = torch.full((batch, nb), -28.0, dtype=f32, device=device)
    st = dict(
        old_e=torch.zeros((batch, nb), dtype=f32, device=device),
        prev1=low.clone(), prev2=low.clone(),
        seed=zi.clone(),
        pf_period=torch.full((batch,), 15, dtype=i64, device=device),
        pf_period_old=torch.full((batch,), 15, dtype=i64, device=device),
        pf_gain=zf.clone(), pf_gain_old=zf.clone(),
        pf_tapset=zi.clone(), pf_tapset_old=zi.clone(),
        dsp=dsp_init(batch, tabs.mode.overlap, device=device),
        background=low.clone(),
        e_copy=torch.zeros((batch, nb), dtype=f32, device=device),
        prev1_1=low.clone(), prev2_1=low.clone(), background_1=low.clone(),
        loss_duration=zi.clone(), plc_duration=zi.clone(),
        skip_plc=torch.ones(batch, dtype=i64, device=device),
        last_frame_type=zi.clone(), prefilter_and_fold=zi.clone(),
        last_pitch_index=zi.clone(),
        plc_lpc=torch.zeros((batch, 24), dtype=torch.float64,
                            device=device),
        fold=torch.zeros((batch, tabs.mode.overlap), dtype=f32,
                         device=device),
        rng_final=zi.clone(),
        decoded_any=torch.zeros(batch, dtype=torch.bool, device=device))
    if out_channels == 2:
        st.update(dsp_1=dsp_init(batch, tabs.mode.overlap, device=device),
                  plc_lpc_1=st["plc_lpc"].clone(), fold_1=st["fold"].clone())
    return st
