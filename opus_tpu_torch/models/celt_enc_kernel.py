"""PCM -> packets at 20 ms with the encode symbol pass of kernel K3.

Port of ``opus_tpu/models/celt_enc_kernel.py``: the analysis front end
(``_front_end``), the symbol pass (``_symbol_pass``, here
``encode_frame_plain``), the state carry (``_assemble_state``), the frame
step (``kernel_celt_encode_frame``) and ``KernelCeltEncoder``.

``encode_frame`` is the wrapper of kernel K3: a CPU tensor runs the plain
torch symbol pass (``encode_frame_plain``), a CUDA tensor launches the
hand-written CUDA kernel (``opus_tpu_torch/csrc/celt_enc_frame.cu``) or
raises.  Both own the range coder from ``ec_enc_init`` to the packet
bytes: the three header bits (silence, postfilter off, transient), the
symbol pass, ``ec_enc_done`` and the carry resolution.  The front end
decides the header bits' values with a dry tell tracker (their tells are
fixed under CBR), so the plain version and K3 take the same inputs.

The JAX module's TPU-only parts are gone: the ``batch % 1024`` rule, the
[.., R, 128] packing, the preorder node program (a Python recursion over
the band tree here, an explicit stack in K3) and the MXU wrap matmul (a
per-output fused multiply-add chain over n in index order, which is the
JAX twin's BLAS order: float64 products and sums rounded to float32 here,
``fmaf`` in K3).

Scope: mono, CBR, prefilter off, 48 kHz, LM >= 2.
Reference: celt_encode_with_ec celt/celt_encoder.c:1726, quant_all_bands
bands.c:1589, compute_theta bands.c:700, op_pvq_search vq.c:205, icwrs
cwrs.c:444, ec_enc_done entenc.c:219.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..celt import cwrs
from ..celt.modes import get_pulses
from ..ops import rc_enc_kernel as RE
from ..ops.device_cache import const
from ..ops.rc_kernel import M32
from . import celt_enc_fused as EF
from .celt_dec_fused import (_bitexact_cos, _bitexact_log2tan,
                             _compute_qn_vec, _exp_rotation1, _frac_mul16,
                             _sudiv, _band_variants, _u_col, _v_row,
                             _cwrs_table, QTHETA_OFFSET, SPREAD_NONE,
                             SPREAD_NORMAL, SPREAD_ICDF, TRIM_ICDF, _U32_SAT,
                             _haar1_arr, _deinterleave_hadamard_arr)
from .celt_enc_fused import BITRES, EncTabs, _tree_sum, _tree_sum_cols

i64 = torch.int64
f32 = torch.float32
NMAX = 176           # widest band at 20 ms
MAX_K = 128

# launches of kernel K3 (counted where the kernel is launched, only there)
launches = 0

INT_OUT = ("pick_intra", "coded_bands", "spread", "can_sp", "use_calc")


# ===================================================================== #
# static tables                                                         #
# ===================================================================== #

def _wrap_in_matrix(n, v):
    """The input-side tf/Hadamard transform of a band (bands.c:623/650) as
    an (n, n) matrix: f(row) = row @ M."""
    x = torch.eye(n, dtype=torch.float64)
    for kk in range(v["recombine"]):
        x = _haar1_arr(x, n >> kk, 1 << kk)
    bb = v["B0"] >> v["recombine"]
    n_b = (n // v["B0"]) << v["recombine"]
    for _ in range(v["tdiv"]):
        x = _haar1_arr(x, n_b, bb)
        bb <<= 1
        n_b >>= 1
    if v["b0_final"] > 1:
        x = _deinterleave_hadamard_arr(x, v["n_b0"] >> v["recombine"],
                                       v["b0_final"] << v["recombine"],
                                       v["long"])
    return x.numpy().astype(np.float32)


@lru_cache(maxsize=None)
def _kfit(n: int) -> int:
    """Largest k whose PVQ codebook V(n, k) still fits in 32 bits."""
    k = 1
    while k < 128 and cwrs.pvq_v(n, k + 1) <= _U32_SAT:
        k += 1
    return k


def _halve(x, times: int):
    for _ in range(times):
        x = (x + 1) >> 1
    return x


@lru_cache(maxsize=None)
def _rot_cs(n: int) -> np.ndarray:
    """[4, MAX_K+1, 2] f32: exp_rotation's (cos, sin) for spread 1..3 and
    k pulses at length n, computed as the JAX twin computes them (float32
    numpy ops), so the plain version and K3 rotate with the same bits."""
    out = np.zeros((4, MAX_K + 1, 2), np.float32)
    kf = np.arange(MAX_K + 1).astype(np.float32)
    for spread, fac in ((1, 15.0), (2, 10.0), (3, 5.0)):
        factor = np.full(MAX_K + 1, fac, np.float32)
        gain = np.float32(1.0) * n / (n + factor * kf)
        theta = np.float32(0.5) * gain * gain
        out[spread, :, 0] = np.cos(np.float32(0.5 * math.pi) * theta)
        out[spread, :, 1] = np.cos(np.float32(0.5 * math.pi)
                                   * (np.float32(1.0) - theta))
    return out


class ETabs(EncTabs):
    """EncTabs + the band tree's static data and the input-side wrap
    transforms (dense ``ewmats`` as in the JAX twin, and their sparse
    rows: at most ``EW_SLOTS`` nonzero taps per output, in index
    order)."""

    EW_SLOTS = 8

    def __init__(self, fs: int, frame_size: int):
        super().__init__(fs, frame_size)
        assert self.lm >= 2, "the kernel path targets LM >= 2 (10/20 ms)"
        m = self.M
        eB = [int(v) for v in self.eBands]
        self.band_n = [m * (eB[i + 1] - eB[i]) for i in range(self.nb)]
        self.band_base = [m * eB[i] for i in range(self.nb)]
        self.nx_rows = m * eB[self.nb]
        self.band_depth = []
        for n in self.band_n:
            d = 0
            while (self.lm - d) != -1 and (n >> d) > 2:
                d += 1
            self.band_depth.append(d)
        self.band_var = [_band_variants(self.lm, n) for n in self.band_n]
        self.band_bvals = []
        for band in range(self.nb):
            root = sorted({v["b0_final"] for v in self.band_var[band]})
            self.band_bvals.append([
                tuple(sorted({_halve(v, d) for v in root}))
                for d in range(self.band_depth[band] + 1)])
        rows = []
        self.ewmat_off = []
        self.ew_sparse = []
        cur = 0
        for band in range(self.nb):
            n = self.band_n[band]
            offs, sparse = [], []
            for v in self.band_var[band]:
                wi = _wrap_in_matrix(n, v)
                if np.allclose(wi, np.eye(n)):
                    offs.append(None)
                    sparse.append(None)
                    continue
                rows.append(wi)
                offs.append(cur)
                cur += n
                idx = np.zeros((n, self.EW_SLOTS), np.int64)
                coef = np.zeros((n, self.EW_SLOTS), np.float32)
                for c in range(n):
                    nz = np.nonzero(wi[:, c])[0]
                    assert len(nz) <= self.EW_SLOTS
                    idx[c, :len(nz)] = nz
                    coef[c, :len(nz)] = wi[nz, c]
                sparse.append((idx, coef))
            self.ewmat_off.append(offs)
            self.ew_sparse.append(sparse)
        self.ewmats = np.zeros((max(cur, 1), NMAX), np.float32)
        r0 = 0
        for w in rows:
            self.ewmats[r0:r0 + w.shape[0], :w.shape[1]] = w
            r0 += w.shape[0]

    # sections of K3's int32 table, in the order of csrc/celt_enc_frame.cu
    KSECTIONS = ("eBands", "logN", "caps", "allocV", "eprob", "rowoff",
                 "rows", "u", "v", "lapoff", "lap", "depth", "kcap",
                 "var", "ewidx", "rotoff")
    NVAR = 8            # variant slots per band (tv, tfv, b0_final, sparse)

    def kernel_tables(self) -> tuple:
        """(int32 table, float32 table) for kernel K3.  The int table is a
        header [nb, lm, nv, nx, urows, ucols] followed by one offset per
        KSECTIONS entry, each section 16-byte aligned; uint32 entries are
        stored as their int32 bits.
        u/v: U(n, k) and V(n, k) at [k * ucols + n] (saturated); lap: per
        (intra, band) Laplace chain as (fl, fs) pairs, lapoff holding
        (offset, length L); kcap: [band * (lm + 2) + depth]; var: per band
        NVAR x (tv, tfv, b0_final, ewidx row offset or -1); ewidx:
        EW_SLOTS tap columns per output row, whose coefficients are the
        float table's first rows; rotoff[n]: float offset of _rot_cs(n) or
        -1."""
        nb, lm = self.nb, self.lm
        nv = self.allocV.shape[0]
        urows, ucols = MAX_K + 2, NMAX + 1
        u = _cwrs_table(cwrs.pvq_u, urows, ucols)
        v = _cwrs_table(cwrs.pvq_v, urows, ucols)
        rows, rowoff = [], []
        for lmn in range(-1, lm + 1):
            for band in range(nb):
                rowoff.append(len(rows))
                rows.extend(self.cache_rows[(lmn, band)])
        lapoff, lap = [], []
        for intra in range(2):
            for i in range(nb):
                pi = 2 * min(i, 20)
                fls, fss, big_l = EF._laplace_chain(
                    self.e_prob[intra][pi] << 7,
                    self.e_prob[intra][pi + 1] << 6)
                lapoff += [len(lap), big_l]
                for a, b in zip(fls, fss):
                    lap += [a, b]
        kcap = np.zeros((nb, lm + 2), np.int64)
        for band in range(nb):
            for d in range(self.band_depth[band] + 1):
                row = self.cache_rows[(lm - d, band)]
                kcap[band, d] = min(int(get_pulses(row[0])), MAX_K,
                                    _kfit(self.band_n[band] >> d) + 1)
        var = np.full((nb, self.NVAR, 4), -1, np.int64)
        ewidx, ewcoef = [], []
        for band in range(nb):
            for vs, vd in enumerate(self.band_var[band]):
                sp = self.ew_sparse[band][vs]
                off = -1
                if sp is not None:
                    off = len(ewidx)
                    ewidx.extend(sp[0].tolist())
                    ewcoef.extend(sp[1].tolist())
                var[band, vs] = (vd["tv"], vd["tfv"], vd["b0_final"], off)
        rot, rotoff = [], np.full(ucols, -1, np.int64)
        fbase = len(ewcoef) * self.EW_SLOTS
        for n in sorted({nn >> d for nn, dm in zip(self.band_n,
                                                   self.band_depth)
                         for d in range(dm + 1)}):
            rotoff[n] = fbase + len(rot)
            rot.extend(_rot_cs(n).reshape(-1).tolist())
        parts = [np.asarray(self.eBands, np.int64),
                 np.asarray(self.logN, np.int64),
                 np.asarray(self.caps, np.int64),
                 self.allocV.reshape(-1).astype(np.int64),
                 np.asarray(self.e_prob, np.int64).reshape(-1),
                 np.asarray(rowoff, np.int64), np.asarray(rows, np.int64),
                 u.reshape(-1), v.reshape(-1), np.asarray(lapoff, np.int64),
                 np.asarray(lap, np.int64),
                 np.asarray(self.band_depth, np.int64), kcap.reshape(-1),
                 var.reshape(-1), np.asarray(ewidx, np.int64).reshape(-1),
                 rotoff]
        header = [nb, lm, nv, self.nx_rows, urows, ucols]
        # every section starts at a multiple of 4 words (K3 reads the wrap
        # taps' columns as 16-byte vectors)
        pad = lambda k: (-k) % 4                             # noqa: E731
        pos = len(header) + len(parts)
        chunks = [np.zeros(pad(pos), np.int64)]
        offs = []
        pos += pad(pos)
        for a in parts:
            offs.append(pos)
            chunks += [a, np.zeros(pad(a.size), np.int64)]
            pos += a.size + pad(a.size)
        itab = np.concatenate([np.asarray(header + offs, np.int64)] + chunks)
        ftab = np.concatenate([np.asarray(ewcoef, np.float32).reshape(-1),
                               np.asarray(rot, np.float32)])
        return itab.astype(np.uint32).view(np.int32), ftab


# ===================================================================== #
# leaf helpers                                                          #
# ===================================================================== #

def _atan2p(y, x):
    """atan2 for y, x >= 0 as the JAX twin's half-angle-reduced odd
    polynomial (|err| < 2e-7 rad)."""
    swap = y > x
    num = torch.minimum(y, x)
    den = torch.clamp(torch.maximum(y, x), min=1e-30)
    r = num / den
    z = r / (1.0 + torch.sqrt(1.0 + r * r))
    z2 = z * z
    p = torch.full_like(z, 1 / 13.0)
    for c in (-1 / 11.0, 1 / 9.0, -1 / 7.0, 1 / 5.0, -1 / 3.0, 1.0):
        p = p * z2 + c
    a = 2.0 * z * p
    return torch.where(swap, 0.5 * math.pi - a, a)


def _exp_rotation_enc(x, n: int, stride_lanes, stride_vals, k, spread,
                      active):
    """exp_rotation direction=+1 (vq.c:104) on x [B, n]: the stride-1
    pass with (c, -s), then the stride2 pass with (s, -c)."""
    do = active & (spread != SPREAD_NONE) & (2 * k < n)
    if not bool(do.any()):
        return x
    cs = const(("rot_cs", n), lambda: _rot_cs(n), x.device)
    sel = cs[spread.clamp(0, 3), k.clamp(0, MAX_K)]
    c, s = sel[:, 0], sel[:, 1]
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
        _exp_rotation1(segs, 1, c, -s)
        if stride2:
            _exp_rotation1(segs, stride2, s, -c)
        out = torch.where(m[:, None], segs.reshape(b, n), out)
    return out


def _pvq_search(x, n: int, k, kcap: int, active):
    """op_pvq_search (vq.c:205) on x [B, n]: projection, then one pulse
    at a time (first-index argmax).  Returns signed iy [B, n] int64."""
    xa = x.abs()
    signs = torch.where(x < 0, -1, 1)
    sum_ = _tree_sum_cols(xa)
    proj = active & (k > (n >> 1))
    bad = proj & ~((sum_ > EF.EPSILON) & (sum_ < 64.0))
    onehot = torch.zeros_like(xa)
    onehot[:, 0] = 1.0
    xa = torch.where(bad[:, None], onehot, xa)
    sum_ = torch.where(bad, 1.0, sum_)
    rcp = (k.to(f32) + 0.8) / sum_
    iy = torch.where(proj[:, None], torch.floor(rcp[:, None] * xa), 0.0) \
        .to(i64)
    yy = _tree_sum_cols((iy * iy).to(f32))
    xy = _tree_sum_cols(xa * iy.to(f32))
    pulses_left = torch.where(proj, k - iy.sum(dim=1), k)
    dump = active & (pulses_left > n + 3)
    tmpf = pulses_left.to(f32)
    yy = torch.where(dump, yy + tmpf * tmpf + tmpf * 2.0 * iy[:, 0].to(f32),
                     yy)
    iy[:, 0] = iy[:, 0] + torch.where(dump, pulses_left, 0)
    pulses_left = torch.where(dump, 0, pulses_left)
    rows = torch.arange(x.shape[0], device=x.device)
    for t in range(min(kcap, n + 3)):
        act = active & (t < pulses_left)
        if not bool(act.any()):
            break
        yy1 = yy + 1.0
        rxy = xy[:, None] + xa
        score = (rxy * rxy) / (yy1[:, None] + 2.0 * iy.to(f32))
        best = score.argmax(dim=1)
        xy2 = xy + xa[rows, best]
        yy2 = yy1 + 2.0 * iy[rows, best].to(f32)
        iy[rows, best] = iy[rows, best] + act.to(i64)
        xy = torch.where(act, xy2, xy)
        yy = torch.where(act, yy2, yy)
    return iy * signs


def _icwrs(iy, n: int, kcap: int):
    """icwrs (cwrs.c:444): codebook index (uint32) from the exclusive and
    inclusive suffix magnitude sums and the U columns."""
    kcols = kcap + 3
    ucols = const(("icwrs_u", n, kcap), lambda: np.stack(
        [np.zeros(kcols, np.int64), np.zeros(kcols, np.int64)]
        + [np.asarray(_u_col(nj, kcap + 2), np.int64)
           for nj in range(2, n + 1)]), iy.device)     # [n+1, kcols]
    ay = iy.abs()
    suffix = ay.flip(1).cumsum(dim=1).flip(1)        # sum_{t >= j}
    s_excl = suffix[:, 1:]                           # j = 0..n-2
    t_incl = suffix[:, :-1]
    nj = torch.arange(n, 1, -1, device=iy.device)    # n - j
    term = ucols[nj[None, :], s_excl.clamp(0, kcols - 1)]
    neg = ucols[nj[None, :], (t_incl + 1).clamp(0, kcols - 1)]
    term = term + torch.where(iy[:, :-1] < 0, neg, 0)
    return ((iy[:, n - 1] < 0).to(i64) + term.sum(dim=1)) & M32


def _encode_pulses(vk, e, iy, n: int, kq, kcap: int, active):
    """encode_pulses (cwrs.c:462): icwrs index + enc_uint(V(n, k))."""
    vrow = const(("vrow", n, kcap),
                 lambda: np.asarray(_v_row(n, kcap), np.int64), iy.device)
    return vk.re_enc_uint(e, _icwrs(iy, n, kcap), vrow[kq.clamp(0, kcap)],
                          active)


def _theta_encode(vk, e, rb, tabs, band: int, n2: int, b, b0, lm2: int,
                  emid, eside, avoid_sn, active):
    """compute_theta, mono encode (bands.c:700).  Returns (b, rb, itheta
    (Q14), delta, e)."""
    pulse_cap = tabs.logN[band] + lm2 * (1 << BITRES)
    offset = (pulse_cap >> 1) - QTHETA_OFFSET
    qn = _compute_qn_vec(n2, b, offset, pulse_cap)
    tell0 = vk.re_tell_frac(e)
    itheta_raw = torch.floor(0.5 + float(np.float32(16384 * 0.63662))
                             * _atan2p(torch.sqrt(eside),
                                       torch.sqrt(emid))).to(i64)
    has_theta = active & (qn != 1)
    itheta = (itheta_raw * qn + 8192) >> 14
    asn = has_theta & avoid_sn & (itheta > 0) & (itheta < qn)
    unq = torch.div(itheta * 16384, qn.clamp_min(1), rounding_mode="floor")
    imid_a = _bitexact_cos(unq)
    iside_a = _bitexact_cos(16384 - unq)
    delta_a = _frac_mul16((n2 - 1) << 7, _bitexact_log2tan(iside_a, imid_a))
    itheta = torch.where(asn & (delta_a > b), qn,
                         torch.where(asn & (delta_a < -b), 0, itheta))
    e = vk.re_enc_uint(e, itheta, qn + 1, has_theta & (b0 > 1))
    tri = has_theta & (b0 <= 1)
    qh = qn >> 1
    ft = (qh + 1) * (qh + 1)
    low = itheta <= qh
    fs_t = torch.where(low, itheta + 1, qn + 1 - itheta)
    fl_t = torch.where(low, (itheta * (itheta + 1)) >> 1,
                       ft - (((qn + 1 - itheta) * (qn + 2 - itheta)) >> 1))
    e = vk.re_encode(e, fl_t, fl_t + fs_t, ft, tri)
    itheta_q14 = torch.div(itheta * 16384, qn.clamp_min(1),
                           rounding_mode="floor")
    itheta_q14 = torch.where(has_theta, itheta_q14, itheta_raw)
    qalloc = vk.re_tell_frac(e) - tell0
    b = b - qalloc
    rb = rb - torch.where(active, qalloc, 0)

    th0 = itheta_q14 == 0
    th1 = itheta_q14 == 16384
    imid = torch.where(th0, 32767, torch.where(th1, 0,
                                               _bitexact_cos(itheta_q14)))
    iside = torch.where(th0, 0, torch.where(
        th1, 32767, _bitexact_cos(16384 - itheta_q14)))
    delta_m = _frac_mul16((n2 - 1) << 7, _bitexact_log2tan(iside, imid))
    delta = torch.where(th0, -16384, torch.where(th1, 16384, delta_m))
    return b, rb, itheta_q14, delta, e


# ===================================================================== #
# the per-band encode tree                                              #
# ===================================================================== #

def _tree_band_enc(tabs: ETabs, band: int, xw, vk, e, rb, spread, bb_root,
                   b_band, avoid_sn, active_band):
    """Band ``band``'s split tree, preorder, as a Python recursion over the
    static tree (the JAX node program's order).  xw [B, n] is the band's
    working window (halves swapped in place on swapping lanes); encode
    needs no pop events.  Returns (e, rb)."""
    n_root = tabs.band_n[band]
    maxd = tabs.band_depth[band]
    lm = tabs.lm
    zi = torch.zeros_like(rb)
    st = {k: [zi] * maxd for k in ("split", "swap", "mbits", "sbits",
                                    "itheta", "rb0")}

    def node(dd, off, isv1, e, rb):
        nd = n_root >> dd
        lmd = lm - dd
        if dd == 0:
            active, b, bb = active_band, b_band, bb_root
        else:
            p = dd - 1
            active = st["split"][p] != 0
            if not bool(active.any()):
                return e, rb
            swap = st["swap"][p] != 0
            bb = _halve(bb_root, dd)
            b_v0 = torch.where(swap, st["sbits"][p], st["mbits"][p])
            if isv1:
                rebalance = b_v0 - (st["rb0"][p] - rb)
                anchor = torch.where(swap, 16384, 0)
                extra = torch.where(active & (rebalance > (3 << BITRES))
                                    & (st["itheta"][p] != anchor),
                                    rebalance - (3 << BITRES), 0)
                b = torch.where(swap, st["mbits"][p], st["sbits"][p]) + extra
            else:
                b = b_v0
        row = tabs.cache_rows[(lmd, band)]
        L = row[0]
        kcap = min(int(get_pulses(L)), MAX_K, _kfit(nd) + 1)
        split = torch.zeros_like(active)
        if lmd != -1 and nd > 2:
            split = active & (b > row[L] + 12)
            if bool(split.any()):
                n2 = nd >> 1
                win = xw[:, off:off + nd]
                emid = _tree_sum_cols(win[:, :n2] * win[:, :n2]) + 1e-15
                eside = _tree_sum_cols(win[:, n2:] * win[:, n2:]) + 1e-15
                b2, rb, itheta, delta, e = _theta_encode(
                    vk, e, rb, tabs, band, n2, b, bb, lmd - 1, emid, eside,
                    avoid_sn, split)
                lm2 = lmd - 1
                d_hi = delta - (delta >> (4 - lm2))
                d_lo = torch.clamp(delta + (n2 << BITRES >> (5 - lm2)),
                                   max=0)
                delta = torch.where((bb > 1) & ((itheta & 0x3fff) != 0),
                                    torch.where(itheta > 8192, d_hi, d_lo),
                                    delta)
                mbits = torch.clamp(torch.minimum(b2, torch.div(
                    b2 - delta, 2, rounding_mode="floor")), min=0)
                sbits = b2 - mbits
                swap_n = split & (mbits < sbits)
                st["split"][dd] = split.to(i64)
                st["swap"][dd] = swap_n.to(i64)
                st["mbits"][dd] = mbits
                st["sbits"][dd] = sbits
                st["itheta"][dd] = itheta
                st["rb0"][dd] = rb
                lo = xw[:, off:off + n2].clone()
                hi = xw[:, off + n2:off + nd].clone()
                sw = swap_n[:, None]
                xw[:, off:off + n2] = torch.where(sw, hi, lo)
                xw[:, off + n2:off + nd] = torch.where(sw, lo, hi)
            else:
                st["split"][dd] = zi

        # ---- leaf: bits -> pulses -> rotate / search / index ----
        leaf_act = active & ~split
        if bool(leaf_act.any()):
            rowj = const(("row", lmd, band), lambda: np.asarray(row, np.int64),
                         b.device)
            bm1 = b - 1
            lo = (bm1[:, None] > rowj[None, 1:L + 1]).sum(dim=1)
            hi = torch.clamp(lo + 1, max=L)
            lo_val = torch.where(lo == 0, -1, rowj[lo.clamp(0, L)])
            q = torch.where(bm1 - lo_val <= rowj[hi] - bm1, lo, hi)
            c_fit = (rb[:, None] >= rowj[None, 1:L + 1] + 1).sum(dim=1)
            q = torch.clamp(torch.minimum(q, c_fit.clamp_min(0)), min=0)
            bits_used = torch.where(q > 0, rowj[q.clamp(0, L)] + 1, 0)
            rb = rb - torch.where(leaf_act, bits_used, 0)
            kq = torch.where(q < 8, q,
                             (8 + (q & 7)) << ((q >> 3) - 1).clamp_min(0))
            pvq = leaf_act & (kq != 0)
            if bool(pvq.any()):
                xs = _exp_rotation_enc(xw[:, off:off + nd], nd, bb,
                                       tabs.band_bvals[band][dd], kq,
                                       spread, pvq)
                iy = _pvq_search(xs, nd, kq, kcap, pvq)
                e = _encode_pulses(vk, e, iy, nd, kq, kcap, pvq)
        if dd < maxd:
            e, rb = node(dd + 1, off, 0, e, rb)
            e, rb = node(dd + 1, off + (nd >> 1), 1, e, rb)
        return e, rb

    return node(0, 0, 0, e, rb)


# ===================================================================== #
# coarse energy: dry trials + the picked pass                           #
# ===================================================================== #

def _quant_coarse_energy_k(vk, e, x_bands, old_e, budget, nbytes: int,
                           delayed_intra, tabs, active):
    """quant_coarse_energy (quant_bands.c:260): the intra and inter trials
    run dry (exact tells, no writes), then the picked one for real
    (loss_rate 0, so no intra bias)."""
    nb = tabs.nb
    lm = tabs.lm
    dist = _tree_sum([torch.clamp((x - o) * (x - o), max=200.0)
                      for x, o in zip(x_bands, old_e)])
    new_distortion = torch.clamp(dist, max=200.0)
    tell0 = vk.re_tell(e)
    two_pass = active & (tell0 + 3 <= budget)
    max_decay = torch.full_like(delayed_intra, min(16.0, float(
        np.float32(0.125 * nbytes))))
    pm_intra = EF.E_PROB_MODEL[lm][1]
    pm_inter = EF.E_PROB_MODEL[lm][0]
    one = torch.ones_like(tell0)
    zero = torch.zeros_like(tell0)
    intra_args = (pm_intra, 0.0, EF.BETA_INTRA, one, max_decay, nb)
    inter_args = (pm_inter, EF.PRED_COEF[lm], EF.BETA_COEF[lm], zero,
                  max_decay, nb)

    dry = RE.VK(vk.dig, vk.end, dry=True)
    e1, _o1, _r1, bad1 = EF._coarse_impl(dry, e, x_bands, old_e, budget,
                                         tell0, *intra_args, two_pass)
    e2, _o2, _r2, bad2 = EF._coarse_impl(dry, e, x_bands, old_e, budget,
                                         tell0, *inter_args, active)
    pick_intra = two_pass & ((bad1 < bad2) | (
        (bad1 == bad2) & (vk.re_tell_frac(e2) > vk.re_tell_frac(e1))))

    e, old_i, err_i, _b1 = EF._coarse_impl(vk, e, x_bands, old_e, budget,
                                           tell0, *intra_args, pick_intra)
    e, old_n, err_n, _b2 = EF._coarse_impl(vk, e, x_bands, old_e, budget,
                                           tell0, *inter_args,
                                           active & ~pick_intra)
    old_out = [torch.where(pick_intra, a, b) for a, b in zip(old_i, old_n)]
    err_out = [torch.where(pick_intra, a, b) for a, b in zip(err_i, err_n)]
    pc = EF.PRED_COEF[lm]
    new_di = torch.where(pick_intra, new_distortion,
                         float(np.float32(pc * pc)) * delayed_intra
                         + new_distortion)
    return e, old_out, err_out, new_di, pick_intra


# ===================================================================== #
# the symbol pass: the plain version of K3                              #
# ===================================================================== #

def _wrap_rows(tabs: ETabs, band: int, vslot: int, rows):
    """Input-side tf/Hadamard transform of one band: per output a fused
    multiply-add chain over the nonzero taps in index order (the JAX
    twin's BLAS order), as float64 products and sums rounded to float32
    after each tap."""
    sp = tabs.ew_sparse[band][vslot]
    if sp is None:
        return rows
    dev = rows.device
    # the band's width and transform variants depend on the frame size
    key = (int(tabs.mode.Fs), tabs.lm, band, vslot)
    idx = const(("ew_idx",) + key, lambda: sp[0], dev)
    coef = const(("ew_coef",) + key, lambda: sp[1].astype(np.float64), dev)
    acc = torch.zeros_like(rows)
    r64 = rows.to(torch.float64)
    for s in range(idx.shape[1]):
        acc = (acc.to(torch.float64)
               + r64[:, idx[:, s]] * coef[None, :, s]).to(f32)
    return acc


def _header(vk, e, silence, is_transient, tabs, nbytes: int, active):
    """The three header bits (celt_encoder.c:1936-2060): silence (with
    the tell jump to the budget), the postfilter flag (off) and the
    transient flag where it fits.  Returns (e, can_tr)."""
    total_bits = nbytes * 8
    e = vk.re_enc_bit_logp(e, silence.to(i64), 15, active)
    e = dict(e)
    e["nbits_total"] = torch.where(
        silence, e["nbits_total"] + (total_bits - vk.re_tell(e)),
        e["nbits_total"])
    can_pf = active & (vk.re_tell(e) + 16 <= total_bits)
    e = vk.re_enc_bit_logp(e, 0, 1, can_pf)
    can_tr = (tabs.lm > 0) & (vk.re_tell(e) + 3 <= total_bits)
    e = vk.re_enc_bit_logp(e, is_transient.to(i64), 3, can_tr)
    return e, can_tr


def encode_frame_plain(X, ins: dict, tabs: ETabs, nbytes: int) -> dict:
    """The plain torch version of kernel K3 (any device): header bits,
    coarse energy (two-pass trial), tf, spread, dynalloc, trim,
    allocation, fine energy, the PVQ band trees, the anti-collapse bit,
    energy finalise, ec_enc_done and the carry resolution.

    X [B, nx] f32; ins: the front end's dict ([B] lanes silence,
    is_transient, tf_select, spread_calc, trim_calc, prev_cb,
    consec_transient, delayed_intra; [B, nb] tf_res, offsets_cnt, ble_b,
    old_e).  Returns payload [B, nbytes] uint8, rng/err [B] int64, old_e
    and error [B, nb] f32, delayed_intra [B] f32 and the int64 [B] lanes
    of INT_OUT."""
    nb = tabs.nb
    lm = tabs.lm
    bsz = X.shape[0]
    dev = X.device
    lanes = lambda v: [v[:, i] for i in range(nb)]           # noqa: E731
    silence = ins["silence"] != 0
    is_transient = ins["is_transient"] != 0
    active = torch.ones_like(silence)
    total_bits = nbytes * 8
    budget = torch.full((bsz,), total_bits, dtype=i64, device=dev)
    dig, end = RE.page_bufs(bsz, nbytes, dev)
    vk = RE.VK(dig, end)
    e = RE.re_init(bsz, dev)
    e, _can_tr = _header(vk, e, silence, is_transient, tabs, nbytes, active)

    # ---- coarse energy ----
    e, old_e, error, new_di, pick_intra = _quant_coarse_energy_k(
        vk, e, lanes(ins["ble_b"]), lanes(ins["old_e"]), budget, nbytes,
        ins["delayed_intra"], tabs, active)

    # ---- tf encode ----
    e, tf_vals, _tf_select = EF._tf_encode(
        vk, e, lanes(ins["tf_res"]), ins["tf_select"], is_transient, tabs,
        budget, active)

    # ---- spread (celt_encoder.c:2332-2364) ----
    can_sp = active & (vk.re_tell(e) + 4 <= total_bits)
    use_calc = can_sp & ~is_transient & (nbytes >= 10)
    spread = torch.where(use_calc, ins["spread_calc"], SPREAD_NORMAL)
    e = vk.re_enc_icdf(e, spread, SPREAD_ICDF, 5, can_sp)

    # ---- dynalloc boosts (celt_encoder.c:2365-2391) ----
    dyn_logp = torch.full_like(budget, 6)
    total_bits8 = total_bits << BITRES
    total_boost = torch.zeros_like(budget)
    tell_frac = vk.re_tell_frac(e)
    offsets = []
    for i in range(nb):
        quanta = EF._quanta(int(tabs.width[i]))
        cap_i = int(tabs.caps[i])
        dlp = dyn_logp
        boost = torch.zeros_like(budget)
        alive = active
        coded_any = torch.zeros_like(active)
        cnt = ins["offsets_cnt"][:, i]
        for j in range(cap_i // quanta + 1):
            can = alive & (tell_frac + (dlp << BITRES)
                           < total_bits8 - total_boost) & (boost < cap_i)
            if not bool(can.any()):
                break
            flag = can & (j < cnt)
            e = vk.re_enc_bit_logp(e, flag.to(i64), dlp, can)
            tell_frac = vk.re_tell_frac(e)
            boost = boost + torch.where(flag, quanta, 0)
            total_boost = total_boost + torch.where(flag, quanta, 0)
            dlp = torch.where(flag, 1, dlp)
            coded_any = coded_any | flag
            alive = flag
        dyn_logp = torch.where(coded_any, torch.clamp(dyn_logp - 1, min=2),
                               dyn_logp)
        offsets.append(boost)

    # ---- trim ----
    can_trim = active & (tell_frac + (6 << BITRES)
                         <= total_bits8 - total_boost)
    trim = torch.where(can_trim, ins["trim_calc"], 5)
    e = vk.re_enc_icdf(e, trim, TRIM_ICDF, 7, can_trim)
    tell_frac = vk.re_tell_frac(e)

    # ---- allocation + fine energy ----
    bits = total_bits8 - tell_frac - 1
    anti_rsv = torch.where(is_transient & (lm >= 2)
                           & (bits >= ((lm + 2) << BITRES)), 1 << BITRES, 0)
    bits = bits - anti_rsv
    e, coded_bands, balance, pulses, ebits, fine_priority = \
        EF._compute_allocation_enc(vk, e, tabs, offsets, trim, bits,
                                   ins["prev_cb"], active)
    e, error, old_e = EF._quant_fine_energy(vk, e, error, ebits, old_e,
                                            nbytes, nb, active)

    # ---- PVQ bands ----
    total_bits8b = nbytes * (8 << BITRES) - anti_rsv
    for i in range(nb):
        n = tabs.band_n[i]
        base = tabs.band_base[i]
        tell = vk.re_tell_frac(e)
        if i != 0:
            balance = balance - tell
        remaining_bits = total_bits8b - tell - 1
        in_coded = i <= coded_bands - 1
        curr_balance = _sudiv(balance, torch.clamp(coded_bands - i, 1, 3))
        b = torch.where(in_coded, torch.clamp(torch.minimum(
            remaining_bits + 1, pulses[i] + curr_balance), 0, 16383), 0)
        rows = X[:, base:base + n]
        rows_f = rows
        bb_lanes = torch.zeros_like(b)
        for vs, v in enumerate(tabs.band_var[i]):
            m = active & (is_transient == (v["tv"] == 1)) \
                & (tf_vals[i] == v["tfv"])
            if not bool(m.any()):
                continue
            rows_f = torch.where(m[:, None], _wrap_rows(tabs, i, vs, rows),
                                 rows_f)
            bb_lanes = torch.where(m, v["b0_final"], bb_lanes)
        xw = rows_f.clone()
        avoid = is_transient if i == 0 else torch.zeros_like(active)
        e, _rb = _tree_band_enc(tabs, i, xw, vk, e, remaining_bits, spread,
                                bb_lanes, b, avoid, active)
        balance = balance + pulses[i] + tell

    # ---- anti-collapse flag ----
    has_rsv = active & (anti_rsv > 0)
    ac_on = (ins["consec_transient"] < 2).to(i64)
    e = vk.re_enc_bits(e, torch.where(has_rsv, ac_on, 0),
                       torch.where(has_rsv, 1, 0), has_rsv)

    # ---- energy finalise + done ----
    bits_left = nbytes * 8 - vk.re_tell(e)
    e, error = EF._quant_energy_finalise(vk, e, error, ebits, fine_priority,
                                         bits_left, nb, active)
    e = RE.re_done(e, dig, active)
    payload, err, rng = RE.finalize(e, dig, end, nbytes)
    return dict(payload=payload, rng=rng, err=err,
                old_e=torch.stack(old_e, dim=1),
                error=torch.stack(error, dim=1), delayed_intra=new_di,
                pick_intra=pick_intra.to(i64), coded_bands=coded_bands,
                spread=spread, can_sp=can_sp.to(i64),
                use_calc=use_calc.to(i64))


# ===================================================================== #
# the front end: analysis DSP + header decisions                        #
# ===================================================================== #

def _front_end(pcm, state, tabs: ETabs, nbytes: int, lsb_depth: int = 24):
    """Everything tell-independent (celt_encoder.c:1936-2332): silence and
    clip detection, pre-emphasis, MDCTs and band energies, transient
    analysis and patch, dynalloc / tf / spreading / trim analysis.  The
    header bits' fit checks come from a dry tell tracker.  Returns (ins,
    X, front): the symbol pass's inputs, the normalised spectrum [B, nx]
    and the values the state carry needs."""
    nb = tabs.nb
    lm = tabs.lm
    m = tabs.M
    n = tabs.mode.shortMdctSize << lm
    ov = tabs.mode.overlap
    bsz = pcm.shape[0]
    dev = pcm.device
    active = torch.ones(bsz, dtype=torch.bool, device=dev)

    ov_n = n - ov
    head_max = pcm[:, :ov_n].abs().amax(dim=1)
    tail_max = pcm[:, ov_n:].abs().amax(dim=1)
    sample_max = torch.maximum(state["overlap_max"],
                               torch.maximum(head_max, tail_max))
    silence = sample_max <= 1.0 / (1 << lsb_depth)
    _e, can_tr = _header(RE.VK(None, None, dry=True), RE.re_init(bsz, dev),
                         silence, torch.zeros_like(silence), tabs, nbytes,
                         active)

    clip_mask = sample_max > 2.0
    dsp = EF._encode_dsp(pcm, state["mem"], state["hist"], tabs, clip_mask)
    is_transient, tf_estimate = EF._transient_analysis(dsp["full"][:, ov:],
                                                       tabs)
    transient_got_disabled = is_transient & ~can_tr
    is_transient = is_transient & can_tr

    ble_l = [dsp["ble_l"][:, i] for i in range(nb)]
    ble_s = [dsp["ble_s"][:, i] for i in range(nb)]
    ble = [torch.where(is_transient, s, l) for l, s in zip(ble_l, ble_s)]

    follow = torch.full_like(ble[0], -10.0)
    frame_avg = torch.zeros_like(follow)
    offset_sb = torch.where(is_transient, 0.5 * lm, 0.0)
    for i in range(nb):
        follow = torch.maximum(follow - 1.0, ble[i] - offset_sb)
        frame_avg = frame_avg + follow
    frame_avg = frame_avg / nb
    temporal_vbr = torch.clamp(frame_avg - state["spec_avg"], -1.5, 3.0)
    new_spec_avg = state["spec_avg"] + 0.02 * temporal_vbr

    old_band_e = [state["old_band_e"][:, i] for i in range(nb)]
    patch = can_tr & ~is_transient & EF._patch_transient(ble, old_band_e,
                                                         nb)
    is_transient = is_transient | patch
    ble2 = [torch.where(patch, l + 0.5 * lm, b_) for l, b_ in zip(ble_l, ble)]
    ble = [torch.where(patch, s, b_) for s, b_ in zip(ble_s, ble)]
    tf_estimate = torch.where(patch, 0.2, tf_estimate)

    ncoded = m * int(tabs.eBands[nb])
    bm = EF._c(tabs, "band_map", lambda: tabs.band_map[:ncoded].astype(
        np.int64), dev)
    tr = is_transient[:, None]
    be = torch.where(tr, dsp["be_s"], dsp["be_l"])
    freq = torch.where(tr, dsp["freq_s"], dsp["freq_l"])
    X = freq[:, :ncoded] * (1.0 / (1e-27 + be))[:, bm]

    offsets_cnt, importance, spread_weight, _maxd, _tb = \
        EF._dynalloc_analysis(ble, ble2, tabs, is_transient, nbytes)
    lam = max(80, 20480 // nbytes + 2)
    tf_res, tf_select = EF._tf_analysis(X, tabs, is_transient, tf_estimate,
                                        lam, importance)
    ble_b = [torch.where((b_ - o).abs() < 2.0, b_ - 0.25 * state[
        "energy_error"][:, i], b_)
        for i, (b_, o) in enumerate(zip(ble, old_band_e))]
    sp_state = dict(average=state["tonal_average"],
                    hf_average=state["hf_average"],
                    tapset_decision=state["tapset_decision"],
                    last_decision=state["spread_decision"])
    sp_calc, sp_new = EF._spreading_decision(
        X, tabs, spread_weight, torch.zeros_like(active), sp_state)
    equiv_rate = nbytes * 8 * 50 * (1 << (3 - lm)) \
        - (40 + 20) * ((400 >> lm) - 50)
    trim_calc = EF._alloc_trim_analysis(ble, tabs, tf_estimate, equiv_rate)

    ins = dict(silence=silence.to(i64), is_transient=is_transient.to(i64),
               tf_select=tf_select, spread_calc=sp_calc,
               trim_calc=trim_calc, prev_cb=state["last_coded_bands"],
               consec_transient=state["consec_transient"],
               tf_res=torch.stack(tf_res, dim=1),
               offsets_cnt=torch.stack(offsets_cnt, dim=1),
               ble_b=torch.stack(ble_b, dim=1),
               old_e=state["old_band_e"],
               delayed_intra=state["delayed_intra"])
    front = dict(silence=silence, is_transient=is_transient,
                 transient_got_disabled=transient_got_disabled,
                 mem=dsp["mem"], hist=dsp["hist"], overlap_max=tail_max,
                 spec_avg=new_spec_avg, sp_new=sp_new)
    return ins, X, front


def _assemble_state(state, front, out):
    """The next frame's encoder state (celt_encoder.c:2470-2560)."""
    silence = front["silence"][:, None]
    tr = front["is_transient"]
    old_e = torch.where(silence, -28.0, out["old_e"])
    ole, ole2 = state["old_log_e"], state["old_log_e2"]
    lcb = state["last_coded_bands"]
    cb = out["coded_bands"]
    return dict(
        mem=front["mem"], hist=front["hist"],
        overlap_max=front["overlap_max"], spec_avg=front["spec_avg"],
        old_band_e=old_e,
        old_log_e=torch.where(tr[:, None], torch.minimum(ole, old_e), old_e),
        old_log_e2=torch.where(tr[:, None], ole2, ole),
        energy_error=out["error"].clamp(-0.5, 0.5),
        delayed_intra=out["delayed_intra"],
        consec_transient=torch.where(
            tr | front["transient_got_disabled"],
            state["consec_transient"] + 1, 0),
        last_coded_bands=torch.where(lcb != 0, torch.minimum(
            lcb + 1, torch.maximum(lcb - 1, cb)), cb),
        tonal_average=torch.where(out["use_calc"] != 0,
                                  front["sp_new"]["average"],
                                  state["tonal_average"]),
        hf_average=state["hf_average"],
        tapset_decision=state["tapset_decision"],
        spread_decision=torch.where(out["can_sp"] != 0, out["spread"],
                                    SPREAD_NORMAL))


# ===================================================================== #
# the K3 wrapper and the frame step                                     #
# ===================================================================== #

FIN_KEYS = ("ble_b", "old_e", "delayed_intra")
IIN_KEYS = ("silence", "is_transient", "tf_select", "spread_calc",
            "trim_calc", "prev_cb", "consec_transient", "tf_res",
            "offsets_cnt")


def encode_frame(X, ins: dict, tabs: ETabs = None, nbytes: int = 160) \
        -> dict:
    """One frame's mono CBR CELT encode symbol pass for B streams, from
    ``ec_enc_init`` to the packet bytes (see ``encode_frame_plain`` for the
    arguments and results).  CPU tensors run the plain version; CUDA
    tensors launch kernel K3."""
    tabs = enc_tabs() if tabs is None else tabs
    if X.device.type == "cpu":
        return encode_frame_plain(X, ins, tabs, nbytes)
    return _encode_frame_cuda(X, ins, tabs, nbytes)


def _encode_frame_cuda(X, ins, tabs, nbytes, lib=None) -> dict:
    """Kernel K3 on the card; ``lib``: the built library (default) or
    another build of ``celt_enc_frame.cu`` with the same entry point."""
    from ..cuda_build import check_launch, library

    global launches
    dev = X.device
    if not X.is_cuda or any(v.device != dev for v in ins.values()):
        raise ValueError("encode_frame: all inputs on one CUDA device")
    b, nx = X.shape
    nb = tabs.nb
    if nx != tabs.nx_rows or X.dtype != f32:
        raise ValueError("encode_frame: X [B, nx] f32")
    X = X.contiguous()
    fin = torch.cat([ins[k].reshape(b, -1).to(f32) for k in FIN_KEYS],
                    dim=1).contiguous()                     # [B, 2nb+1]
    iin = torch.cat([ins[k].reshape(b, -1).to(torch.int32)
                     for k in IIN_KEYS], dim=1).contiguous()  # [B, 7+2nb]
    itab, ftab = k3_tables(tabs, dev)
    payload = torch.empty((b, nbytes), dtype=torch.uint8, device=dev)
    fout = torch.empty((b, 2 * nb + 1), dtype=f32, device=dev)
    iout = torch.empty((b, len(INT_OUT) + 3), dtype=torch.int32, device=dev)
    lib = library() if lib is None else lib
    vp = ctypes.c_void_p
    rc = lib.opus_celt_enc_frame_launch(
        vp(X.data_ptr()), vp(fin.data_ptr()), vp(iin.data_ptr()),
        vp(itab.data_ptr()), vp(ftab.data_ptr()), vp(payload.data_ptr()),
        vp(fout.data_ptr()), vp(iout.data_ptr()), b, nbytes,
        vp(torch.cuda.current_stream(dev).cuda_stream))
    check_launch(rc, "celt_enc_frame")
    launches += 1
    iout = iout.to(i64)
    res = {k: iout[:, j] for j, k in enumerate(INT_OUT)}
    res.update(payload=payload, rng=iout[:, len(INT_OUT)] & M32,
               err=iout[:, len(INT_OUT) + 1],
               search_evals=iout[:, len(INT_OUT) + 2], old_e=fout[:, :nb],
               error=fout[:, nb:2 * nb], delayed_intra=fout[:, 2 * nb])
    return res


def k3_tables(tabs: ETabs, device) -> tuple:
    """K3's (int32, float32) tables on ``device``, uploaded once."""
    key = (int(tabs.mode.Fs), tabs.lm)
    return (const(("k3_itab",) + key, lambda: tabs.kernel_tables()[0],
                  device),
            const(("k3_ftab",) + key, lambda: tabs.kernel_tables()[1],
                  device))


def geometry(nbytes: int) -> dict:
    """K3's launch geometry on the current card at ``nbytes`` a frame; see
    ``cuda_build.geometry``."""
    from ..cuda_build import geometry as geo

    return geo("opus_celt_enc_frame_occupancy", nbytes)


@lru_cache(maxsize=None)
def enc_tabs(fs: int = 48000, frame_size: int = 960) -> ETabs:
    return ETabs(fs, frame_size)


def kernel_celt_encode_frame(pcm, state: dict, tabs: ETabs, nbytes: int,
                             frame_fn=None):
    """One batched CELT encode frame: the torch front end, the K3 symbol
    pass (or ``frame_fn``) and the state carry.  pcm [B, N] f32.  Returns
    (payload [B, nbytes] uint8, rng [B], err [B], new state)."""
    frame_fn = encode_frame if frame_fn is None else frame_fn
    ins, X, front = _front_end(pcm, state, tabs, nbytes)
    out = frame_fn(X, ins, tabs, nbytes)
    return out["payload"], out["rng"], out["err"], \
        _assemble_state(state, front, out)


class KernelCeltEncoder:
    """PCM-in -> CELT-packets-out mono CBR encoder at 10 or 20 ms
    (``frame_size`` 480 or 960 at 48 kHz): kernel K3 for the symbol pass
    on the card (the default device), its plain torch version when
    ``device="cpu"``."""

    def __init__(self, batch: int, fs: int = 48000, frame_size: int = 960,
                 nbytes: int = 160, device="cuda"):
        self.batch = batch
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("KernelCeltEncoder: no CUDA device (pass "
                               "device='cpu' for the plain version)")
        self.tabs = enc_tabs(fs, frame_size)
        self.nbytes = nbytes
        self.state = EF.fused_celt_enc_init(batch, self.tabs, self.device)

    def encode_device(self, pcm_t):
        """pcm [B, N] f32 on the device -> (payload [B, nbytes] uint8, rng
        [B], err [B]), all on the device."""
        payload, rng, err, self.state = kernel_celt_encode_frame(
            pcm_t, self.state, self.tabs, self.nbytes)
        return payload, rng, err

    def encode(self, pcm: np.ndarray):
        """pcm [B, N] float in [-1, 1] (numpy) -> numpy (payload, rng,
        err)."""
        out = self.encode_device(torch.as_tensor(
            np.asarray(pcm, np.float32), device=self.device))
        return tuple(t.cpu().numpy() for t in out)
