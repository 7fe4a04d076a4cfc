"""The mono SILK decoder with everything on the device: packets in, int16
PCM at the internal rate out, one range-decoder state per stream.

Port of ``opus_tpu/models/fused_silk_dec.py`` (``_SilkTabs``, the NLSF ->
LPC conversion, the symbol pass ``fused_silk_decode`` and
``FusedSilkDecoder``), with the same boundary and names.  The symbol pass
(frame header, side-info indices, shell-coded excitation, NLSF -> LPC,
gains, pitch/LTP) runs as masked [B]-lane torch ops over the port's range
decoder (``opus_tpu_torch/ops/rc_kernel.py``); the synthesis is
``batched_silk.silk_decode_step``, whose LPC recursion is kernel K4.
All integer math is int32-exact (``opus_tpu_torch/ops/silk_fixed.py``).

Differences from the JAX twin, none of which changes a result:

- Each ``lax.scan`` over blocks is a Python loop.
- Masked work that no lane needs is skipped after one check of the mask
  on the host: the LBRR parse-through when no lane carries LBRR, escape
  and NLSF-extension symbols, pulse blocks, LSB rounds and sign samples
  with no lane active, the remaining ``_lpc_fit`` and
  ``_nlsf_stabilize`` rounds once every lane is done.  A masked op on an
  all-false mask leaves every lane as it was, so the results are those
  of the unskipped pass.
- The excitation LCG's ``associative_scan`` is a log-depth doubling scan
  on int64 lanes, exact mod 2**32.

Scope, as in the JAX twin: mono, one 10 or 20 ms frame per packet.  A
normal decode parses in-band FEC (LBRR) payloads through
(dec_API.c:258-283); ``lbrr=`` lanes decode them in place of the regular
frame, and lost frames are concealed (``fused_silk_conceal``, the
classic concealment and comfort noise of ``silk_plc.py``, scalar-exact,
so far at 16 kHz 20 ms).  Streams whose LPC is still unstable after two
bandwidth expansions are flagged in the ``error`` lane (the JAX twin also
flags a third LSB escape round; the port decodes every round, as the
scalar decoder).

Reference: silk/dec_API.c:135, decode_indices.c, decode_pulses.c,
shell_coder.c, code_signs.c, decode_parameters.c, NLSF_decode.c,
NLSF_stabilize.c, NLSF2A.c, LPC_fit.c, LPC_inv_pred_gain.c,
gain_quant.c, decode_pitch.c, decode_core.c:80-96.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..dnn.bbwe import BBWE
from ..dnn.osce import OSCEEnhancer
from ..ops import silk_fixed as F
from ..ops.device_cache import const
from ..ops.rc_kernel import (M32, pack_payloads, rk_dec_bit_logp,
                              rk_dec_icdf, rk_init, rk_tell)
from ..ops.silk_fixed import w32
from ..silk import tables as T
from ..silk import tables_data as TD
from ..silk.resampler import upsample_to_48k, upsampler_init
from ..ops.lanes import lane_mask, select_lanes
from . import silk_plc as PLC
from .batched_silk import init_state, silk_decode_step

LTP_ORDER = 5
MAX_LPC_ORDER = 16
NLSF_QUANT_MAX_AMPLITUDE = 4
QA = 16


def _pad_icdf(rows, width):
    """Pad each iCDF row with trailing zeros to a common width (trailing
    zeros decode identically)."""
    out = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


class _SilkTabs:
    """The decoder's tables as numpy arrays (the JAX twin's, from the
    port's table copies); ``t(name, device)`` gives one as a cached int64
    tensor on a device."""

    def __init__(self, fs_khz: int, nb_subfr: int = 4):
        self.fs_khz = fs_khz
        self.nb_subfr = nb_subfr
        self.order = 16 if fs_khz >= 16 else 10
        cb = T.NLSF_CB_WB if fs_khz >= 16 else T.NLSF_CB_NB_MB
        self.cb = cb
        self.cb1_icdf = _pad_icdf(
            [cb.CB1_iCDF[:cb.nVectors], cb.CB1_iCDF[cb.nVectors:]], 33)
        self.ec_icdf = np.asarray(cb.ec_iCDF, np.uint8)     # flat
        self.ec_sel = np.asarray(cb.ec_sel, np.uint8)
        self.pred_q8 = np.asarray(cb.pred_Q8, np.uint8)
        self.cb1_nlsf = np.asarray(cb.CB1_NLSF_Q8, np.int32).reshape(
            cb.nVectors, cb.order)
        self.cb1_wght = np.asarray(cb.CB1_Wght_Q9, np.int32).reshape(
            cb.nVectors, cb.order)
        self.dmin = np.asarray(cb.deltaMin_Q15, np.int32)
        self.qstep = cb.quantStepSize_Q16
        self.type_vad = np.asarray(TD.TYPE_OFFSET_VAD_ICDF, np.uint8)
        self.type_novad = np.asarray(TD.TYPE_OFFSET_NO_VAD_ICDF, np.uint8)
        self.gain_icdf = _pad_icdf([T.GAIN_ICDF[0], T.GAIN_ICDF[1],
                                    T.GAIN_ICDF[2]], 8)
        self.delta_gain = np.asarray(TD.DELTA_GAIN_ICDF, np.uint8)
        self.uniform4 = np.asarray(TD.UNIFORM4_ICDF, np.uint8)
        self.uniform8 = np.asarray(TD.UNIFORM8_ICDF, np.uint8)
        low = {16: TD.UNIFORM8_ICDF, 12: TD.UNIFORM6_ICDF,
               8: TD.UNIFORM4_ICDF}[fs_khz]
        self.lag_low = np.asarray(low, np.uint8)
        self.nlsf_ext = np.asarray(TD.NLSF_EXT_ICDF, np.uint8)
        self.nlsf_interp = np.asarray(TD.NLSF_INTERPOLATION_FACTOR_ICDF,
                                      np.uint8)
        self.pitch_lag = np.asarray(TD.PITCH_LAG_ICDF, np.uint8)
        self.pitch_delta = np.asarray(TD.PITCH_DELTA_ICDF, np.uint8)
        self.lbrr_flags2 = np.asarray(TD.LBRR_FLAGS_2_ICDF, np.uint8)
        self.lbrr_flags3 = np.asarray(TD.LBRR_FLAGS_3_ICDF, np.uint8)
        self.stereo_joint = np.asarray(TD.STEREO_PRED_JOINT_ICDF, np.uint8)
        self.uniform3 = np.asarray(TD.UNIFORM3_ICDF, np.uint8)
        self.uniform5 = np.asarray(TD.UNIFORM5_ICDF, np.uint8)
        self.mid_only = np.asarray(TD.STEREO_ONLY_CODE_MID_ICDF, np.uint8)
        self.contour = np.asarray(
            (TD.PITCH_CONTOUR_ICDF if nb_subfr == 4
             else TD.PITCH_CONTOUR_10_MS_ICDF) if fs_khz != 8 else
            (TD.PITCH_CONTOUR_NB_ICDF if nb_subfr == 4
             else TD.PITCH_CONTOUR_10_MS_NB_ICDF), np.uint8)
        self.per_index = np.asarray(TD.LTP_PER_INDEX_ICDF, np.uint8)
        self.ltp_gain = _pad_icdf([TD.LTP_GAIN_ICDF_0, TD.LTP_GAIN_ICDF_1,
                                   TD.LTP_GAIN_ICDF_2], 32)
        self.ltp_vq = np.zeros((3, 32, LTP_ORDER), np.int32)
        for c, tab in enumerate(T.LTP_VQ_PTRS_Q7):
            for r, row in enumerate(tab):
                self.ltp_vq[c, r] = np.asarray(row, np.int32) << 7
        self.ltp_scales = np.asarray(TD.LTPSCALES_TABLE_Q14, np.int32)
        self.ltp_scale_icdf = np.asarray(TD.LTPSCALE_ICDF, np.uint8)
        self.rate_levels = np.asarray(T.RATE_LEVELS_ICDF,
                                      np.uint8).reshape(2, 9)
        self.ppb_icdf = np.asarray(T.PULSES_PER_BLOCK_ICDF,
                                   np.uint8).reshape(10, 18)
        # per-count zero-padded iCDF rows: [17, 18] per level, so the
        # masked decode never reads past a row into the next one's data
        # (row for count p spans offsets[p]:offsets[p+1], terminated 0)
        offs = list(TD.SHELL_CODE_TABLE_OFFSETS)
        self.shell = []
        for t in (TD.SHELL_CODE_TABLE0, TD.SHELL_CODE_TABLE1,
                  TD.SHELL_CODE_TABLE2, TD.SHELL_CODE_TABLE3):
            flat = np.asarray(t, np.uint8)
            ends = offs[1:] + [len(flat)]
            rows = [flat[offs[p]:ends[p]] for p in range(17)]
            self.shell.append(_pad_icdf(rows, 18))
        self.sign_icdf = np.asarray(TD.SIGN_ICDF, np.uint8)
        self.lsb = np.asarray(TD.LSB_ICDF, np.uint8)      # port only
        self.quant_offsets = np.asarray(T.QUANTIZATION_OFFSETS_Q10,
                                        np.int32)
        self.lsf_cos = np.asarray(TD.LSFCOSTAB_FIX_Q12, np.int32)
        # pitch contour codebooks
        if fs_khz == 8:
            cbk = T.CB_LAGS_STAGE2 if nb_subfr == 4 else T.CB_LAGS_STAGE2_10MS
        else:
            cbk = T.CB_LAGS_STAGE3 if nb_subfr == 4 else T.CB_LAGS_STAGE3_10MS
        self.lag_cb = np.asarray(cbk, np.int32)     # [nb_subfr, ncontour]
        self.ordering = np.asarray(
            (0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1)
            if self.order == 16 else (0, 9, 6, 3, 4, 5, 8, 1, 2, 7),
            np.int32)

    def t(self, name: str, device):
        """Table ``name`` (``shell0``..``shell3`` for the shell levels) as
        an int64 tensor on ``device``."""
        def make():
            v = self.shell[int(name[5:])] if name.startswith("shell") \
                else getattr(self, name)
            return np.asarray(v).astype(np.int64)
        return const(("silk", self.fs_khz, self.nb_subfr, name), make,
                     device)


@lru_cache(maxsize=None)
def silk_tabs(fs_khz: int = 16, nb_subfr: int = 4) -> _SilkTabs:
    return _SilkTabs(fs_khz, nb_subfr)


def _any(mask) -> bool:
    """Whether any lane of a mask is set (one host read)."""
    return bool(mask.any())


# ===================================================================== #
# NLSF -> LPC, int32-exact (silk/NLSF2A.c + LPC_fit.c + inv-pred-gain)  #
# ===================================================================== #

def _bwexpander_32(ar, chirp_q16):
    """silk_bwexpander_32 over [B, d] with per-lane chirp [B]."""
    d = ar.shape[1]
    chirp_minus_one = chirp_q16 - 65536
    cols = []
    for i in range(d - 1):
        cols.append(F.smulww(chirp_q16, ar[:, i]))
        chirp_q16 = w32(chirp_q16
                        + F.rshift_round64(chirp_q16 * chirp_minus_one, 16))
    cols.append(F.smulww(chirp_q16, ar[:, d - 1]))
    return torch.stack(cols, dim=1)


def _lpc_fit(a_qin, qout: int, qin: int):
    """silk/LPC_fit.c over [B, d]; returns (a_out int16vals [B, d],
    a_qin')."""
    sh = qin - qout
    fitted = torch.zeros(a_qin.shape[0], dtype=torch.bool,
                         device=a_qin.device)
    for _ in range(10):
        absa = w32(a_qin.abs())            # int32 abs (wraps at INT_MIN)
        idx = absa.argmax(dim=1)           # the first maximum, as JAX's
        maxabs = F.rshift_round(absa.amax(dim=1), sh)
        over = (~fitted) & (maxabs > 32767)
        if not _any(over):
            break                          # every later round is a no-op
        mx = maxabs.clamp_max(163838)
        chirp = w32(65470 - F.div32(w32((mx - 32767) << 14),
                                    ((mx * (idx + 1)) >> 2).clamp_min(1)))
        expanded = _bwexpander_32(a_qin, chirp)
        a_qin = torch.where(over[:, None], expanded, a_qin)
        fitted = fitted | ~over
    # force-fit lanes that never converged (reference: the i==10 path);
    # in-range lanes are untouched because the round trip is exact
    rounded = F.rshift_round(a_qin, sh)
    still = rounded.abs().amax(dim=1) > 32767
    forced = F.sat16(rounded)
    a_qin = torch.where(still[:, None], w32(forced << sh), a_qin)
    return F.sat16(F.rshift_round(a_qin, sh)), a_qin


_A_LIMIT = 16773022   # SILK_FIX_CONST(0.99975, 24)


def _rc_step(a, inv_gain_q30):
    """One reflection coefficient from a Q24 coefficient column: (ok,
    rc_q31, rc_mult1_q30, new inv_gain_q30)."""
    ok = (a <= _A_LIMIT) & (a >= -_A_LIMIT)
    rc_q31 = w32(-w32(a << 7))
    rc_mult1_q30 = w32((1 << 30) - F.smmul(rc_q31, rc_q31))
    inv_gain_q30 = w32(F.smmul(inv_gain_q30, rc_mult1_q30) << 2)
    return ok & (inv_gain_q30 >= 107374), rc_q31, rc_mult1_q30, inv_gain_q30


def _lpc_inverse_pred_gain(a_q12, order: int, q30: bool = False):
    """Returns stable [B] bool (inv gain > 0), int32-exact
    (silk/LPC_inv_pred_gain.c); with q30=True also the inverse prediction
    gain in Q30 (0 where not stable)."""
    a_qa = w32(a_q12 << (24 - 12))
    ok = w32(a_q12.sum(dim=1)) < 4096
    inv_gain_q30 = torch.full_like(ok, 1 << 30, dtype=torch.int64)
    for k in range(order - 1, 0, -1):
        ok_k, rc_q31, rc_mult1_q30, inv_gain_q30 = _rc_step(a_qa[:, k],
                                                            inv_gain_q30)
        ok = ok & ok_k
        mult2q = 32 - F.clz32(rc_mult1_q30.abs())
        rc_mult2 = F.inverse32_varq(rc_mult1_q30, mult2q + 30)
        # the (k+1)>>1 head/tail pair updates are independent within one k
        nhalf = (k + 1) >> 1
        tmp1 = a_qa[:, :nhalf]
        tmp2 = a_qa[:, k - nhalf:k].flip(1)       # a_qa[k-n-1]
        rc = rc_q31[:, None]
        m2, q2 = rc_mult2[:, None], mult2q[:, None]
        # MUL32_FRAC_Q(a, b, 31) is a rounded 64-bit shift (silk/macros.h;
        # the scalar decoder's lpc_inverse_pred_gain): truncating moves the
        # PLC's unvoiced noise gain
        t1 = F.sat32(tmp1 - F.rshift_round64_checked(tmp2 * rc, 31)[0])
        new1, fit1 = F.rshift_round64_checked(t1 * m2, q2)
        t2 = F.sat32(tmp2 - F.rshift_round64_checked(tmp1 * rc, 31)[0])
        new2, fit2 = F.rshift_round64_checked(t2 * m2, q2)
        ok = ok & fit1.all(dim=1) & fit2.all(dim=1)
        # scatter back: positions [0..nhalf) and [k-1 .. k-nhalf]
        # (for odd k the middle position is in both halves: new2 wins)
        upd = torch.cat([new1[:, :k - nhalf], new2.flip(1), a_qa[:, k:]],
                        dim=1)
        a_qa = torch.where(ok[:, None], upd, a_qa)
    ok_0, _rc, _m1, gain = _rc_step(a_qa[:, 0], inv_gain_q30)
    ok = ok & ok_0
    return (ok, torch.where(ok, gain, 0)) if q30 else ok


def lpc_inverse_pred_gain_q30(a_q12, order: int):
    """silk_LPC_inverse_pred_gain over [B, >= order] int16-valued
    coefficients: the inverse prediction gain in Q30, 0 if unstable."""
    return _lpc_inverse_pred_gain(a_q12[:, :order], order, q30=True)[1]


def _nlsf2a(tabs: _SilkTabs, nlsf_q15):
    """silk_NLSF2A over [B, order]; returns (a_q12 [B, 16] (int16 values;
    unused tail zero), unstable [B] bool)."""
    d = tabs.order
    b = nlsf_q15.shape[0]
    dev = nlsf_q15.device
    cos_tab = tabs.t("lsf_cos", dev)
    f_int = (nlsf_q15 >> 8).clamp(0, cos_tab.shape[0] - 2)
    f_frac = nlsf_q15 - (f_int << 8)
    cos_val = cos_tab[f_int]
    delta = cos_tab[f_int + 1] - cos_val
    clsf_at = F.rshift_round(w32((cos_val << 8) + delta * f_frac), 4)
    inv = const(("silk_nlsf_order_inv", d),
                lambda: np.argsort(tabs.ordering[:d]), dev)
    cos_lsf = clsf_at[:, inv]          # cos_lsf[:, ordering[k]] = clsf_at[k]

    # P and Q polynomials together: column 0 of each [B, 2] is P's
    # (even cos_lsf entries), column 1 is Q's (odd ones)
    dd = d >> 1
    cs = cos_lsf.reshape(b, dd, 2)
    out = [torch.zeros((b, 2), dtype=torch.int64, device=dev)
           for _ in range(dd + 1)]
    out[0] = torch.full((b, 2), 1 << QA, dtype=torch.int64, device=dev)
    out[1] = -cs[:, 0]
    for k in range(1, dd):
        ftmp = cs[:, k]
        new = list(out)
        new[k + 1] = w32((out[k - 1] << 1)
                         - F.rshift_round64(ftmp * out[k], QA))
        for n in range(k, 1, -1):
            new[n] = w32(out[n] + out[n - 2]
                         - F.rshift_round64(ftmp * out[n - 1], QA))
        new[1] = w32(out[1] - ftmp)
        out = new
    pq = torch.stack(out, dim=1)                         # [B, dd+1, 2]
    ptmp = pq[:, 1:, 0] + pq[:, :-1, 0]
    qtmp = pq[:, 1:, 1] - pq[:, :-1, 1]
    a32_qa1 = w32(torch.cat([-qtmp - ptmp, (qtmp - ptmp).flip(1)], dim=1))

    a_q12, a32_qa1 = _lpc_fit(a32_qa1, 12, QA + 1)
    # stabilization: the reference allows up to 16 bandwidth-expansion
    # rounds; decoded (spacing-stabilized) NLSFs need at most a couple.
    # Run 2 and flag the (pathological) remainder for scalar fallback.
    # A round in which every lane is stable changes nothing, and then
    # neither does any later one.
    stable = _lpc_inverse_pred_gain(a_q12, d)
    for it in range(2):
        need = ~stable
        if not _any(need):
            break
        a32_new = _bwexpander_32(a32_qa1, torch.full_like(
            need, 65536 - (2 << it), dtype=torch.int64))
        a32_qa1 = torch.where(need[:, None], a32_new, a32_qa1)
        a_new = F.sat16(F.rshift_round(a32_qa1, QA + 1 - 12))
        a_q12 = torch.where(need[:, None], a_new, a_q12)
        stable = _lpc_inverse_pred_gain(a_q12, d)
    if d < MAX_LPC_ORDER:
        a_q12 = torch.cat([a_q12, a_q12.new_zeros((b, MAX_LPC_ORDER - d))],
                          dim=1)
    return a_q12, ~stable


def _nlsf_diffs(nlsf, dmin):
    """The L+1 spacing margins of silk_NLSF_stabilize, [B, L+1]."""
    L = nlsf.shape[1]
    d0 = nlsf[:, :1] - dmin[0]
    dmid = nlsf[:, 1:] - (nlsf[:, :-1] + dmin[1:L][None, :])
    dlast = (1 << 15) - (nlsf[:, L - 1:] + dmin[L])
    return torch.cat([d0, dmid, dlast], dim=1)


def _nlsf_stabilize(nlsf, dmin_np):
    """silk_NLSF_stabilize over [B, L] (20 rounds + sorted fallback)."""
    L = nlsf.shape[1]
    dev = nlsf.device
    dmin_np = [int(v) for v in dmin_np]
    key = tuple(dmin_np)
    dmin = const(("silk_dmin", key), lambda: np.asarray(key, np.int64), dev)
    csumj = const(("silk_dmin_csum", key), lambda: np.concatenate(
        [[0], np.cumsum(key)]).astype(np.int64), dev)
    tot = sum(dmin_np)
    cols = torch.arange(L, device=dev)[None, :]
    for _ in range(20):
        diffs = _nlsf_diffs(nlsf, dmin)
        go = diffs.amin(dim=1) < 0
        if not _any(go):
            break                          # sorted: every later round too
        imin = diffs.argmin(dim=1)         # the first minimum, as JAX's
        dm = dmin[imin]
        min_center = csumj[imin] + (dm >> 1)
        max_center = (1 << 15) - (tot - csumj[imin] - dm) - (dm >> 1)
        ip = (imin - 1).clamp(0, L - 1)
        ic = imin.clamp(0, L - 1)
        prev = nlsf.gather(1, ip[:, None])[:, 0]
        cur = nlsf.gather(1, ic[:, None])[:, 0]
        center = torch.minimum(torch.maximum(
            F.rshift_round(prev + cur, 1), min_center), max_center)
        newprev = center - (dm >> 1)
        mid = (go & (imin > 0) & (imin < L))[:, None]
        nlsf = torch.where(mid & (cols == ip[:, None]), newprev[:, None],
                           nlsf)
        nlsf = torch.where(mid & (cols == ic[:, None]),
                           (newprev + dm)[:, None], nlsf)
        first = (go & (imin == 0))[:, None] & (cols == 0)
        nlsf = torch.where(first, dmin[0], nlsf)
        last = (go & (imin == L))[:, None] & (cols == L - 1)
        nlsf = torch.where(last, (1 << 15) - dmin[L], nlsf)
    # fallback for lanes still unsorted (reference: the post-loop path)
    bad = _nlsf_diffs(nlsf, dmin).amin(dim=1) < 0
    if not _any(bad):
        return nlsf
    srt = list(torch.sort(nlsf, dim=1).values.unbind(1))
    srt[0] = srt[0].clamp_min(dmin_np[0])
    for i in range(1, L):
        srt[i] = torch.maximum(srt[i], (srt[i - 1] + dmin_np[i])
                               .clamp_max(32767))          # ADD_SAT16
    srt[L - 1] = srt[L - 1].clamp_max((1 << 15) - dmin_np[L])
    for i in range(L - 2, -1, -1):
        srt[i] = torch.minimum(srt[i], srt[i + 1] - dmin_np[i + 1])
    return torch.where(bad[:, None], torch.stack(srt, dim=1), nlsf)


# ===================================================================== #
# the symbol pass                                                       #
# ===================================================================== #

def fused_init_state(batch: int, fs_khz: int = 16, device="cpu",
                     nb_subfr: int = 4) -> dict:
    """The ``FusedSilkState`` fields as a dict (``synth`` is the
    ``batched_silk.init_state`` dict; ``first_frame`` is the scalar's
    ``first_frame_after_reset``), plus the loss fields of
    ``silk_plc.loss_init_state``."""
    def full(shape, v, dtype=torch.int64):
        return torch.full(shape, v, dtype=dtype, device=device)
    return dict(prev_nlsf=full((batch, MAX_LPC_ORDER), 0),
                last_gain_index=full((batch,), 10),
                prev_gain_q16=full((batch,), 1 << 16),
                first_frame=full((batch,), True, torch.bool),
                synth=init_state(batch, fs_khz, device),
                **PLC.loss_init_state(batch, fs_khz, nb_subfr, device))


class _Ctx:
    """One frame's packet bytes, lengths and tables on their device."""

    def __init__(self, buf, lens, tabs: _SilkTabs):
        self.buf, self.lens, self.tabs = buf, lens, tabs
        self.dev = buf.device

    def t(self, name):
        return self.tabs.t(name, self.dev)

    def dec(self, d, table, active, skip_if_idle=False):
        """One masked iCDF symbol; with skip_if_idle, nothing is decoded
        when no lane is active (the symbol is 0 on inactive lanes)."""
        if skip_if_idle and not _any(active):
            return torch.zeros_like(d["rng"]), d
        if isinstance(table, str):
            table = self.t(table)
        return rk_dec_icdf(d, self.buf, self.lens, table, 8, active)


def _shell_split(d, ctx: _Ctx, level: int, p, active):
    """One shell SPLIT against the level's code table (shell_coder.c):
    returns (child1, child2, state)."""
    act = active & (p > 0)
    table = ctx.t(f"shell{level}")[p.clamp(0, 16)]
    c1, d = ctx.dec(d, table, act)
    c1 = torch.where(act, c1, 0)
    return c1, torch.where(act, p - c1, 0), d


def _shell_block(d, ctx: _Ctx, sp, active):
    """The 15-split shell tree of one 16-sample block in the reference's
    depth-first symbol order (silk_shell_decoder); returns (d, [B, 16])."""
    p0 = [None] * 16

    def split(d, level, p, base):
        a, b_, d = _shell_split(d, ctx, level, p, active)
        if level == 0:
            p0[base], p0[base + 1] = a, b_
            return d
        half = 1 << level
        d = split(d, level - 1, a, base)
        return split(d, level - 1, b_, base + half)

    d = split(d, 3, sp, 0)
    return d, torch.stack(p0, dim=1)


# the frame's coding of its indices relative to the frame before it in the
# packet (silk/define.h)
CODE_INDEPENDENTLY = 0
CODE_INDEPENDENTLY_NO_LTP_SCALING = 1
CODE_CONDITIONALLY = 2


def _frame_symbols(d, ctx: _Ctx, active, type_ix, error, nb_subfr: int,
                   fs_khz: int, cond=None, prev=None):
    """The indices after the signal type, then the pulses, of one frame
    (decode_indices.c; decode_pulses.c).  cond [B] (CODE_*, default
    independent): a conditionally coded frame (a later frame of a 40/60 ms
    packet) codes its first gain as a delta and its pitch lag as a delta
    from the frame before (``prev``: that frame's (signal type, lag
    index) [B] lanes) where that one was voiced, and no LTP scale (nor
    does CODE_INDEPENDENTLY_NO_LTP_SCALING).  Returns (d, error, symbols
    dict)."""
    tabs = ctx.tabs
    b = d["rng"].shape[0]
    dev = ctx.dev
    L = nb_subfr * 5 * fs_khz
    order = tabs.order
    signal_type = type_ix >> 1
    if cond is None:
        cond = torch.zeros_like(type_ix)
    delta_g = active & (cond == CODE_CONDITIONALLY)

    g_hi, d = ctx.dec(d, ctx.t("gain_icdf")[signal_type], active & ~delta_g)
    g_lo, d = ctx.dec(d, "uniform8", active & ~delta_g)
    g_d, d = ctx.dec(d, "delta_gain", delta_g, skip_if_idle=True)
    gains_deltas = []
    for _ in range(nb_subfr - 1):
        gd, d = ctx.dec(d, "delta_gain", active)
        gains_deltas.append(gd)

    cb1, d = ctx.dec(d, ctx.t("cb1_icdf")[signal_type >> 1], active)
    # NLSF_unpack (NLSF_unpack.c)
    half = order // 2
    sel = ctx.t("ec_sel")[cb1[:, None] * half
                          + torch.arange(half, device=dev)[None, :]]
    ec_ix = torch.stack([(sel >> 1) & 7, (sel >> 5) & 7], dim=2) \
        .reshape(b, order) * (2 * NLSF_QUANT_MAX_AMPLITUDE + 1)
    even = torch.arange(0, order, 2, device=dev)[None, :]
    pidx = torch.stack([even + (sel & 1) * (order - 1),
                        even + 1 + ((sel >> 4) & 1) * (order - 1)],
                       dim=2).reshape(b, order)
    pred_q8 = ctx.t("pred_q8")[pidx]
    ecj = ctx.t("ec_icdf")
    ar9 = torch.arange(9, device=dev)[None, :]
    nlsf_idx = []
    for i in range(order):
        ix, d = ctx.dec(d, ecj[ec_ix[:, i:i + 1] + ar9], active)
        lo_ext = active & (ix == 0)
        hi_ext = active & (ix == 2 * NLSF_QUANT_MAX_AMPLITUDE)
        e_lo, d = ctx.dec(d, "nlsf_ext", lo_ext, skip_if_idle=True)
        e_hi, d = ctx.dec(d, "nlsf_ext", hi_ext, skip_if_idle=True)
        ix = torch.where(lo_ext, ix - e_lo, torch.where(hi_ext, ix + e_hi,
                                                        ix))
        nlsf_idx.append(ix - NLSF_QUANT_MAX_AMPLITUDE)
    nlsf_idx = torch.stack(nlsf_idx, dim=1)

    if nb_subfr == 4:
        interp_q2, d = ctx.dec(d, "nlsf_interp", active)
    else:
        interp_q2 = torch.full_like(cb1, 4)

    voiced = active & (signal_type == 2)
    # a conditional frame after a voiced one: a lag delta, 0 = absolute
    rel = voiced & delta_g & (prev[0] == 2) if prev is not None \
        else torch.zeros_like(voiced)
    dl, d = ctx.dec(d, "pitch_delta", rel, skip_if_idle=True)
    rel = rel & (dl > 0)
    lag_hi, d = ctx.dec(d, "pitch_lag", voiced & ~rel, skip_if_idle=True)
    lag_lo, d = ctx.dec(d, "lag_low", voiced & ~rel, skip_if_idle=True)
    contour, d = ctx.dec(d, "contour", voiced, skip_if_idle=True)
    per_index, d = ctx.dec(d, "per_index", voiced, skip_if_idle=True)
    ltp_rows = ctx.t("ltp_gain")[per_index]
    ltp_idx = []
    for _ in range(nb_subfr):
        li, d = ctx.dec(d, ltp_rows, voiced, skip_if_idle=True)
        ltp_idx.append(li)
    scale_ix, d = ctx.dec(d, "ltp_scale_icdf",
                          voiced & (cond == CODE_INDEPENDENTLY),
                          skip_if_idle=True)
    seed, d = ctx.dec(d, "uniform4", active)

    # --- decode_pulses (decode_pulses.c) ---
    # Bitstream order as the reference's: all per-block sum-pulse symbols
    # (with escapes) first, then all shell trees, then all LSB rounds,
    # then all signs (decode_pulses.c:66-115).
    rate_level, d = ctx.dec(d, ctx.t("rate_levels")[signal_type >> 1],
                            active)
    ppb = ctx.t("ppb_icdf")
    ppb_rows = ppb[rate_level]
    # a 10 ms frame at 12 kHz (120 samples) codes a last half block: 8
    # shell blocks (decode_pulses.c:64-67)
    nblocks = (L + 15) // 16
    sum_pulses, nshifts = [], []
    # the escape's table, and at the 10th escape the same table less its
    # first entry (decode_pulses.c:76-82)
    esc_tabs = (ppb[9], torch.cat([ppb[9][1:], ppb[9][:1] * 0]))
    for _ in range(nblocks):
        sp, d = ctx.dec(d, ppb_rows, active)
        # LSB escapes: each further round, while a lane's symbol is 17
        esc = active & (sp == 17)
        ns = torch.zeros_like(sp)
        for r in range(1, 11):
            if not _any(esc):
                break
            sp_r, d = ctx.dec(d, esc_tabs[r == 10], esc)
            ns = ns + esc.to(torch.int64)
            sp = torch.where(esc, sp_r, sp)
            esc = esc & (sp_r == 17)
        sum_pulses.append(sp)
        nshifts.append(ns)
    sum_pulses = torch.stack(sum_pulses, dim=1)          # [B, nblocks]
    nshifts = torch.stack(nshifts, dim=1)

    shell_on = (active[:, None] & (sum_pulses > 0)).any(dim=0).tolist()
    blocks = []
    for k in range(nblocks):
        if shell_on[k]:
            d, blk = _shell_block(d, ctx, sum_pulses[:, k], active)
        else:
            blk = torch.zeros((b, 16), dtype=torch.int64, device=dev)
        blocks.append(blk)

    # LSB rounds (decode_pulses.c:94-110), sample-major with the
    # per-sample shift loop innermost like the reference (k outer, j
    # inner); a block runs as many rounds as its active lanes need
    lsb_tab = ctx.t("lsb")
    rounds = torch.where(active[:, None], nshifts, 0).amax(dim=0)
    for k, nr in enumerate(rounds.tolist()):
        cols = list(blocks[k].unbind(1))
        for j in range(16 if nr else 0):
            for r in range(nr):
                m = active & (nshifts[:, k] > r)
                lsb, d = ctx.dec(d, lsb_tab, m)
                cols[j] = torch.where(m, (cols[j] << 1) + lsb, cols[j])
        blocks[k] = torch.stack(cols, dim=1)
    blocks = torch.stack(blocks, dim=1)                  # [B, nblocks, 16]

    # signs (code_signs.c): icdf picked by the shell-level pulse count,
    # applied to post-LSB nonzero samples; blocks with only-LSB energy
    # still code signs (sum_pulses |= nLS<<5, decode_pulses.c:108)
    quant_offset_type = type_ix & 1
    i0 = 7 * (quant_offset_type + (signal_type << 1))
    has = active[:, None] & ((sum_pulses > 0) | (nshifts > 0))
    coded = has[:, :, None] & (blocks > 0)               # [B, nblocks, 16]
    sign_on = coded.any(dim=0).tolist()
    signj = ctx.t("sign_icdf")
    icdf0 = signj[i0[:, None] + sum_pulses.clamp_max(6)]  # [B, nblocks]
    signs = torch.ones_like(blocks)
    for k in range(nblocks):
        if not any(sign_on[k]):
            continue
        table = torch.stack([icdf0[:, k], torch.zeros_like(icdf0[:, k])],
                            dim=1)
        for j in range(16):
            if sign_on[k][j]:
                m = coded[:, k, j]
                sgn, d = ctx.dec(d, table, m)
                signs[:, k, j] = torch.where(m, 2 * sgn - 1, 1)
    pulses = (blocks * signs).reshape(b, 16 * nblocks)[:, :L]
    lag_index = lag_hi * (fs_khz >> 1) + lag_lo
    if prev is not None:
        lag_index = torch.where(rel, prev[1] + dl - 9, lag_index)
    syms = dict(signal_type=signal_type, quant_offset_type=quant_offset_type,
                gains_idx0=torch.where(delta_g, g_d, (g_hi << 3) + g_lo),
                gains_deltas=gains_deltas, gain_delta0=delta_g,
                cb1=cb1, pred_q8=pred_q8, nlsf_idx=nlsf_idx,
                interp_q2=interp_q2, lag_index=lag_index, contour=contour,
                per_index=per_index, ltp_idx=ltp_idx, scale_ix=scale_ix,
                seed=seed, pulses=pulses)
    return d, error, syms


def _lbrr_symbols(d, ctx: _Ctx, active, error, nb_subfr: int,
                  fs_khz: int, cond=None, prev=None):
    """One LBRR frame's indices + pulses (silk_decode_indices with
    decode_LBRR=1, i.e. the VAD type table, then silk_decode_pulses;
    dec_API.c:258-283 parses them through on a normal decode,
    decode_frame.c decodes them in place of a lost frame).  cond, prev:
    as ``_frame_symbols`` (an LBRR frame after an LBRR frame is coded
    conditionally).  Returns (d, error, symbols dict)."""
    t_ix, d = ctx.dec(d, "type_vad", active)
    return _frame_symbols(d, ctx, active, t_ix + 2, error, nb_subfr, fs_khz,
                          cond, prev)


def _zero_lanes(b: int, dev):
    return torch.zeros((b,), dtype=torch.int64, device=dev)


def silk_header(d, ctx: _Ctx, nframes: int, nch: int, active):
    """A SILK packet's header (dec_API.c:252-270): each channel's VAD flag
    per frame and LBRR flag, then each channel's per-frame LBRR flags (one
    symbol of LBRR_FLAGS_{2,3}_ICDF for a packet of 2-3 frames).  Returns
    (d, vad [nch][nframes] bool lanes, lbrr [nch][nframes] bool lanes)."""
    vad, has = [], []
    for _n in range(nch):
        row = []
        for _i in range(nframes):
            v, d = rk_dec_bit_logp(d, ctx.buf, ctx.lens, 1, active)
            row.append(active & (v != 0))
        vad.append(row)
        f, d = rk_dec_bit_logp(d, ctx.buf, ctx.lens, 1, active)
        has.append(active & (f != 0))
    lbrr = []
    for n in range(nch):
        if nframes == 1:
            lbrr.append([has[n]])
            continue
        sym, d = ctx.dec(d, f"lbrr_flags{nframes}", has[n],
                         skip_if_idle=True)
        sym = torch.where(has[n], sym + 1, 0)
        lbrr.append([has[n] & (((sym >> i) & 1) != 0)
                     for i in range(nframes)])
    return d, vad, lbrr


def stereo_pred_symbols(d, ctx: _Ctx, active, mid_only_read):
    """stereo_decode_pred and stereo_decode_mid_only (silk/stereo.py:12,
    :32): the joint index, then per channel a 3- and a 5-level index;
    then, on ``mid_only_read`` lanes, the mid-only flag.  Returns (d,
    (n0, [ix0, ix1] x 2 channels), mid_only [B])."""
    n, d = ctx.dec(d, "stereo_joint", active)
    ix = []
    for _ch in range(2):
        a, d = ctx.dec(d, "uniform3", active)
        c, d = ctx.dec(d, "uniform5", active)
        ix.append((a, c))
    mo, d = ctx.dec(d, "mid_only", mid_only_read, skip_if_idle=True)
    return d, (n, ix), mo


def skip_lbrr(d, ctx: _Ctx, lbrr, nframes: int, nb_subfr: int,
              fs_khz: int, active, error):
    """A normal decode's parse-through of every LBRR frame of the packet
    (dec_API.c:271-296), frame by frame and channel by channel: a mid
    channel's frame is preceded by the stereo prediction (and the
    mid-only flag where the side carries no LBRR frame); a frame after an
    LBRR frame of its channel is coded conditionally.  Returns (d,
    error)."""
    nch = len(lbrr)
    b = d["rng"].shape[0]
    prev = [(_zero_lanes(b, ctx.dev), _zero_lanes(b, ctx.dev))
            for _ in range(nch)]
    for i in range(nframes):
        for n in range(nch):
            m = active & lbrr[n][i]
            if not _any(m):
                continue
            if nch == 2 and n == 0:
                d, _p, _mo = stereo_pred_symbols(d, ctx, m, m & ~lbrr[1][i])
            cond = torch.where(lbrr[n][i - 1], CODE_CONDITIONALLY,
                               CODE_INDEPENDENTLY) if i > 0 else None
            d, error, sy = _lbrr_symbols(d, ctx, m, error, nb_subfr,
                                         fs_khz, cond, prev[n])
            prev[n] = _next_prev(prev[n], sy, m)
    return d, error


def _next_prev(prev, sy, m):
    """The (signal type, lag index) a conditionally coded next frame reads:
    the type always, the lag where the frame was voiced (decode_indices.c
    ec_prevSignalType / ec_prevLagIndex)."""
    sig = torch.where(m, sy["signal_type"], prev[0])
    lag = torch.where(m & (sy["signal_type"] == 2), sy["lag_index"],
                      prev[1])
    return sig, lag


def _zero_symbols(b: int, order: int, nb_subfr: int, L: int, dev) -> dict:
    """``_frame_symbols``' dict of a frame no lane decodes (its lanes
    conceal instead)."""
    z = torch.zeros((b,), dtype=torch.int64, device=dev)
    return dict(signal_type=z, quant_offset_type=z, gains_idx0=z,
                gains_deltas=[z] * (nb_subfr - 1),
                gain_delta0=torch.zeros_like(z, dtype=torch.bool), cb1=z,
                pred_q8=z.new_zeros((b, order)),
                nlsf_idx=z.new_zeros((b, order)), interp_q2=z + 4,
                lag_index=z, contour=z, per_index=z, ltp_idx=[z] * nb_subfr,
                scale_ix=z, seed=z, pulses=z.new_zeros((b, L)))


_LCG_A = 196314165
_LCG_C = 907633515


def _mulu32(a, c: int):
    """(a * c) mod 2**32 for uint32 lanes a and a uint32 constant c, in
    16-bit halves of c so no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def _lcg_signs(pulses, seed):
    """Sign of the excitation LCG at each sample (decode_core.c:80-96):
    rand_seed = C + A * rand_seed before sample i, then rand_seed += p_i.
    The state before step i is t_i = A**i * seed + pb_(i-1), pb the
    inclusive prefix of the affine maps x -> A x + C + p_i; pb comes from
    a doubling scan (b_i += A**s * b_(i-s)).  Returns [B, L] bool: the
    rand_seed at sample i is negative as an int32."""
    b, L = pulses.shape
    pb = (pulses + _LCG_C) & M32
    s = 1
    while s < L:
        a_s = pow(_LCG_A, s, 1 << 32)
        pb = torch.cat([pb[:, :s],
                        (_mulu32(pb[:, :-s], a_s) + pb[:, s:]) & M32], dim=1)
        s <<= 1
    a_pow = const(("silk_lcg_pow", L), lambda: np.asarray(
        [pow(_LCG_A, i, 1 << 32) for i in range(L)], np.int64),
        pulses.device)
    t_prev = (a_pow[None, :] * seed[:, None]
              + torch.cat([torch.zeros_like(pb[:, :1]), pb[:, :-1]], 1)) \
        & M32
    r = (_LCG_A * t_prev + _LCG_C) & M32
    return r >= (1 << 31)


def silk_symbols(buf, lens, state: dict, *, fs_khz: int = 16,
                 nb_subfr: int = 4, osce: bool = False, lbrr=None,
                 active=None, d0=None, frame: int = 0, nframes: int = 1,
                 header: bool = True, cond=None):
    """The symbol pass of one frame: range decoding and decode_parameters.
    Returns (the ``silk_decode_step`` inputs as a dict, the carried state
    fields prev_nlsf / last_gain_index / prev_gain_q16 and under ``frame``
    the frame's signal_type, gains_q16, ltp_scale_q14 and lbrr_flag (the
    header's LBRR bit), error [B] bool, the final range-decoder dict).
    ``lbrr`` ([B] bool): lanes that decode the packet's LBRR frame in
    place of its regular one (in-band FEC, decode_frame.c with
    FLAG_DECODE_LBRR: the VAD type table, CODE_INDEPENDENTLY); their range
    decoder stops after it, or after the header where the packet carries
    none.  ``active`` ([B] bool): lanes outside it decode nothing (their
    outputs are don't-care).  With osce=True appends the frame's OSCE
    inputs, the keyword arguments of ``OSCEEnhancer.enhance_frame`` but
    xq (decode_frame.c:113, ``silk/decoder.py``'s enhance_frame call):
    num_bits [B], the bits of the regular frame's indices and pulses
    (tell after them less tell before them, the LBRR parse-through
    excluded), pred_coef_q12 [B, 2, order], pitch_lags [B, nb_subfr],
    ltp_coef_q14 [B, 5 * nb_subfr], gains_q16 [B, nb_subfr],
    signal_type [B], and lpc_order, fs_khz and nb_subfr as ints.

    Packets of 2-3 frames (40/60 ms, ``nframes``): frame ``frame`` of the
    packet, the range decoder continuing from ``d0`` (the dict the call
    for the frame before returned).  With ``header`` (on the packet's
    first frame), the call parses the header (each frame's VAD flag, the
    LBRR flags), and a normal decode parses every LBRR frame through;
    the flags go into the state (``vad_flags``, ``lbrr_flags`` [B, 3]) for
    the later frames.  Without it (a stereo packet, whose header the
    caller parses), the state holds them already and d0 is where the
    frame starts.  A later frame is coded conditionally (``cond`` [B]
    overrides on every lane, for a stereo side channel), from
    ``ec_prev_type`` / ``ec_prev_lag`` of the frame before; an FEC lane
    decodes the packet's LBRR frame ``frame``, conditionally after an
    LBRR frame."""
    tabs = silk_tabs(fs_khz, nb_subfr)
    b = buf.shape[0]
    dev = buf.device
    lens = lens.to(torch.int64).clamp(0, buf.shape[1])
    ctx = _Ctx(buf, lens, tabs)
    order = tabs.order
    active = lane_mask(active, b, dev)
    fec = torch.zeros_like(active) if lbrr is None else lane_mask(lbrr, b,
                                                                  dev)
    error = torch.zeros_like(active)
    reg = active & ~fec
    multi = nframes > 1
    flags = {}
    if header:
        # --- header flags (dec_API.c:252) ---
        d = rk_init(buf, lens) if d0 is None else d0
        d, vad_l, lbrr_l = silk_header(d, ctx, nframes, 1, active)
        vadk, lbk = vad_l[0][frame], lbrr_l[0][frame]
        # a normal decode parses the LBRR frames (in-band FEC: indices +
        # pulses with the VAD type table, dec_API.c:258-283) through, so
        # the range decoder lands on the regular frame
        d, error = skip_lbrr(d, ctx, lbrr_l, nframes, nb_subfr, fs_khz,
                             reg, error)
        if multi:
            pad = [torch.zeros_like(active)] * (3 - nframes)
            flags = dict(vad_flags=torch.stack(vad_l[0] + pad, 1),
                         lbrr_flags=torch.stack(lbrr_l[0] + pad, 1))
    else:
        d = d0
        vadk = state["vad_flags"][:, frame]
        lbk = state["lbrr_flags"][:, frame]
    prev = (state["ec_prev_type"], state["ec_prev_lag"]) if frame > 0 \
        else None
    if cond is None:
        cond = torch.full_like(state["last_gain_index"],
                               CODE_CONDITIONALLY if frame > 0
                               else CODE_INDEPENDENTLY)
        if frame > 0:
            cond = torch.where(fec, torch.where(
                state["lbrr_flags"][:, frame - 1], CODE_CONDITIONALLY,
                CODE_INDEPENDENTLY), cond)

    # --- decode_indices (decode_indices.c) ---
    ec_start = rk_tell(d) if osce else None
    fl = fec & active & lbk
    on = reg | fl
    if _any(on):
        tv = (reg & vadk) | fl
        t_vad, d = ctx.dec(d, "type_vad", tv)
        t_nv, d = ctx.dec(d, "type_novad", reg & ~vadk)
        type_ix = torch.where(tv, t_vad + 2, t_nv)
        d, error, s = _frame_symbols(d, ctx, on, type_ix, error, nb_subfr,
                                     fs_khz, cond, prev)
    else:
        s = _zero_symbols(b, order, nb_subfr, nb_subfr * 5 * fs_khz, dev)
    signal_type = s["signal_type"]

    # --- decode_parameters ---
    # gains (gain_quant.c silk_gains_dequant; a conditional frame's first
    # gain is a delta too)
    prev_ind = state["last_gain_index"]
    gains_q16 = []
    for k in range(nb_subfr):
        if k == 0:
            ind_tmp = s["gains_idx0"] - 4
            dst = 2 * 36 - 64 + prev_ind
            rel = prev_ind + torch.where(ind_tmp > dst, (ind_tmp << 1) - dst,
                                         ind_tmp)
            prev_ind = torch.where(s["gain_delta0"], rel, torch.maximum(
                s["gains_idx0"], prev_ind - 16))
        else:
            ind_tmp = s["gains_deltas"][k - 1] - 4    # MIN_DELTA_GAIN_QUANT
            dst = 2 * 36 - 64 + prev_ind
            prev_ind = prev_ind + torch.where(ind_tmp > dst,
                                              (ind_tmp << 1) - dst, ind_tmp)
        prev_ind = prev_ind.clamp(0, 63)
        lg = (F.smulwb(torch.full_like(prev_ind, T.INV_SCALE_Q16), prev_ind)
              + T.OFFSET).clamp_max(3967)
        gains_q16.append(F.log2lin(lg))
    gains_q16 = torch.stack(gains_q16, dim=1)            # [B, nb_subfr]

    # NLSF decode (NLSF_decode.c)
    out = torch.zeros((b,), dtype=torch.int64, device=dev)
    res_q10 = [None] * order
    for i in range(order - 1, -1, -1):
        pred = (out * s["pred_q8"][:, i]) >> 8
        o = s["nlsf_idx"][:, i] << 10
        o = o - torch.where(o > 0, 102, 0) + torch.where(o < 0, 102, 0)
        out = pred + ((o * tabs.qstep) >> 16)   # SMLAWB, product fits
        res_q10[i] = out
    res_q10 = torch.stack(res_q10, dim=1)
    cb1 = s["cb1"]
    nlsf = (F.div32(w32(res_q10 << 14), ctx.t("cb1_wght")[cb1])
            + (ctx.t("cb1_nlsf")[cb1] << 7)).clamp(0, 32767)
    nlsf = _nlsf_stabilize(nlsf, tabs.dmin)

    first = state["first_frame"]
    interp_q2 = torch.where(first, 4, s["interp_q2"])
    do_interp = interp_q2 < 4
    prev_nlsf = state["prev_nlsf"][:, :order]
    nlsf0 = prev_nlsf + ((interp_q2[:, None] * (nlsf - prev_nlsf)) >> 2)
    # one [2B]-batched NLSF2A call covers both coefficient sets
    both, unst = _nlsf2a(tabs, torch.cat([nlsf, nlsf0], dim=0))
    a1, a0_interp = both[:b], both[b:]
    error = error | unst[:b] | (unst[b:] & do_interp)
    a0 = torch.where(do_interp[:, None], a0_interp, a1)
    new_prev_nlsf = torch.cat(
        [nlsf, nlsf.new_zeros((b, MAX_LPC_ORDER - order))], dim=1)

    # pitch lags (decode_pitch.c)
    voiced = signal_type == 2
    min_lag, max_lag = 2 * fs_khz, 18 * fs_khz
    lag_cb = ctx.t("lag_cb")                     # [nb_subfr, ncontour]
    contour = s["contour"].clamp(0, lag_cb.shape[1] - 1)
    pitch = (min_lag + s["lag_index"])[:, None] + lag_cb.t()[contour]
    pitch = torch.where(voiced[:, None], pitch.clamp(min_lag, max_lag), 0)

    # LTP coefficients
    per = s["per_index"].clamp(0, 2)
    vq = ctx.t("ltp_vq")
    b_q14 = torch.stack([vq[per, s["ltp_idx"][k].clamp(0, 31)]
                         for k in range(nb_subfr)], dim=1)
    b_q14 = torch.where(voiced[:, None, None], b_q14, 0)
    ltp_scale_q14 = torch.where(
        voiced, ctx.t("ltp_scales")[s["scale_ix"].clamp(0, 2)], 0)

    # --- excitation (decode_core.c:80-96) ---
    pulses = s["pulses"]
    offset_q10 = ctx.t("quant_offsets")[signal_type >> 1,
                                        s["quant_offset_type"]]
    exc = w32(pulses << 14)
    exc = exc - torch.where(exc > 0, 80 << 4, 0) \
        + torch.where(exc < 0, 80 << 4, 0)
    exc = exc + (offset_q10[:, None] << 4)
    exc = torch.where(_lcg_signs(pulses, s["seed"]), -exc, exc)

    # --- derived per-subframe gain terms ---
    prev_g = torch.cat([state["prev_gain_q16"][:, None],
                        gains_q16[:, :-1]], dim=1)
    g1 = gains_q16.clamp_min(1)
    gain_adj = torch.where(gains_q16 == prev_g, 1 << 16,
                           F.div32_varq(prev_g, g1, 16))
    whiten = F.inverse32_varq(g1, 47)
    whiten = torch.cat([w32(F.smulwb(whiten[:, :1], ltp_scale_q14[:, None])
                            << 2), whiten[:, 1:]], dim=1)

    step_in = dict(exc=exc, a_q12=torch.stack([a0, a1], dim=1), b_q14=b_q14,
                   pitch_l=pitch, gain_q10=gains_q16 >> 6,
                   gain_adj=gain_adj, whiten_gain=whiten, voiced=voiced,
                   rewhiten2=voiced & do_interp)
    carry = dict(prev_nlsf=new_prev_nlsf, last_gain_index=prev_ind,
                 prev_gain_q16=gains_q16[:, -1],
                 frame=dict(signal_type=signal_type, gains_q16=gains_q16,
                            ltp_scale_q14=ltp_scale_q14,
                            lbrr_flag=lbk & active), **flags)
    if multi:
        pt, pl = _next_prev(
            prev if prev is not None else (_zero_lanes(b, dev),
                                           _zero_lanes(b, dev)), s, on)
        carry.update(ec_prev_type=pt, ec_prev_lag=pl)
    error = error | (d["error"] != 0)
    if not osce:
        return step_in, carry, error, d
    osce_in = dict(num_bits=rk_tell(d) - ec_start,
                   pred_coef_q12=step_in["a_q12"], pitch_lags=pitch,
                   ltp_coef_q14=b_q14.reshape(b, -1), gains_q16=gains_q16,
                   signal_type=signal_type, lpc_order=order, fs_khz=fs_khz,
                   nb_subfr=nb_subfr)
    return step_in, carry, error, d, osce_in


def fused_silk_decode(buf, lens, state: dict, *, fs_khz: int = 16,
                      nb_subfr: int = 4, return_rc: bool = False,
                      return_osce: bool = False, lbrr=None, active=None,
                      d0=None, frame: int = 0, nframes: int = 1,
                      header: bool = True, cond=None):
    """One SILK frame per stream, all on the tensors' device, in
    decode_frame's order (silk/decoder.py:706-756): the symbol pass, the
    bandwidth expansion and LTP override of a first frame after a loss,
    decode_core, ``plc_update``, the CNG update, the glue's fade.

    buf: [B, P] uint8 payload bytes; lens: [B] byte lengths.  Returns
    (xq int16-valued [B, L] int64, new state, error [B] bool); with
    return_rc=True appends the final range-decoder dict so a hybrid caller
    can continue decoding the CELT half from the same coder
    (src/opus_decoder.c:432 shares one ec_dec across both); with
    return_osce=True then appends the frame's OSCE inputs
    (``silk_symbols``).  ``lbrr`` ([B] bool): lanes that decode the
    packet's LBRR frame instead (in-band FEC), or conceal the frame where
    the packet carries none (decode_frame.c's lost branch under
    FLAG_DECODE_LBRR); ``active``, ``d0``, ``frame``, ``nframes``,
    ``header``, ``cond``: see ``silk_symbols``."""
    step_in, carry, error, d, *osce_in = silk_symbols(
        buf, lens, state, fs_khz=fs_khz, nb_subfr=nb_subfr,
        osce=return_osce, lbrr=lbrr, active=active, d0=d0, frame=frame,
        nframes=nframes, header=header, cond=cond)
    fr = carry.pop("frame")
    order = 16 if fs_khz >= 16 else 10
    if _any(state["loss_cnt"] > 0):
        voiced, b_q14, pitch = PLC.ltp_after_loss(
            state, step_in["voiced"], step_in["b_q14"], step_in["pitch_l"])
        step_in = dict(step_in, voiced=voiced, b_q14=b_q14, pitch_l=pitch,
                       a_q12=PLC.bwe_after_loss(step_in["a_q12"],
                                                state["loss_cnt"], order))
    xq, synth = silk_decode_step(**step_in, state=state["synth"],
                                 fs_khz=fs_khz, nb_subfr=nb_subfr)
    xq, new_state = _good_frame_state(state, step_in, fr, carry, synth, xq,
                                      fs_khz=fs_khz, nb_subfr=nb_subfr)
    if lbrr is not None:
        conc = lane_mask(lbrr, xq.shape[0], xq.device) & ~fr["lbrr_flag"]
        if _any(conc):
            xq_c, st_c = fused_silk_conceal(state, fs_khz=fs_khz,
                                            nb_subfr=nb_subfr)
            xq = torch.where(conc[:, None], xq_c, xq)
            new_state = select_lanes(conc, dict(
                st_c, decoded_any=new_state["decoded_any"]), new_state)
    return (xq, new_state, error) + ((d,) if return_rc else ()) \
        + tuple(osce_in)


def _good_frame_state(state, step_in, fr, carry, synth, xq, *, fs_khz,
                      nb_subfr):
    """The state after a decoded frame (decode_frame.c's good branch and
    the CNG update and glue that follow it) and its output after the
    glue's fade."""
    sf = 5 * fs_khz
    order = 16 if fs_khz >= 16 else 10
    pitch = step_in["pitch_l"]
    sig = fr["signal_type"]
    # the excitation buffer keeps its width: a wider buffer (a lane whose
    # frame length changes, as the scalar's 320-sample exc_Q14) keeps
    # its samples past this frame's
    exc = step_in["exc"]
    exc = torch.cat([exc, state["exc_q14"][:, exc.shape[1]:]], dim=1)
    new = dict(state, **carry, first_frame=torch.zeros_like(
        state["first_frame"]), synth=synth, exc_q14=exc,
        lag_prev=pitch[:, nb_subfr - 1], loss_cnt=torch.zeros_like(sig),
        prev_signal_type=sig, decoded_any=torch.ones_like(
            state["decoded_any"]))
    new.update(PLC.plc_update(state, sig, pitch, step_in["b_q14"],
                              step_in["a_q12"][:, 1], fr["ltp_scale_q14"],
                              fr["gains_q16"], fs_khz=fs_khz,
                              nb_subfr=nb_subfr))
    inactive = sig == PLC.TYPE_NO_VOICE_ACTIVITY
    if _any(inactive):
        upd = PLC.cng_update(new, step_in["exc"], fr["gains_q16"], sf=sf,
                             order=order)
        new.update(select_lanes(inactive, upd, {k: new[k] for k in upd}))
    new["cng_synth_state"] = torch.zeros_like(state["cng_synth_state"])
    xq, glue = PLC.glue_good(state, xq)
    new.update(glue)
    return xq, new


def fused_silk_conceal(state: dict, *, fs_khz: int = 16,
                       nb_subfr: int = 4):
    """One lost SILK frame on every lane (decode_frame.c's lost branch:
    ``silk_plc.plc_conceal``, the comfort noise, the glue's energy).
    Returns (xq int16-valued [B, L], new state).  The caller selects its
    lanes; the Opus decoder's packet-loss path also sets
    ``last_gain_index`` to 10 (silk/dec_API.c:396, not under in-band
    FEC)."""
    xq, upd = PLC.plc_conceal(state, fs_khz=fs_khz, nb_subfr=nb_subfr)
    new = dict(state, **upd)
    xq, cng = PLC.cng_add(new, xq, silk_tabs(fs_khz, nb_subfr),
                          sf=5 * fs_khz, order=16 if fs_khz >= 16 else 10)
    new.update(cng)
    new.update(PLC.glue_lost(xq))
    return xq, new


def silk_out_48k(xq16, smid, rs, bwe=None, frame_ms: int = 20):
    """The SILK API's output stage at 48 kHz (silk/dec_API.c): xq16 [B, L]
    the frame at 16 kHz (enhanced, if OSCE is on), smid [B, 2] the last
    two samples of the frame before, rs the upsampler's state.  The
    resampler, or ``bwe`` in its place (``BBWE``, silk/dec_API.c:267),
    reads [smid[1], xq16[:-1]]; the resampler does not advance on a BBWE
    frame.  Returns (out [B, 3L] int64 int16-valued, rs, new smid)."""
    seq = torch.cat([smid[:, 1:], xq16[:, :-1]], dim=1)
    if bwe is not None:
        out = bwe.process(seq)
    else:
        out, rs = upsample_to_48k(seq, rs, 16, frame_ms)
    return out, rs, xq16[:, -2:]


class FusedSilkDecoder:
    """Packets-in -> PCM-out mono SILK decoder with everything on the card
    (the default device; kernel K4 for the LPC synthesis), the plain torch
    versions when ``device="cpu"``.

    ``fs_out`` is the output rate: the internal rate (the default), or
    48000 at ``fs_khz=16``, where the frame goes through the SILK API's
    16 -> 48 kHz upsampler, one sample late through its mono 2-sample
    buffer (``silk_out_48k``).

    Loss, lane by lane, as the Opus decoder runs it on a SILK-only
    stream: ``conceal(lanes)`` hides a lost frame (``silk_plc.py``: the
    classic concealment, the comfort noise, the glue);
    ``decode_packed(..., fec=lanes)`` decodes those lanes' LBRR frame in
    place of the packet's regular one (in-band FEC; a lane whose packet
    carries none conceals); ``decode_packed(..., active=lanes)`` leaves
    the other lanes' state alone; ``reset(lanes)``.  ``final_range`` is
    each lane's final range after its last frame, 0 after a concealment
    (src/opus_decoder.c:334).

    ``set_osce(method, model)`` switches LACE or NoLACE enhancement on
    (``OpusDecoder.set_osce``): ``decode_packed`` then returns the
    enhanced PCM of 16 kHz 20 ms frames (other frames pass through and
    reset the enhancer).  The synthesis state never sees the enhancement:
    as in the scalar decoder, it keeps the unenhanced history.
    ``set_osce_bwe(model)`` puts the neural bandwidth extension in the
    upsampler's place at 48 kHz (``OpusDecoder.set_osce_bwe``); it and
    the 2-sample buffer see the enhanced samples.  Neither runs on
    concealed or FEC frames yet: ``conceal``, ``fec`` and ``active``
    raise ValueError while one is on."""

    def __init__(self, batch: int, fs_khz: int = 16, nb_subfr: int = 4,
                 max_payload: int = 512, device="cuda", fs_out=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FusedSilkDecoder: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        fs_out = 1000 * fs_khz if fs_out is None else fs_out
        if fs_out != 1000 * fs_khz and (fs_out, fs_khz) != (48000, 16):
            raise ValueError(f"FusedSilkDecoder: output at {fs_out} Hz from "
                             f"{fs_khz} kHz (the internal rate, or 48000 "
                             f"from 16 kHz)")
        self.batch = batch
        self.fs_khz = fs_khz
        self.nb_subfr = nb_subfr
        self.fs_out = fs_out
        self.P = max_payload
        self.osce_in = None          # the last frame's OSCE inputs
        self.osce = None             # the OSCEEnhancer, if switched on
        self.bwe = None              # the BBWE, if switched on
        self.reset()

    @property
    def final_range(self):
        """[B] each lane's final range after its last frame (0 after a
        concealment)."""
        return self._rng

    def set_osce(self, method: int, model) -> None:
        """Enhance with ``model`` by ``method`` (1 LACE, 2 NoLACE; the
        port's ``dnn.osce`` models on the decoder's device); 0 switches the
        enhancement off (src/opus_decoder.c:443-455)."""
        self.osce = OSCEEnhancer(method, model, self.batch,
                                 device=self.device) if method else None

    def set_osce_bwe(self, model) -> None:
        """Extend the bandwidth with ``model`` (the port's ``dnn.bbwe``
        model on the decoder's device) in place of the upsampler; None
        switches it off.  Needs the 48 kHz output."""
        if model is not None and self.fs_out != 48000:
            raise ValueError("FusedSilkDecoder: BBWE needs fs_out=48000")
        self.bwe = BBWE(model, self.batch, device=self.device) \
            if model is not None else None

    def _plain_only(self, what: str) -> None:
        if self.osce is not None or self.bwe is not None:
            raise ValueError(f"FusedSilkDecoder: {what} with OSCE or BBWE "
                             f"on is not ported")

    def pack(self, payloads):
        """list of B byte strings -> (buf [B, P] uint8, lens [B]) on the
        decoder's device; raises ValueError on a payload longer than P."""
        return pack_payloads(payloads, self.batch, self.P, self.device)

    def _out(self, xq):
        """The frame at fs_out: (pcm, the upsampler state, smid)."""
        if self.fs_out == 48000:
            return silk_out_48k(xq, self.smid, self.rs, self.bwe,
                                5 * self.nb_subfr)
        return xq, self.rs, self.smid

    def _commit(self, m, state, rs, smid, rng):
        """The lanes of m ([B] bool, None: every lane) take the new state,
        upsampler state, smid and final range; the others keep theirs bit
        for bit."""
        if m is None:
            self.state, self.rs, self.smid, self._rng = state, rs, smid, rng
            return
        self.state = select_lanes(m, state, self.state)
        self.rs = select_lanes(m, rs, self.rs)
        self.smid = torch.where(m[:, None], smid, self.smid)
        self._rng = torch.where(m, rng, self._rng)

    def decode_packed(self, buf_u8, lens, osce_inputs: bool = False,
                      active=None, fec=None):
        """buf [B, P] uint8, lens [B] on the device -> (pcm [B, L] int16
        at ``fs_out``, err [B] bool).  The frame's OSCE inputs are taken
        when the enhancer is on or ``osce_inputs`` asks for them, and land
        in ``osce_in`` (else None).  ``fec`` ([B] bool): those lanes decode
        the packet's LBRR frame (or conceal where it carries none) in
        place of its regular frame.  ``active`` ([B] bool, default every
        lane): a lane outside it keeps its state bit for bit, returns zeros
        and raises no error flag."""
        if active is not None or fec is not None:
            self._plain_only("active or fec")
        want = osce_inputs or self.osce is not None
        xq, state, err, d, *osce_in = fused_silk_decode(
            buf_u8, lens, self.state, fs_khz=self.fs_khz,
            nb_subfr=self.nb_subfr, return_rc=True, return_osce=want,
            lbrr=fec, active=active)
        self.osce_in = osce_in[0] if want else None
        if self.osce is not None:
            xq = self.osce.enhance_frame(xq, **self.osce_in)
        pcm, rs, smid = self._out(xq)
        if active is None:
            self._commit(None, state, rs, smid, d["rng"])
            return pcm.to(torch.int16), err
        m = lane_mask(active, self.batch, self.device)
        self._commit(m, state, rs, smid, d["rng"])
        return torch.where(m[:, None], pcm, 0).to(torch.int16), err & m

    def conceal(self, lanes=None):
        """One lost frame on the lanes of ``lanes`` ([B] bool, default every
        lane) -> pcm [B, L] int16 at ``fs_out``.  A lane outside ``lanes``
        keeps its state bit for bit and returns zeros; so does a lane that
        has decoded no packet yet (src/opus_decoder.c:334-341)."""
        self._plain_only("conceal")
        m = lane_mask(lanes, self.batch, self.device) \
            & self.state["decoded_any"]
        n = self.nb_subfr * self.fs_out // 200
        if not _any(m):
            return torch.zeros((self.batch, n), dtype=torch.int16,
                               device=self.device)
        xq, state = fused_silk_conceal(self.state, fs_khz=self.fs_khz,
                                       nb_subfr=self.nb_subfr)
        state["last_gain_index"] = torch.full_like(
            state["last_gain_index"], 10)
        pcm, rs, smid = self._out(xq)
        self._commit(m, state, rs, smid, torch.zeros_like(self._rng))
        return torch.where(m[:, None], pcm, 0).to(torch.int16)

    def reset(self, lanes=None):
        """The lanes of ``lanes`` ([B] bool, default every lane) back to the
        decoder's initial state (and the enhancers', if on)."""
        b, dev = self.batch, self.device
        state = fused_init_state(b, self.fs_khz, dev, self.nb_subfr)
        rs = upsampler_init(b, 16, dev)
        smid = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        rng = torch.zeros((b,), dtype=torch.int64, device=dev)
        self._commit(None if lanes is None else lane_mask(lanes, b, dev),
                     state, rs, smid, rng)
        for enh in (self.osce, self.bwe):
            if enh is not None:
                enh.reset(lanes)

    def decode(self, payloads):
        return self.decode_packed(*self.pack(payloads))
