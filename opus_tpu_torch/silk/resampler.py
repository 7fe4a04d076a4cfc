"""SILK's decoder-side upsampler to 48 kHz on [B] lanes in plain torch.

Port of ``opus_tpu/silk/resampler_jax.py`` (``_c16``, ``UpsamplerState``,
``_fir_plan``, ``upsampler_init``, ``_up2_hq_scan``, ``upsample_to_48k``),
bit-exact with the scalar ``opus_tpu/silk/resampler.py`` ``Resampler``
(reference: silk/resampler_private_IIR_FIR.c and _up2_HQ.c).  The gather
plan of the fractional FIR is computed here from this module's own copy
of the resampler's constants (``_DELAY_DEC``, ``_rate_id`` and the
``inv_ratio_q16`` search of ``Resampler.__init__``).

- up2_HQ is a 6-state allpass recurrence: a Python loop over the frame's
  input samples on [B, 2] int64 lanes (the even and the odd branch side
  by side).  Its values stay below 2**28 for int16 input, so the products
  are exact in int64 and ``(y * c) >> 16`` equals SMULWB with no wrap.
- The fractional FIR reads 8 consecutive 2x samples at offsets that
  advance by a constant step: 8 static gathers and multiply-adds.

Not a TPU kernel, so plain torch is the port; a kernel for it is later
performance work.  State is a dict of int64 tensors: ``s_iir`` [B, 6],
``s_fir`` [B, 8], ``delay`` [B, input_delay].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.device_cache import const
from ..ops.silk_fixed import rshift_round, sat16
from . import tables_data as T
from .tables import (RESAMPLER_DOWN_ORDER_FIR0, RESAMPLER_DOWN_ORDER_FIR1,
                     RESAMPLER_FRAC_FIR_12, RESAMPLER_MAX_BATCH_SIZE_MS,
                     RESAMPLER_ORDER_FIR_12, UP2_HQ_0, UP2_HQ_1)

# decoder input delays by (input rate id, output rate id)
# (silk/resampler.c delay_matrix_dec)
_DELAY_DEC = ((4, 0, 2, 0, 0, 0),
              (0, 9, 4, 7, 4, 4),
              (0, 3, 12, 7, 7, 7))


def _rate_id(r: int) -> int:
    return min(5, ((((r >> 12) - (1 if r > 16000 else 0))
                    >> (1 if r > 24000 else 0)) - 1))


def _c16(v: int) -> int:
    """A coefficient's low 16 bits read as signed (SMULWB takes the bottom
    halfword signed; some Q16 allpass coefficients exceed 32767)."""
    return ((int(v) + 0x8000) & 0xFFFF) - 0x8000


def _inv_ratio_q16(fs_in: int, fs_out: int) -> int:
    """Resampler.__init__'s step for the IIR_FIR path (up2x = 1)."""
    inv = ((fs_in << 15) // fs_out) << 2
    while (inv * fs_out) >> 16 < fs_in << 1:
        inv += 1
    return inv


def input_delay(fs_in_khz: int) -> int:
    return _DELAY_DEC[_rate_id(fs_in_khz * 1000)][_rate_id(48000)]


@lru_cache(maxsize=None)
def _fir_plan(fs_in_khz: int, frame_ms: int):
    """The static FIR gather plan: mirrors Resampler.process()'s batching
    and returns (idx [n_out, 8], coef [n_out, 8]) int64.  Indices address
    Z = concat(s_fir (8), up2(seq)) where seq is the processing order
    (delay head, then the rest)."""
    fs_in = fs_in_khz * 1000
    assert 48000 != 2 * fs_in and 48000 > fs_in, "IIR_FIR ratios only"
    inv = _inv_ratio_q16(fs_in, 48000)
    order = RESAMPLER_ORDER_FIR_12
    batch_cap = fs_in_khz * RESAMPLER_MAX_BATCH_SIZE_MS
    # the two _iir_fir calls: head (1 ms) then the rest, each split into
    # batches of <= batch_cap input samples
    calls = [fs_in_khz, fs_in_khz * frame_ms - fs_in_khz]
    idx_rows, coef_rows = [], []
    zpos = order          # up2 output write position within Z
    for n_call in calls:
        pos = 0
        while pos < n_call:
            n_in = min(n_call - pos, batch_cap)
            buf_base = zpos - order
            index_q16 = 0
            while index_q16 < (n_in << 17):
                ti = ((index_q16 & 0xFFFF) * 12) >> 16
                b = index_q16 >> 16
                taps = (list(RESAMPLER_FRAC_FIR_12[ti])
                        + list(RESAMPLER_FRAC_FIR_12[11 - ti])[::-1])
                idx_rows.append([buf_base + b + j for j in range(8)])
                coef_rows.append(taps)
                index_q16 += inv
            zpos += 2 * n_in
            pos += n_in
    return (np.asarray(idx_rows, np.int64), np.asarray(coef_rows, np.int64))


def upsampler_init(batch: int, fs_in_khz: int = 16, device="cpu") -> dict:
    z = torch.zeros((batch, 6), dtype=torch.int64, device=device)
    return dict(s_iir=z,
                s_fir=torch.zeros((batch, RESAMPLER_ORDER_FIR_12),
                                  dtype=torch.int64, device=device),
                delay=torch.zeros((batch, input_delay(fs_in_khz)),
                                  dtype=torch.int64, device=device))


def _up2_hq_scan(x, s_iir):
    """x: [B, N] int16-valued int64; returns ([B, 2N] int64, new s_iir
    [B, 6]).  Reference: silk_resampler_private_up2_HQ.  Column 0 of each
    [B, 2] state is the even-sample branch (UP2_HQ_0), column 1 the odd
    one (UP2_HQ_1)."""
    dev = x.device
    c = [const(("up2_hq", k), lambda k=k: np.asarray(
        [_c16(UP2_HQ_0[k]), _c16(UP2_HQ_1[k])], np.int64), dev)
        for k in range(3)]
    s0, s1, s2 = s_iir[:, 0::3], s_iir[:, 1::3], s_iir[:, 2::3]
    in32 = (x << 10)[:, :, None]
    outs = []
    for t in range(x.shape[1]):
        xt = in32[:, t]
        xx = ((xt - s0) * c[0]) >> 16
        o1 = s0 + xx
        s0 = xt + xx
        xx = ((o1 - s1) * c[1]) >> 16
        o2 = s1 + xx
        s1 = o1 + xx
        y = o2 - s2
        xx = y + ((y * c[2]) >> 16)
        outs.append(s2 + xx)
        s2 = o2 + xx
    y = sat16(rshift_round(torch.stack(outs, dim=1), 10))   # [B, N, 2]
    s_fin = torch.stack([s0, s1, s2], dim=2).reshape(x.shape[0], 6)
    # [B, 2, 3] -> the JAX order (s0, s1, s2 of the even branch, then the
    # odd branch's)
    return y.reshape(x.shape[0], -1), s_fin


def upsample_to_48k(x, st: dict, fs_in_khz: int = 16, frame_ms: int = 20):
    """x: [B, fs_in_khz * frame_ms] int16-valued -> ([B, 48 * frame_ms]
    int64 int16-valued, new state).  Bit-exact with
    Resampler(fs_in * 1000, 48000).process()."""
    x = x.to(torch.int64)
    dev = x.device
    idx_np, coef_np = _fir_plan(fs_in_khz, frame_ms)
    n_in = fs_in_khz * frame_ms
    delay = st["delay"].shape[1]
    # processing order: [delay tail | x[:n_in - delay]]
    seq = torch.cat([st["delay"], x[:, :n_in - delay]], dim=1)
    y, s_iir = _up2_hq_scan(seq, st["s_iir"])
    z = torch.cat([st["s_fir"], y], dim=1)          # [B, 8 + 2 * n_in]
    idx = const(("rs_idx", fs_in_khz, frame_ms), lambda: idx_np.T.copy(),
                dev)
    coef = const(("rs_coef", fs_in_khz, frame_ms), lambda: coef_np.T.copy(),
                 dev)
    acc = z[:, idx[0]] * coef[0]
    for j in range(1, 8):
        acc = acc + z[:, idx[j]] * coef[j]
    out = sat16(rshift_round(acc, 15))
    new_st = dict(s_iir=s_iir, s_fir=z[:, -RESAMPLER_ORDER_FIR_12:],
                  delay=x[:, n_in - delay:])
    return out, new_st


# ---------------------------------------------------------------------
# the decoder-direction Resampler(16000, fs) for fs = 8, 12 and 24 kHz
# (the rates of dred_decode's output besides 16 and 48 kHz)

_FS_IN_KHZ = 16
_DOWN = {8000: (RESAMPLER_DOWN_ORDER_FIR1, 1, T.RESAMPLER_1_2_COEFS),
         12000: (RESAMPLER_DOWN_ORDER_FIR0, 3, T.RESAMPLER_3_4_COEFS)}
DEC_RATES = (8000, 12000, 24000)


def _inv_ratio(fs_in: int, fs_out: int, up2x: int) -> int:
    """Resampler.__init__'s step in Q16 (silk_resampler_init)."""
    inv = ((fs_in << (14 + up2x)) // fs_out) << 2
    while (inv * fs_out) >> 16 < fs_in << up2x:
        inv += 1
    return inv


def _calls(n_in: int) -> list:
    """Resampler.process's two calls (the 1 ms head, then the rest), each
    split into batches of at most 10 ms: input lengths in order."""
    cap = _FS_IN_KHZ * RESAMPLER_MAX_BATCH_SIZE_MS
    out = []
    for n_call in (_FS_IN_KHZ, n_in - _FS_IN_KHZ):
        pos = 0
        while pos < n_call:
            out.append(min(n_call - pos, cap))
            pos += out[-1]
    return out


@lru_cache(maxsize=None)
def _dec_plan(fs_out: int, n_in: int):
    """The static tap plan of Resampler(16000, fs_out).process() on n_in
    samples, as (a, b, coef) int64 [n_out, taps]: output j is
    sum_t ((z[a] + z[b]) * coef) >> 16, each term shifted on its own as
    SMULWB / SMLAWB do, over z = [s_fir | filtered input | 0] (the FIR
    history, the AR2 (DOWN_FIR) or up2_HQ (IIR_FIR) output of the
    processing order, and a zero at the end for one-sided taps).  The
    IIR_FIR taps (16 bits by 16 bits, SMULBB) are put as coef << 16."""
    rows_a, rows_b, rows_c = [], [], []
    if fs_out in _DOWN:
        order, fracs, coefs = _DOWN[fs_out]
        fir = coefs[2:]
        inv = _inv_ratio(_FS_IN_KHZ * 1000, fs_out, 0)
        zlen = order + n_in
        base = 0
        for n in _calls(n_in):
            index_q16 = 0
            while index_q16 < n << 16:
                b = base + (index_q16 >> 16)
                if order == RESAMPLER_DOWN_ORDER_FIR0:
                    ind = ((index_q16 & 0xFFFF) * fracs) >> 16
                    p1, p2 = 9 * ind, 9 * (fracs - 1 - ind)
                    a = [b + j for j in range(9)] + [b + 17 - j
                                                     for j in range(9)]
                    c = [fir[p1 + j] for j in range(9)] + [fir[p2 + j]
                                                           for j in range(9)]
                    bb = [zlen] * 18
                else:
                    a = [b + j for j in range(12)]
                    bb = [b + order - 1 - j for j in range(12)]
                    c = [fir[j] for j in range(12)]
                rows_a.append(a)
                rows_b.append(bb)
                rows_c.append(c)
                index_q16 += inv
            base += n
    else:
        inv = _inv_ratio(_FS_IN_KHZ * 1000, fs_out, 1)
        order = RESAMPLER_ORDER_FIR_12
        zlen = order + 2 * n_in
        base = 0
        for n in _calls(n_in):
            index_q16 = 0
            while index_q16 < n << 17:
                ti = ((index_q16 & 0xFFFF) * 12) >> 16
                b = base + (index_q16 >> 16)
                rows_a.append([b + j for j in range(8)])
                rows_b.append([zlen] * 8)
                rows_c.append([v << 16 for v in
                               list(RESAMPLER_FRAC_FIR_12[ti])
                               + list(RESAMPLER_FRAC_FIR_12[11 - ti])[::-1]])
                index_q16 += inv
            base += 2 * n
    return tuple(np.asarray(r, np.int64) for r in (rows_a, rows_b, rows_c))


def dec_resampler_init(batch: int, fs_out: int, device="cpu") -> dict:
    """The zero state of Resampler(16000, fs_out) on ``batch`` lanes:
    ``s_iir`` [B, 2] (AR2) or [B, 6] (up2_HQ), ``s_fir`` [B, order] and
    ``delay`` [B, input_delay], int64."""
    if fs_out not in DEC_RATES:
        raise ValueError(f"dec_resampler_init: fs {fs_out} (8000, 12000 "
                         f"or 24000)")
    order = _DOWN[fs_out][0] if fs_out in _DOWN else RESAMPLER_ORDER_FIR_12
    delay = _DELAY_DEC[_rate_id(_FS_IN_KHZ * 1000)][_rate_id(fs_out)]

    def z(n):
        return torch.zeros((batch, n), dtype=torch.int64, device=device)
    return dict(s_iir=z(2 if fs_out in _DOWN else 6), s_fir=z(order),
                delay=z(delay))


def _ar2(x, s_iir, coefs):
    """silk_resampler_private_AR2 on [B] lanes, one step a sample: x [B, N]
    int16 values -> ([B, N] Q8 output, new state [B, 2])."""
    a0, a1 = _c16(coefs[0]), _c16(coefs[1])
    s0, s1 = s_iir[:, 0], s_iir[:, 1]
    outs = []
    for t in range(x.shape[1]):
        o = s0 + (x[:, t] << 8)
        outs.append(o)
        o = o << 2
        s0 = s1 + ((o * a0) >> 16)
        s1 = (o * a1) >> 16
    return torch.stack(outs, dim=1), torch.stack([s0, s1], dim=1)


def resample_16k(x, st: dict, fs_out: int):
    """x: [B, n_in] int16 values at 16 kHz (n_in a whole number of ms, at
    least 2) -> ([B, n_in * fs_out / 16000] int64 int16 values, new state).
    Bit-exact with Resampler(16000, fs_out).process() on each lane, the
    state carried from call to call: DOWN_FIR 1/2 (8 kHz), DOWN_FIR 3/4
    (12 kHz) and IIR_FIR (24 kHz)."""
    x = x.to(torch.int64)
    dev = x.device
    n_in = x.shape[1]
    delay = st["delay"].shape[1]
    seq = torch.cat([st["delay"], x[:, :n_in - delay]], dim=1)
    if fs_out in _DOWN:
        y, s_iir = _ar2(seq, st["s_iir"], _DOWN[fs_out][2])
        shift = 6
    else:
        y, s_iir = _up2_hq_scan(seq, st["s_iir"])
        shift = 15
    order = st["s_fir"].shape[1]
    z = torch.cat([st["s_fir"], y, torch.zeros_like(y[:, :1])], dim=1)
    a, b, c = (const(("rs16", fs_out, n_in, k), lambda k=k: np.ascontiguousarray(
        _dec_plan(fs_out, n_in)[k].T), dev) for k in range(3))
    acc = ((z[:, a[0]] + z[:, b[0]]) * c[0]) >> 16
    for t in range(1, a.shape[0]):
        acc = acc + (((z[:, a[t]] + z[:, b[t]]) * c[t]) >> 16)
    out = sat16(rshift_round(acc, shift))
    new_st = dict(s_iir=s_iir, s_fir=z[:, -1 - order:-1],
                  delay=x[:, n_in - delay:])
    return out, new_st
