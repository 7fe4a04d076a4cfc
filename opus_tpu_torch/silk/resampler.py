"""SILK's decoder-direction resampler on [B] lanes in plain torch, for
every pair of internal rate (8, 12, 16 kHz) and API rate (8, 12, 16, 24,
48 kHz).

Port of ``opus_tpu/silk/resampler_jax.py`` (``_c16``, ``_fir_plan``,
``upsampler_init``, ``_up2_hq_scan``, ``upsample_to_48k``), generalised
to the scalar ``opus_tpu/silk/resampler.py`` ``Resampler``'s four paths
and bit-exact with it (reference: silk/resampler.c and
resampler_private_{up2_HQ,IIR_FIR,down_FIR,AR2}.c), the path chosen as
``Resampler.__init__`` chooses it:

- COPY (equal rates): the input through the decoder's input delay;
- UP2_HQ (8 -> 16, 12 -> 24 kHz): a 6-state allpass recurrence, a Python
  loop over the input samples on [B, 2] int64 lanes (the even and the odd
  branch side by side).  Its values stay below 2**28 for int16 input, so
  the products are exact in int64 and ``(y * c) >> 16`` equals SMULWB;
- IIR_FIR (8 -> 12, 8 -> 24, 12 -> 16, 16 -> 24, any rate -> 48 kHz):
  UP2_HQ, then a fractional FIR that reads 8 consecutive 2x samples at
  offsets that advance by a constant step: 8 static gathers and
  multiply-adds;
- DOWN_FIR (12 -> 8, 16 -> 8, 16 -> 12): the AR2 prefilter, a loop over
  the input samples, then a symmetric FIR at static offsets, each term
  shifted on its own as SMULWB / SMLAWB do.

The gather plans follow ``Resampler.process``'s two calls (the 1 ms head,
then the rest) and its 10 ms batches, and are computed here from this
module's own copy of the resampler's constants (``_DELAY_DEC``,
``_rate_id`` and the ``inv_ratio_q16`` search).  Not a TPU kernel, so
plain torch is the port.  State is a dict of int64 tensors: ``s_iir``
[B, 6] (UP2_HQ, IIR_FIR), [B, 2] (DOWN_FIR) or [B, 0] (COPY), ``s_fir``
[B, FIR order] and ``delay`` [B, input delay]; ``resample_lanes`` keeps
it at the widest of every pair (``WIDE``), for lanes whose rates change.
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

COPY, UP2_HQ, IIR_FIR, DOWN_FIR = range(4)
IN_RATES = (8, 12, 16)                  # kHz: SILK's internal rates
API_RATES = (8, 12, 16, 24, 48)         # kHz: the decoder's output rates
# the DOWN_FIR ratios of the decoder's pairs (Resampler.__init__):
# (FIR order, fractions, coefficients)
_DOWN = {(12, 8): (RESAMPLER_DOWN_ORDER_FIR0, 2, T.RESAMPLER_2_3_COEFS),
         (16, 8): (RESAMPLER_DOWN_ORDER_FIR1, 1, T.RESAMPLER_1_2_COEFS),
         (16, 12): (RESAMPLER_DOWN_ORDER_FIR0, 3, T.RESAMPLER_3_4_COEFS)}


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


def path(fs_in_khz: int, fs_out_khz: int) -> int:
    """Resampler.__init__'s choice for the pair: COPY, UP2_HQ, IIR_FIR or
    DOWN_FIR."""
    if fs_out_khz == fs_in_khz:
        return COPY
    if fs_out_khz == 2 * fs_in_khz:
        return UP2_HQ
    if fs_out_khz > fs_in_khz:
        return IIR_FIR
    if (fs_in_khz, fs_out_khz) not in _DOWN:
        raise ValueError(f"resampler: no decoder path from {fs_in_khz} to "
                         f"{fs_out_khz} kHz")
    return DOWN_FIR


def delay(fs_in_khz: int, fs_out_khz: int) -> int:
    """The decoder's input delay of the pair (delay_matrix_dec)."""
    return _DELAY_DEC[_rate_id(fs_in_khz * 1000)][_rate_id(fs_out_khz
                                                           * 1000)]


def input_delay(fs_in_khz: int) -> int:
    return delay(fs_in_khz, 48)


def widths(fs_in_khz: int, fs_out_khz: int) -> dict:
    """The pair's state widths: s_iir, s_fir and delay."""
    kind = path(fs_in_khz, fs_out_khz)
    order = (_DOWN[(fs_in_khz, fs_out_khz)][0] if kind == DOWN_FIR
             else RESAMPLER_ORDER_FIR_12 if kind == IIR_FIR else 0)
    return dict(s_iir=(0, 6, 6, 2)[kind], s_fir=order,
                delay=delay(fs_in_khz, fs_out_khz))


# the widest state over every decoder pair (resample_lanes' store)
WIDE = {k: max(widths(i, o)[k] for i in IN_RATES for o in API_RATES
               if (i, o) in _DOWN or o >= i)
        for k in ("s_iir", "s_fir", "delay")}


def resampler_init(batch: int, fs_in_khz: int, fs_out_khz: int,
                   device="cpu") -> dict:
    """The zero state of Resampler(fs_in, fs_out) on ``batch`` lanes."""
    return {k: torch.zeros((batch, w), dtype=torch.int64, device=device)
            for k, w in widths(fs_in_khz, fs_out_khz).items()}


def wide_init(batch: int, device="cpu") -> dict:
    """The zero state at ``WIDE`` (any pair's state as ``resample_lanes``
    stores it)."""
    return {k: torch.zeros((batch, w), dtype=torch.int64, device=device)
            for k, w in WIDE.items()}


def upsampler_init(batch: int, fs_in_khz: int = 16, device="cpu") -> dict:
    return resampler_init(batch, fs_in_khz, 48, device)


def _calls(fs_in_khz: int, n_in: int) -> list:
    """Resampler.process's two calls (the 1 ms head, then the rest), each
    split into batches of at most 10 ms: input lengths in order."""
    cap = fs_in_khz * RESAMPLER_MAX_BATCH_SIZE_MS
    out = []
    for n_call in (fs_in_khz, n_in - fs_in_khz):
        pos = 0
        while pos < n_call:
            out.append(min(n_call - pos, cap))
            pos += out[-1]
    return out


def _inv_ratio(fs_in: int, fs_out: int, up2x: int) -> int:
    """Resampler.__init__'s step in Q16 (silk_resampler_init)."""
    inv = ((fs_in << (14 + up2x)) // fs_out) << 2
    while (inv * fs_out) >> 16 < fs_in << up2x:
        inv += 1
    return inv


def _inv_ratio_q16(fs_in: int, fs_out: int) -> int:
    """Resampler.__init__'s step for the IIR_FIR path (up2x = 1)."""
    return _inv_ratio(fs_in, fs_out, 1)


@lru_cache(maxsize=None)
def _fir_plan(fs_in_khz: int, frame_ms: int, fs_out_khz: int = 48):
    """The static IIR_FIR gather plan: mirrors Resampler.process()'s
    batching and returns (idx [n_out, 8], coef [n_out, 8]) int64.  Indices
    address Z = concat(s_fir (8), up2(seq)) where seq is the processing
    order (delay head, then the rest)."""
    assert path(fs_in_khz, fs_out_khz) == IIR_FIR, "IIR_FIR ratios only"
    inv = _inv_ratio_q16(fs_in_khz * 1000, fs_out_khz * 1000)
    idx_rows, coef_rows = [], []
    base = 0              # the batch's first up2 sample within Z, less 8
    for n_in in _calls(fs_in_khz, fs_in_khz * frame_ms):
        index_q16 = 0
        while index_q16 < (n_in << 17):
            ti = ((index_q16 & 0xFFFF) * 12) >> 16
            b = index_q16 >> 16
            taps = (list(RESAMPLER_FRAC_FIR_12[ti])
                    + list(RESAMPLER_FRAC_FIR_12[11 - ti])[::-1])
            idx_rows.append([base + b + j for j in range(8)])
            coef_rows.append(taps)
            index_q16 += inv
        base += 2 * n_in
    return (np.asarray(idx_rows, np.int64), np.asarray(coef_rows, np.int64))


@lru_cache(maxsize=None)
def _down_plan(fs_in_khz: int, fs_out_khz: int, n_in: int):
    """The static DOWN_FIR tap plan of Resampler(fs_in, fs_out).process() on
    n_in samples, as (a, b, coef) int64 [taps, n_out]: output j is
    sum_t ((z[a] + z[b]) * coef) >> 16, each term shifted on its own as
    SMULWB / SMLAWB do, over z = [s_fir | AR2 output of the processing
    order | 0] (a zero at the end for the one-sided taps of the
    fractional filters)."""
    order, fracs, coefs = _DOWN[(fs_in_khz, fs_out_khz)]
    fir = coefs[2:]
    inv = _inv_ratio(fs_in_khz * 1000, fs_out_khz * 1000, 0)
    zlen = order + n_in
    rows_a, rows_b, rows_c = [], [], []
    base = 0
    for n in _calls(fs_in_khz, n_in):
        index_q16 = 0
        while index_q16 < n << 16:
            b = base + (index_q16 >> 16)
            if order == RESAMPLER_DOWN_ORDER_FIR0:
                ind = ((index_q16 & 0xFFFF) * fracs) >> 16
                p1, p2 = 9 * ind, 9 * (fracs - 1 - ind)
                rows_a.append([b + j for j in range(9)]
                              + [b + 17 - j for j in range(9)])
                rows_c.append([fir[p1 + j] for j in range(9)]
                              + [fir[p2 + j] for j in range(9)])
                rows_b.append([zlen] * 18)
            else:
                rows_a.append([b + j for j in range(12)])
                rows_b.append([b + order - 1 - j for j in range(12)])
                rows_c.append([fir[j] for j in range(12)])
            index_q16 += inv
        base += n
    return tuple(np.ascontiguousarray(np.asarray(r, np.int64).T)
                 for r in (rows_a, rows_b, rows_c))


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


def resample(x, st: dict, fs_in_khz: int, fs_out_khz: int):
    """x: [B, n_in] int16 values at fs_in (n_in a whole number of ms, at
    least 2) -> ([B, n_in * fs_out / fs_in] int64 int16 values, new
    state).  Bit-exact with Resampler(fs_in, fs_out).process() on each
    lane, the state (``resampler_init``'s widths) carried from call to
    call."""
    x = x.to(torch.int64)
    dev = x.device
    n_in = x.shape[1]
    d = st["delay"].shape[1]
    kind = path(fs_in_khz, fs_out_khz)
    # processing order: [delay tail | x[:n_in - delay]]
    seq = torch.cat([st["delay"], x[:, :n_in - d]], dim=1)
    new = dict(st, delay=x[:, n_in - d:])
    if kind == COPY:
        return seq, new
    if kind == UP2_HQ:
        out, new["s_iir"] = _up2_hq_scan(seq, st["s_iir"])
        return out, new
    key = (fs_in_khz, fs_out_khz, n_in)
    if kind == IIR_FIR:
        y, new["s_iir"] = _up2_hq_scan(seq, st["s_iir"])
        z = torch.cat([st["s_fir"], y], dim=1)      # [B, 8 + 2 * n_in]
        plan = _fir_plan(fs_in_khz, n_in // fs_in_khz, fs_out_khz)
        idx, coef = (const(("rs_fir", key, k), lambda k=k: np.ascontiguousarray(
            plan[k].T), dev) for k in range(2))
        acc = z[:, idx[0]] * coef[0]
        for j in range(1, 8):
            acc = acc + z[:, idx[j]] * coef[j]
        new["s_fir"] = z[:, -RESAMPLER_ORDER_FIR_12:]
        return sat16(rshift_round(acc, 15)), new
    order = st["s_fir"].shape[1]
    y, new["s_iir"] = _ar2(seq, st["s_iir"],
                           _DOWN[(fs_in_khz, fs_out_khz)][2])
    z = torch.cat([st["s_fir"], y, torch.zeros_like(y[:, :1])], dim=1)
    a, b, c = (const(("rs_down", key, k), lambda k=k: _down_plan(*key)[k],
                     dev) for k in range(3))
    acc = ((z[:, a[0]] + z[:, b[0]]) * c[0]) >> 16
    for t in range(1, a.shape[0]):
        acc = acc + (((z[:, a[t]] + z[:, b[t]]) * c[t]) >> 16)
    new["s_fir"] = z[:, -1 - order:-1]
    return sat16(rshift_round(acc, 6)), new


def resample_lanes(x, wide: dict, fs_in_khz: int, fs_out_khz: int):
    """``resample`` on a state stored at ``WIDE``: the pair's state is the
    first columns of each field, the rest is kept as it is."""
    w = widths(fs_in_khz, fs_out_khz)
    out, new = resample(x, {k: v[:, :w[k]] for k, v in wide.items()},
                        fs_in_khz, fs_out_khz)
    return out, {k: torch.cat([new[k], v[:, w[k]:]], dim=1)
                 for k, v in wide.items()}


def upsample_to_48k(x, st: dict, fs_in_khz: int = 16, frame_ms: int = 20):
    """x: [B, fs_in_khz * frame_ms] int16-valued -> ([B, 48 * frame_ms]
    int64 int16-valued, new state): ``resample`` to 48 kHz."""
    return resample(x, st, fs_in_khz, 48)


# the decoder-direction Resampler(16000, fs) at the rates of dred_decode's
# output besides 16 and 48 kHz
DEC_RATES = (8000, 12000, 24000)


def dec_resampler_init(batch: int, fs_out: int, device="cpu") -> dict:
    """The zero state of Resampler(16000, fs_out) on ``batch`` lanes."""
    if fs_out not in DEC_RATES:
        raise ValueError(f"dec_resampler_init: fs {fs_out} (8000, 12000 "
                         f"or 24000)")
    return resampler_init(batch, 16, fs_out // 1000, device)


def resample_16k(x, st: dict, fs_out: int):
    """``resample`` from 16 kHz to fs_out (Hz)."""
    return resample(x, st, 16, fs_out // 1000)
