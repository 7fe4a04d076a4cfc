"""Batched SILK decode_core: symbols in, int16 PCM out, int32 wrap-exact.

Port of ``opus_tpu/models/batched_silk.py`` (``init_state``,
``_analysis_fir``, ``_ltp_subframe``, ``silk_decode_step``): LTP-buffer
rewhitening (batched order-16 analysis FIR), the 5-tap LTP prediction
recursion (chunked over the pitch-lag feedback distance) and the
order-16 LPC synthesis, which runs as kernel K4 on the card
(``opus_tpu_torch/ops/lpc.py``).  Values are int64 tensors holding int32
values (``opus_tpu_torch/ops/silk_fixed.py``).  The JAX module's
``BatchedSilkDecoder``, fed by the native C symbol pass, is not ported.

Reference pipeline: silk_decode_core silk/decode_core.c:38, whitening
:135-160, LTP :178, LPC synthesis :195-216.
"""

from __future__ import annotations

import torch

from ..ops.lpc import lpc_subframe
from ..ops.silk_fixed import (rshift_round, sat16, smulwb, smulww, w32)

LTP_ORDER = 5
MAX_LPC_ORDER = 16
CHUNK = 10          # LTP chunk; safe while pitch lag - 2 >= CHUNK (min
                    # lag is 2 ms = 16 samples at 8 kHz, so distance >= 14)


def init_state(batch: int, fs_khz: int = 16, device="cpu") -> dict:
    """The ``SilkState`` fields: slpc [B, 16] (the sLPC_Q14 tail) and
    out_buf [B, ltp_mem] (int16-valued xq history)."""
    return dict(
        slpc=torch.zeros((batch, MAX_LPC_ORDER), dtype=torch.int64,
                         device=device),
        out_buf=torch.zeros((batch, 20 * fs_khz), dtype=torch.int64,
                            device=device))


def _analysis_fir(inp, a, order: int):
    """Batched silk_LPC_analysis_filter (silk/LPC_analysis_filter.c).

    inp: [B, M] (int16 values), a: [B, 16] (int16 values).  Returns
    [B, M]; entries ix < order are zeroed like the reference.  The sums
    wrap in int32 (SMLABB_ovflw chain)."""
    b, m = inp.shape
    pad = torch.cat([inp.new_zeros((b, MAX_LPC_ORDER)), inp], dim=1)
    # acc[b, ix] = sum_j inp[b, ix - 1 - j] * a[b, j], one [B, M] slice
    # per tap (no [B, M, 16] intermediate)
    acc = 0
    for j in range(MAX_LPC_ORDER):
        o = MAX_LPC_ORDER - 1 - j
        acc = acc + pad[:, o:o + m] * a[:, j:j + 1]
    out32 = w32((inp << 12) - acc)
    out = sat16(rshift_round(out32, 12))
    out[:, :order] = 0
    return out


def _ltp_subframe(sltp, exc_sub, b5, lag, buf_idx: int, sf: int):
    """5-tap LTP prediction recursion over one subframe (decode_core.c:178).

    sltp: [B, T]; exc_sub: [B, sf]; b5: [B, 5]; lag: [B].  Returns
    (res [B, sf], sltp): sltp is updated in place.  Processed in
    CHUNK-sample blocks: the recursion's feedback distance is
    lag - LTP_ORDER//2 - 2 >= 14 samples, so samples within a chunk are
    independent."""
    t = sltp.shape[1]
    ar = torch.arange(CHUNK + 4, device=sltp.device)
    res_chunks = []
    for c in range(sf // CHUNK):
        # the window start, clamped into the buffer as dynamic_slice does
        p0 = (buf_idx + c * CHUNK - lag - 2).clamp(0, t - CHUNK - 4)
        seg = sltp.gather(1, p0[:, None] + ar[None, :])     # [B, CHUNK+4]
        pred = 2
        for j in range(LTP_ORDER):
            pred = pred + smulwb(seg[:, 4 - j:4 - j + CHUNK], b5[:, j:j + 1])
        res = w32(exc_sub[:, c * CHUNK:(c + 1) * CHUNK] + (pred << 1))
        sltp[:, buf_idx + c * CHUNK:buf_idx + (c + 1) * CHUNK] = w32(res << 1)
        res_chunks.append(res)
    return torch.cat(res_chunks, dim=1), sltp


def silk_decode_step(exc, a_q12, b_q14, pitch_l, gain_q10, gain_adj,
                     whiten_gain, voiced, rewhiten2, state: dict, *,
                     fs_khz: int = 16, nb_subfr: int = 4):
    """One SILK frame of batched decode_core, int32 wrap-exact.

    exc:         [B, L] exc_Q14
    a_q12:       [B, 2, 16] (int16 values)
    b_q14:       [B, nb_subfr, 5] (int16 values)
    pitch_l:     [B, nb_subfr]
    gain_q10 / gain_adj / whiten_gain: [B, nb_subfr]
    voiced:      [B] bool, or [B, nb_subfr] per subframe (the frame after
                 a loss runs unvoiced subframes as voiced,
                 ``silk_plc.ltp_after_loss``); rewhiten2: [B] bool
                 (voiced & NLSF interp)
    state:       the ``init_state`` dict
    returns (xq [B, L] (int16 values), new state)"""
    sf = 5 * fs_khz
    ltp_mem = 20 * fs_khz
    order = MAX_LPC_ORDER if fs_khz >= 16 else 10
    order_half = order >> 1
    b, l = exc.shape
    dev = exc.device
    sltp = torch.zeros((b, ltp_mem + l), dtype=torch.int64, device=dev)
    t_idx = torch.arange(ltp_mem + l, device=dev)[None, :]
    out_buf = state["out_buf"]
    slpc = state["slpc"]
    xq_subs = []

    for k in range(nb_subfr):
        vcol = (voiced if voiced.dim() == 1 else voiced[:, k])[:, None]
        lag = pitch_l[:, k]
        adj = gain_adj[:, k:k + 1]
        # --- gain-change rescale of the LPC state (decode_core.c:115) ---
        slpc = smulww(adj, slpc)

        # --- LTP buffer maintenance ---
        buf_idx = ltp_mem + k * sf
        lo = (buf_idx - lag - 2)[:, None]
        if k == 0:
            # rewhiten from the previous frame's output (voiced streams)
            whit0 = _analysis_fir(out_buf, a_q12[:, 0, :], order)
            fill = smulwb(whiten_gain[:, 0:1],
                          torch.cat([whit0, whit0.new_zeros((b, l))], 1))
            sltp = torch.where((t_idx >= lo) & (t_idx < ltp_mem) & vcol,
                               fill, sltp)
        else:
            rewhiten = k == 2 and nb_subfr == 4
            here = rewhiten2[:, None] if rewhiten else torch.zeros_like(vcol)
            # non-rewhitened voiced subframes: rescale the tap window
            win = (t_idx >= lo) & (t_idx < buf_idx)
            sltp = torch.where(win & vcol & ~here, smulww(adj, sltp), sltp)
            if rewhiten:
                # NLSF-interpolated frames rewhiten again at subframe 2
                # over [prev frame output, current xq[:2*sf]]
                whit2 = _analysis_fir(torch.cat([out_buf] + xq_subs, 1),
                                      a_q12[:, 1, :], order)
                fill2 = smulwb(whiten_gain[:, 2:3], torch.cat(
                    [whit2, whit2.new_zeros((b, l - 2 * sf))], 1))
                sltp = torch.where(win & here, fill2, sltp)

        # --- LTP prediction -> residual ---
        exc_sub = exc[:, k * sf:(k + 1) * sf]
        lag_safe = lag.clamp_min(2 * fs_khz)   # unvoiced lag = 0: clamp
        res_ltp, sltp = _ltp_subframe(sltp, exc_sub, b_q14[:, k, :],
                                      lag_safe, buf_idx, sf)
        res = torch.where(vcol, res_ltp, exc_sub)

        # --- LPC synthesis (kernel K4 on the card) ---
        v, slpc = lpc_subframe(slpc, res, a_q12[:, k >> 1, :].flip(1),
                               order_half)
        v, slpc = v.to(torch.int64), slpc.to(torch.int64)
        xq_subs.append(sat16(rshift_round(
            smulww(v, gain_q10[:, k:k + 1]), 8)))

    xq = torch.cat(xq_subs, dim=1)
    out_buf = torch.cat([out_buf, xq], dim=1)[:, -ltp_mem:]
    return xq, dict(slpc=slpc, out_buf=out_buf)
