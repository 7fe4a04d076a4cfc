"""SILK stereo on [B] lanes: the mid/side prediction weights and the
mid/side -> left/right conversion, integer-exact.

Port of ``opus_tpu/silk/stereo.py`` (``stereo_decode_pred``,
``stereo_decode_mid_only``, ``StereoDecState.ms_to_lr``) with its state
as [B]-lane tensors: ``pred_prev_q13`` [B, 2], ``s_mid`` and ``s_side``
[B, 2].  The range-decoded symbols come from
``fused_silk_dec.stereo_pred_symbols``; ``pred_q13`` turns them into the
two predictors.  Every product is the scalar's Python-int product
(SMULWB, SMLAWB, SMLABB on int16-wrapped operands), so the results are
bit for bit the scalar's.

Reference: silk/stereo_decode_pred.c, silk/stereo_MS_to_LR.c.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device_cache import const
from . import tables_data as TD
from .tables import STEREO_INTERP_LEN_MS, STEREO_QUANT_SUB_STEPS


def _w16(x):
    """The low 16 bits as a signed value (the macros' int16 operands)."""
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def _smulwb(a, b):
    return (a * _w16(b)) >> 16


def _smlawb(a, b, c):
    return a + ((b * _w16(c)) >> 16)


def _sat16(x):
    return x.clamp(-32768, 32767)


def _rshift_round(a, shift: int):
    return ((a >> (shift - 1)) + 1) >> 1


# SILK_FIX_CONST(0.5 / STEREO_QUANT_SUB_STEPS, 16)
_HALF_STEP_Q16 = int(0.5 / STEREO_QUANT_SUB_STEPS * (1 << 16) + 0.5)


def pred_q13(symbols):
    """The two predictors [B, 2] from ``stereo_pred_symbols``' (joint
    index, [(3-level, 5-level)] per channel) (stereo.py:12)."""
    n, ix = symbols
    quant = const(("silk_stereo_q13",), lambda: np.asarray(
        TD.STEREO_PRED_QUANT_Q13, np.int64), n.device)
    hi = torch.div(n, 5, rounding_mode="floor")
    third = (hi, n - 5 * hi)
    pred = []
    for ch in range(2):
        i0 = ix[ch][0] + 3 * third[ch]
        low = quant[i0.clamp(0, 15)]
        step = _smulwb(quant[(i0 + 1).clamp(0, 15)] - low, _HALF_STEP_Q16)
        pred.append(low + _w16(step) * _w16(2 * ix[ch][1] + 1))
    return torch.stack([pred[0] - pred[1], pred[1]], dim=1)


def ms_to_lr(x1, x2, pred, state: dict, fs_khz: int):
    """StereoDecState.ms_to_lr (stereo.py:41) on lanes: x1, x2 [B, L + 2]
    int64 (mid and side, each after a 2-sample history slot), pred [B, 2];
    state: dict(pred_prev_q13, s_mid, s_side).  Returns (left, right [B,
    L + 2], the new state); the first two samples of each are the state's
    history."""
    L = x1.shape[1] - 2
    x1 = torch.cat([state["s_mid"], x1[:, 2:]], dim=1)
    x2 = torch.cat([state["s_side"], x2[:, 2:]], dim=1)
    new = dict(s_mid=x1[:, L:L + 2], s_side=x2[:, L:L + 2],
               pred_prev_q13=pred)
    prev = state["pred_prev_q13"]
    interp = STEREO_INTERP_LEN_MS * fs_khz
    denom = (1 << 16) // interp
    delta = _rshift_round(_w16(pred - prev) * _w16(torch.full_like(
        pred, denom)), 16)
    k = torch.arange(1, L + 1, device=x1.device)[None, :]
    # the predictors at each sample: interpolated over the first interp
    # samples (running sums of delta, as the scalar adds them), then the
    # new ones
    p = [torch.where(k <= interp, prev[:, c:c + 1] + k * delta[:, c:c + 1],
                     pred[:, c:c + 1]) for c in range(2)]
    m0, m1, m2 = x1[:, :L], x1[:, 1:L + 1], x1[:, 2:L + 2]
    s = (m0 + m2 + 2 * m1) << 9
    s = _smlawb(x2[:, 1:L + 1] << 8, s, p[0])
    s = _smlawb(s, m1 << 11, p[1])
    side = _sat16(_rshift_round(s, 8))
    left = _sat16(m1 + side)
    right = _sat16(m1 - side)
    return (torch.cat([x1[:, :1], left, x1[:, L + 1:]], dim=1),
            torch.cat([x2[:, :1], right, x2[:, L + 1:]], dim=1), new)
