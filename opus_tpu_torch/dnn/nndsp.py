"""Adaptive NN-DSP filters of OSCE over a leading batch of streams: port of
``opus_tpu/dnn/nndsp.py`` (reference: dnn/nndsp.c).

- adaconv: a data-dependent FIR whose kernel and gain come from dense
  layers, cross-faded with the previous frame's kernel over an overlap
  window;
- adacomb: a data-dependent pitch comb filter with a per-lane lag;
- adashape: gain shaping conditioned on the temporal envelope.

Every function takes [B] lanes and ``n`` consecutive frames in one call:
x_in [B, ch, n * frame_size] (a frame's samples contiguous per channel),
features [B, n, F].  Within one call frame k's state is frame k-1's, and
that state holds only the stage's own inputs, its kernels, lags and gains,
all of which are known for the whole call; so the n frames run as one
batched step and equal n calls in a row.  The states are NamedTuples of
[B, ...] tensors, replaced, never written.

Each step follows the dtype numpy computes it in (NumPy 2 keeps Python
floats weak and numpy scalars strong): the kernel norm and the comb's
gains (``np.exp`` of Python floats) are float64, and so are the comb's
output terms that they multiply; the correlations are rounded once from
float64 sums (numpy's 16-term float32 dots are within a few ulps of that);
float32 ``exp`` and ``log`` are taken in float64 and rounded once, so the
card and the CPU agree bit for bit.  Lags and pitch indices are per-lane
gathers, clamped into the history so that garbage lanes cannot fault.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.device_cache import const
from . import nnet as nn

ADACONV_MAX_KERNEL_SIZE = 32
ADACOMB_MAX_LAG = 300


def compute_overlap_window(overlap_size: int) -> np.ndarray:
    """(reference: compute_overlap_window dnn/nndsp.c:63)"""
    i = np.arange(overlap_size)
    return (0.5 + 0.5 * np.cos(np.pi * (i + 0.5) / overlap_size)) \
        .astype(np.float32)


def _window(overlap_size: int, device) -> torch.Tensor:
    return const(("nndsp_window", overlap_size),
                 lambda: compute_overlap_window(overlap_size), device)


def _exp_f32(x) -> torch.Tensor:
    """float32 exp, taken in float64 and rounded once."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def _scale_kernel(kernel, in_ch, out_ch, ksize, gain):
    """p-norm normalise over (in_ch, kernel) (reference: scale_kernel
    dnn/nndsp.c:81).  kernel [..., out*in*ksize] f32, gain [..., out] f32
    -> [..., out, in, ksize] f32; the norm and the product are float64."""
    k = kernel.reshape(kernel.shape[:-1] + (out_ch, in_ch, ksize)) \
        .to(torch.float64)
    norm = 1.0 / (1e-6 + torch.sqrt((k * k).sum(dim=(-2, -1))))
    return (k * (norm * gain.to(torch.float64))[..., None, None]) \
        .to(torch.float32)


def _xcorr(kernel, windows) -> torch.Tensor:
    """out[..., i] = sum_j kernel[..., j] * windows[..., i, j] (kernel
    [..., ks], windows [..., rows, ks], leading dims broadcast), summed in
    float64 and rounded once (celt_pitch_xcorr's use in nndsp)."""
    return torch.matmul(windows.to(torch.float64),
                        kernel.to(torch.float64)[..., None])[..., 0] \
        .to(torch.float32)


def _prev(state_val, seq):
    """[state, seq[:, 0], ..., seq[:, n-2]]: each frame's predecessor."""
    return torch.cat([state_val[:, None], seq[:, :-1]], dim=1)


class AdaConvState(NamedTuple):
    history: torch.Tensor        # [B, in_ch, kernel_size]
    last_kernel: torch.Tensor    # [B, out_ch, in_ch, kernel_size]


def adaconv_init(batch, in_ch, out_ch, ksize, *, device) -> AdaConvState:
    return AdaConvState(
        torch.zeros((batch, in_ch, ksize), device=device),
        torch.zeros((batch, out_ch, in_ch, ksize), device=device))


def adaconv_process_frame(state: AdaConvState, x_in, features,
                          kernel_layer: nn.Linear, gain_layer: nn.Linear,
                          frame_size: int, overlap_size: int, in_ch: int,
                          out_ch: int, ksize: int, left_padding: int,
                          gain_a: float, gain_b: float):
    """(reference: adaconv_process_frame dnn/nndsp.c:133).  x_in [B, in_ch,
    n * frame_size], features [B, n, F].  Returns (state, x_out [B, out_ch,
    n * frame_size])."""
    if left_padding != ksize - 1:
        raise ValueError("adaconv: causal kernels only")
    b, n = features.shape[:2]
    x = x_in.to(torch.float32).reshape(b, in_ch, n * frame_size)
    kernel = nn.dense(kernel_layer, features, nn.ACTIVATION_LINEAR)
    gain = nn.dense(gain_layer, features, nn.ACTIVATION_TANH)
    gain = _exp_f32(gain_a * gain + gain_b)
    kernel = _scale_kernel(kernel, in_ch, out_ch, ksize, gain)
    last = _prev(state.last_kernel, kernel)     # [B, n, out, in, ks]

    # [history | x] per channel; frame k's lag-0 sample for output i is
    # buf[k * frame + ksize - left_padding + i]
    buf = torch.cat([state.history, x], dim=2)
    off = ksize - left_padding
    win = buf.unfold(2, ksize, 1)[:, :, off:off + n * frame_size] \
        .reshape(b, in_ch, n, frame_size, ksize).permute(0, 2, 1, 3, 4)
    c1 = _xcorr(kernel, win[:, :, None])           # [B, n, out, in, fr]
    c0 = _xcorr(last, win[:, :, None, :, :overlap_size])
    w = _window(overlap_size, x.device)
    head = w * c0 + (1.0 - w) * c1[..., :overlap_size]
    mixed = torch.cat([head, c1[..., overlap_size:]], dim=-1)
    out = mixed[:, :, :, 0]
    for ic in range(1, in_ch):
        out = out + mixed[:, :, :, ic]
    out = out.permute(0, 2, 1, 3).reshape(b, out_ch, n * frame_size)
    return AdaConvState(buf[:, :, n * frame_size:], kernel[:, -1]), out


class AdaCombState(NamedTuple):
    history: torch.Tensor           # [B, kernel_size + MAX_LAG]
    last_kernel: torch.Tensor       # [B, kernel_size]
    last_pitch_lag: torch.Tensor    # [B] int64
    last_global_gain: torch.Tensor  # [B] f32


def adacomb_init(batch, ksize, *, device) -> AdaCombState:
    return AdaCombState(
        torch.zeros((batch, ksize + ADACOMB_MAX_LAG), device=device),
        torch.zeros((batch, ksize), device=device),
        torch.zeros((batch,), dtype=torch.int64, device=device),
        torch.zeros((batch,), device=device))


def adacomb_process_frame(state: AdaCombState, x_in, features,
                          kernel_layer: nn.Linear, gain_layer: nn.Linear,
                          global_gain_layer: nn.Linear, pitch_lag,
                          frame_size: int, overlap_size: int, ksize: int,
                          left_padding: int, gain_a: float, gain_b: float,
                          log_gain_limit: float):
    """(reference: adacomb_process_frame dnn/nndsp.c:245).  x_in [B,
    n * frame_size], features [B, n, F], pitch_lag [B, n] int.  Returns
    (state, x_out [B, n * frame_size])."""
    b, n = features.shape[:2]
    x = x_in.to(torch.float32).reshape(b, n * frame_size)
    kernel = nn.dense(kernel_layer, features, nn.ACTIVATION_LINEAR)
    gain = nn.dense(gain_layer, features, nn.ACTIVATION_RELU)[..., 0]
    ggain = nn.dense(global_gain_layer, features, nn.ACTIVATION_TANH)[..., 0]
    # np.exp of Python floats: float64 numpy scalars (strong)
    gain = torch.exp(log_gain_limit - gain.to(torch.float64))
    ggain = torch.exp(gain_a * ggain.to(torch.float64) + gain_b)
    kernel = _scale_kernel(kernel, 1, 1, ksize,
                           gain.to(torch.float32)[..., None])[..., 0, 0, :]
    lag = pitch_lag.to(torch.int64).clamp(0, ADACOMB_MAX_LAG)
    last_lag = _prev(state.last_pitch_lag, lag)
    last_kernel = _prev(state.last_kernel, kernel)
    lgg = _prev(state.last_global_gain, ggain.to(torch.float32))

    hist = ksize + ADACOMB_MAX_LAG
    buf = torch.cat([state.history, x], dim=1)      # [B, hist + n * fr]
    start = hist + frame_size * torch.arange(n, device=x.device)
    taps = torch.arange(frame_size, device=x.device)[:, None] \
        + torch.arange(ksize, device=x.device)[None, :]

    def windows(lags, rows):
        idx = (start - left_padding)[None, :, None, None] \
            - lags[:, :, None, None] + taps[None, None, :rows]
        idx = idx.clamp(0, buf.shape[1] - 1)
        return torch.gather(buf, 1, idx.reshape(b, -1)) \
            .reshape(b, n, rows, ksize)

    cur = _xcorr(kernel, windows(lag, frame_size))
    last = _xcorr(last_kernel, windows(last_lag, overlap_size))
    xs = x.reshape(b, n, frame_size)
    w = _window(overlap_size, x.device)
    omw64 = (1.0 - w).to(torch.float64)
    g = ggain[..., None]
    head = ((lgg[..., None] * w) * last).to(torch.float64) \
        + (g * omw64) * cur[..., :overlap_size].to(torch.float64)
    head = head.to(torch.float32).to(torch.float64) \
        + ((w * lgg[..., None]).to(torch.float64) + omw64 * g) \
        * xs[..., :overlap_size].to(torch.float64)
    tail = g * (cur[..., overlap_size:] + xs[..., overlap_size:]) \
        .to(torch.float64)
    out = torch.cat([head, tail], dim=-1).to(torch.float32)
    new = AdaCombState(buf[:, n * frame_size:], kernel[:, -1], lag[:, -1],
                       ggain[:, -1].to(torch.float32))
    return new, out.reshape(b, n * frame_size)


class AdaShapeState(NamedTuple):
    alpha1f_mem: torch.Tensor        # [B, feature_dim]
    alpha1t_mem: torch.Tensor        # [B, frame_size // avg_pool_k + 1]
    alpha2_mem: torch.Tensor         # [B, frame_size // interpolate_k]
    interpolate_state: torch.Tensor  # [B] f32


def adashape_init(batch, feature_dim, frame_size, avg_pool_k,
                  interpolate_k=1, *, device) -> AdaShapeState:
    hidden = frame_size // interpolate_k
    tenv = frame_size // avg_pool_k
    return AdaShapeState(torch.zeros((batch, feature_dim), device=device),
                         torch.zeros((batch, tenv + 1), device=device),
                         torch.zeros((batch, hidden), device=device),
                         torch.zeros((batch,), device=device))


def np_sum(x) -> torch.Tensor:
    """numpy's sum of a contiguous 1-D array of at most 128 terms (float32
    or float64), over the last axis: a plain loop below 8 terms, else its
    pairwise sum's block (8 partial sums over blocks of 8, combined as a
    tree, then the remainder in order)."""
    n = x.shape[-1]
    if n > 128:
        raise ValueError("np_sum: at most 128 terms")
    if n < 8:
        s = x[..., 0]
        for i in range(1, n):
            s = s + x[..., i]
        return s
    m = n - n % 8
    r = x[..., :8]
    for i in range(8, m, 8):
        r = r + x[..., i:i + 8]
    s = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) \
        + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for i in range(m, n):
        s = s + x[..., i]
    return s


def conv1d_seq(layer: nn.Linear, mem, xs, activation: int):
    """``nn.conv1d`` over n steps in one product: xs [B, n, D], mem [B,
    (k - 1) D] the k - 1 previous inputs, oldest first, for a layer k
    inputs wide.  Returns (out [B, n, N], new mem)."""
    b, n, d = xs.shape
    if mem.shape[-1] % d:
        raise ValueError("conv1d_seq: memory must be whole inputs wide")
    k1 = mem.shape[-1] // d
    seq = torch.cat([mem.reshape(b, k1, d), xs], dim=1)
    win = torch.cat([seq[:, i:i + n] for i in range(k1 + 1)], dim=-1)
    return nn.dense(layer, win, activation), seq[:, n:].reshape(b, k1 * d)


def adashape_process_frame(state: AdaShapeState, x_in, features,
                           alpha1f: nn.Linear, alpha1t: nn.Linear,
                           alpha2: nn.Linear, frame_size: int,
                           avg_pool_k: int, interpolate_k: int = 1):
    """(reference: adashape_process_frame dnn/nndsp.c:338).  x_in [B,
    n * frame_size], features [B, n, F].  Returns (state, x_out [B,
    n * frame_size])."""
    b, n = features.shape[:2]
    hidden = frame_size // interpolate_k
    tenv_size = frame_size // avg_pool_k
    x = x_in.to(torch.float32).reshape(b, n, frame_size)
    # temporal envelope, log domain, mean removed (numpy's sum orders)
    tenv = x.abs().reshape(b, n, tenv_size, avg_pool_k)
    tenv = np_sum(tenv) / avg_pool_k
    tenv = torch.log((tenv + 1.52587890625e-05).to(torch.float64)) \
        .to(torch.float32)
    mean = np_sum(tenv) / tenv_size
    tenv = torch.cat([tenv - mean[..., None], mean[..., None]], dim=-1)

    f_out, a1f_mem = conv1d_seq(alpha1f, state.alpha1f_mem, features,
                                 nn.ACTIVATION_LINEAR)
    t_out, a1t_mem = conv1d_seq(alpha1t, state.alpha1t_mem, tenv,
                                 nn.ACTIVATION_LINEAR)
    tmp = f_out[..., :hidden] + t_out[..., :hidden]
    tmp = torch.where(tmp >= 0, tmp, 0.2 * tmp)
    a2, a2_mem = conv1d_seq(alpha2, state.alpha2_mem, tmp,
                             nn.ACTIVATION_LINEAR)
    a2 = a2[..., :hidden]
    # linear interpolation: out[i*k + j] = alpha_j a2[i] + (1 - alpha_j)
    # prev, prev the preceding a2 value (a Python float in numpy: its
    # product is float64, rounded to float32 when added)
    prev = torch.cat([_prev(state.interpolate_state, a2[..., -1])[..., None],
                      a2[..., :-1]], dim=-1).to(torch.float64)
    parts = []
    for j in range(interpolate_k):
        alpha = (j + 1) / interpolate_k
        parts.append(alpha * a2 + ((1.0 - alpha) * prev).to(torch.float32))
    out = torch.stack(parts, dim=-1).reshape(b, n, frame_size)
    shaped = nn.compute_activation(out, nn.ACTIVATION_EXP) * x
    new = AdaShapeState(a1f_mem, a1t_mem, a2_mem, a2[:, -1, -1])
    return new, shaped.reshape(b, n * frame_size)
