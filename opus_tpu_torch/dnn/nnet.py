"""Neural layer runtime: port of ``opus_tpu/dnn/nnet.py`` (reference:
dnn/nnet.c, dnn/nnet_arch.h, dnn/vec.h).

Every layer is a function over a NamedTuple of dense float32 tensors with
any leading batch dims.  The matrix products are ``torch.matmul`` (full
float32 on the card: the package turns TF32 off), as the JAX package
leaves its ``x @ w`` to XLA outside any kernel.  The activations keep the
reference's approximations (tanh_approx dnn/vec.h:338, lpcnet_exp2
dnn/vec.h:317), computed in float32 in the JAX code's order, not
``torch.tanh`` / ``torch.exp``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

ACTIVATION_LINEAR = 0
ACTIVATION_SIGMOID = 1
ACTIVATION_TANH = 2
ACTIVATION_RELU = 3
ACTIVATION_SOFTMAX = 4
ACTIVATION_SWISH = 5
ACTIVATION_EXP = 6


class Linear(NamedTuple):
    """Dense affine layer applied as ``x @ w``: ``w`` [nb_inputs,
    nb_outputs] (dnn/nnet_arch.h:123 sgemv's column-major layout)."""
    w: torch.Tensor                          # [M, N]
    bias: Optional[torch.Tensor] = None      # [N]
    diag: Optional[torch.Tensor] = None      # [3*M], GRU recurrent only


class Conv2d(NamedTuple):
    """Non-padded 2-D conv over [time, height] with per-frame streaming
    (reference: Conv2dLayer dnn/nnet.h:79)."""
    w: torch.Tensor                          # [out_ch, in_ch, ktime, kheight]
    bias: Optional[torch.Tensor] = None      # [out_ch]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def tanh_approx(x) -> torch.Tensor:
    """Rational tanh approximation (reference: dnn/vec.h:338)."""
    x = _f32(x)
    x2 = x * x
    num = (0.60863042 * x2 + 96.39235687) * x2 + 952.52801514
    den = (11.88600922 * x2 + 413.36801147) * x2 + 952.72399902
    return torch.clamp(num * x / den, -1.0, 1.0)


def sigmoid_approx(x) -> torch.Tensor:
    """(reference: dnn/vec.h:354)"""
    return 0.5 + 0.5 * tanh_approx(0.5 * _f32(x))


def lpcnet_exp2(x) -> torch.Tensor:
    """Bit-twiddled 2**x approximation (reference: dnn/vec.h:317).  The
    exponent add wraps as int32 in the reference; here it is done in int64
    (a multiply, not a shift of a negative value) and masked to 31 bits
    before narrowing, which keeps the same bits."""
    x = _f32(x)
    integer = torch.floor(x)
    frac = x - integer
    f = 0.99992522 + frac * (0.69583354 + frac * (0.22606716
                                                  + 0.078024523 * frac))
    bits = f.view(torch.int32).to(torch.int64) \
        + integer.to(torch.int64) * (1 << 23)
    res = (bits & 0x7FFFFFFF).to(torch.int32).view(torch.float32)
    return torch.where(integer < -50, torch.zeros_like(res), res)


def lpcnet_exp(x) -> torch.Tensor:
    """(reference: dnn/vec.h:335)"""
    return lpcnet_exp2(_f32(x) * 1.44269504)


def compute_activation(x, activation: int) -> torch.Tensor:
    """(reference: compute_activation_c dnn/nnet_arch.h:69).  SOFTMAX is a
    normalised softmax over the last axis built on the approximate exp;
    EXP is elementwise."""
    if activation == ACTIVATION_SIGMOID:
        return sigmoid_approx(x)
    if activation == ACTIVATION_TANH:
        return tanh_approx(x)
    if activation == ACTIVATION_SWISH:
        return x * sigmoid_approx(x)
    if activation == ACTIVATION_RELU:
        return torch.clamp_min(x, 0.0)
    if activation == ACTIVATION_SOFTMAX:
        e = lpcnet_exp(x)
        return e / (torch.sum(e, dim=-1, keepdim=True) + 1e-30)
    if activation == ACTIVATION_EXP:
        return lpcnet_exp(x)
    if activation != ACTIVATION_LINEAR:
        raise ValueError(f"unknown activation {activation}")
    return x


def linear(layer: Linear, x) -> torch.Tensor:
    """out = x @ w + bias (+ the GRU diag term) (reference:
    compute_linear_c dnn/nnet_arch.h:123-154).  x: [..., M] -> [..., N]."""
    x = _f32(x)
    out = torch.matmul(x, layer.w)
    if layer.bias is not None:
        out = out + layer.bias
    if layer.diag is not None:
        # GRU recurrent weights only: N == 3*M and
        # out[k*M + i] += diag[k*M + i] * x[i]  (nnet_arch.h:145-153)
        if 3 * x.shape[-1] != out.shape[-1]:
            raise ValueError("diag needs nb_outputs == 3 * nb_inputs")
        out = out + layer.diag * torch.cat([x, x, x], dim=-1)
    return out


def dense(layer: Linear, x, activation: int) -> torch.Tensor:
    """(reference: compute_generic_dense dnn/nnet.c:59)"""
    return compute_activation(linear(layer, x), activation)


def gru(input_w: Linear, recurrent_w: Linear, state, x) -> torch.Tensor:
    """One GRU step; returns the new state (reference:
    compute_generic_gru dnn/nnet.c:76, gate order z|r|h)."""
    n = state.shape[-1]
    zrh = linear(input_w, x)
    recur = linear(recurrent_w, state)
    zr = sigmoid_approx(zrh[..., :2 * n] + recur[..., :2 * n])
    z, r = zr[..., :n], zr[..., n:]
    h = tanh_approx(zrh[..., 2 * n:] + recur[..., 2 * n:] * r)
    return z * state + (1.0 - z) * h


def glu(layer: Linear, x) -> torch.Tensor:
    """Gated linear unit x * sigmoid(Wx) (reference: compute_glu
    dnn/nnet.c:107)."""
    return x * sigmoid_approx(linear(layer, x))


def conv1d(layer: Linear, mem, x, activation: int):
    """Streaming 1-D conv step, a dense layer over the window [mem | x]
    (reference: compute_generic_conv1d dnn/nnet.c:127).  mem: [...,
    nb_inputs - input_size].  Returns (out, new_mem)."""
    input_size = x.shape[-1]
    tmp = torch.cat([mem, _f32(x)], dim=-1)
    out = compute_activation(linear(layer, tmp), activation)
    return out, tmp[..., input_size:]


def conv1d_dilated(layer: Linear, mem, x, dilation: int, activation: int):
    """Dilated streaming conv (reference: compute_generic_conv1d_dilation
    dnn/nnet.c:138).  mem: [..., input_size*dilation*(ksize-1)], the raw
    input history; the taps are every ``dilation`` frames."""
    input_size = x.shape[-1]
    ksize = layer.w.shape[0] // input_size
    if dilation == 1:
        return conv1d(layer, mem, x, activation)
    step = input_size * dilation
    taps = [mem[..., i * step:i * step + input_size]
            for i in range(ksize - 1)]
    x = _f32(x)
    out = compute_activation(linear(layer, torch.cat(taps + [x], dim=-1)),
                             activation)
    return out, torch.cat([mem[..., input_size:], x], dim=-1)


def conv2d(layer: Conv2d, mem, x, height: int, activation: int):
    """One time frame of a non-padded 2-D conv (reference: compute_conv2d_c
    dnn/nnet_arch.h:217).  x: [..., in_ch, height+kheight-1] (the caller
    pads the height axis); mem: [..., ktime-1, in_ch, height+kheight-1].
    Returns (out [..., out_ch, height], new_mem)."""
    _, _, ktime, kheight = layer.w.shape
    x = _f32(x)
    buf = torch.cat([mem, x[..., None, :, :]], dim=-3) if ktime > 1 \
        else x[..., None, :, :]                   # [..., ktime, in, W]
    # windows over the height axis: [..., ktime, in_ch, kheight, height]
    win = torch.stack([buf[..., h:h + height] for h in range(kheight)],
                      dim=-2)
    out = torch.einsum("oith,...tihj->...oj", layer.w, win)
    if layer.bias is not None:
        out = out + layer.bias[..., :, None]
    new_mem = buf[..., 1:, :, :] if ktime > 1 else mem
    return compute_activation(out, activation), new_mem


def embedding(table, idx) -> torch.Tensor:
    """Row lookup (the reference's embedding layers, dnn/nnet.h)."""
    return table[idx]


def np_linear(w: np.ndarray, bias=None, diag=None, *, device) -> Linear:
    """A Linear on ``device`` from numpy arrays (float32)."""
    def t(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=device)
    return Linear(t(w), t(bias), t(diag))


def to_device(tree, device):
    """A model (NamedTuples and tuples of tensors, None leaves) with every
    tensor on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, tuple):
        return tuple(to_device(v, device) for v in tree)
    raise TypeError(f"to_device: unexpected leaf {type(tree)}")
