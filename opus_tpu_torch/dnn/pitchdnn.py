"""Neural pitch estimator: port of ``opus_tpu/dnn/pitchdnn.py`` (reference:
dnn/pitchdnn.c; architecture from dnn/torch/neural-pitch/models.py
PitchDNN).

Joint instantaneous-frequency + cross-correlation estimator over a
leading batch of streams: the IF branch is two dense layers, the xcorr
branch two streaming 2-D convs over the 224 lag bins, merged into a GRU
and upsampled to 180 pitch logits; the output is a softmax-refined argmax
mapped to the LPCNet pitch parameter in [-1.5, 1.5].  The model is a
NamedTuple of layers, the state a NamedTuple of [B, ...] tensors,
replaced, never written in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import nnet as nn
from .weights import (WEIGHT_TYPE_FLOAT, WeightArray, conv2d_params,
                      linear_params, linear_to_arrays)

PITCH_MIN_PERIOD = 32
PITCH_MAX_PERIOD = 256
NB_XCORR_FEATURES = PITCH_MAX_PERIOD - PITCH_MIN_PERIOD      # 224
PITCH_IF_MAX_FREQ = 30
PITCH_IF_FEATURES = 3 * PITCH_IF_MAX_FREQ - 2                # 88
NB_PITCH_LOGITS = 180
_GRU_DIM = 64


class PitchDNNModel(NamedTuple):
    if_up1: nn.Linear              # 88 -> 64, tanh
    if_up2: nn.Linear              # 64 -> 64, tanh
    conv1: nn.Conv2d               # 1 -> 4 ch, 3x3
    conv2: nn.Conv2d               # 4 -> 1 ch, 3x3
    downsampler: nn.Linear         # 288 -> 64, tanh
    gru_input: nn.Linear           # 64 -> 192
    gru_recurrent: nn.Linear       # 64 -> 192
    final: nn.Linear               # 64 -> 192 (180 used), linear


class PitchDNNState(NamedTuple):
    gru: torch.Tensor              # [B, 64]
    conv1_mem: torch.Tensor        # [B, 2, 1, 226]
    conv2_mem: torch.Tensor        # [B, 2, 4, 226]


def init_state(batch: int, *, device) -> PitchDNNState:
    """The zero state of ``batch`` streams on ``device``."""
    def z(*shape):
        return torch.zeros((batch,) + shape, dtype=torch.float32,
                           device=device)
    return PitchDNNState(gru=z(_GRU_DIM),
                         conv1_mem=z(2, 1, NB_XCORR_FEATURES + 2),
                         conv2_mem=z(2, 4, NB_XCORR_FEATURES + 2))


def _pad1(x):
    """One zero bin on each side of the last axis."""
    return torch.nn.functional.pad(x, (1, 1))


def pitch_logits(model: PitchDNNModel, state: PitchDNNState, if_features,
                 xcorr_features):
    """The network (reference: compute_pitchdnn dnn/pitchdnn.c:40 up to the
    final layer).  if_features [B, 88], xcorr_features [B, 224].  Returns
    (new state, logits [B, 180])."""
    h = NB_XCORR_FEATURES
    if1 = nn.dense(model.if_up1, if_features, nn.ACTIVATION_TANH)
    if2 = nn.dense(model.if_up2, if1, nn.ACTIVATION_TANH)
    # the C writes the 224 bins at offset 1 of a 226 buffer (pitchdnn.c:50)
    x1 = _pad1(xcorr_features.to(torch.float32))[:, None, :]
    c1, m1 = nn.conv2d(model.conv1, state.conv1_mem, x1, h,
                       nn.ACTIVATION_TANH)
    c2, m2 = nn.conv2d(model.conv2, state.conv2_mem, _pad1(c1), h,
                       nn.ACTIVATION_TANH)
    down = nn.dense(model.downsampler, torch.cat([c2[:, 0, :], if2], dim=-1),
                    nn.ACTIVATION_TANH)
    gru = nn.gru(model.gru_input, model.gru_recurrent, state.gru, down)
    logits = nn.dense(model.final, gru, nn.ACTIVATION_LINEAR)
    return PitchDNNState(gru, m1, m2), logits[:, :NB_PITCH_LOGITS]


def refine(logits):
    """Softmax-weighted refinement around the argmax (pitchdnn.c:70):
    (argmax [B] int64, pitch [B] float32 in [-1.5, 1.5]).

    As the JAX code: p = exp(logit) on [pos-2, pos+2] clipped to the 180
    bins, refined = sum(p * idx) / sum(p), pitch = refined / 60 - 1.5,
    float32.  The exponential is taken in float64 and rounded once (f32
    ``exp`` differs by an ULP between libraries), and the five window
    terms are added in index order, so the card and the CPU agree."""
    pos = torch.argmax(logits, dim=-1)
    k = pos[:, None] + torch.arange(-2, 3, device=logits.device)
    valid = (k >= 0) & (k < NB_PITCH_LOGITS)
    kc = torch.clamp(k, 0, NB_PITCH_LOGITS - 1)
    e = torch.exp(torch.gather(logits, 1, kc).to(torch.float64)) \
        .to(torch.float32)
    p = torch.where(valid, e, torch.zeros_like(e))
    pi = p * kc.to(torch.float32)
    num, den = pi[:, 0], p[:, 0]
    for j in range(1, 5):
        num = num + pi[:, j]
        den = den + p[:, j]
    return pos, (1.0 / 60.0) * (num / den) - 1.5


def compute_pitch(model: PitchDNNModel, state: PitchDNNState, if_features,
                  xcorr_features):
    """(reference: compute_pitchdnn dnn/pitchdnn.c:40).  Returns (new
    state, pitch [B] in [-1.5, 1.5])."""
    state, logits = pitch_logits(model, state, if_features, xcorr_features)
    return state, refine(logits)[1]


def random_model(seed=0, *, device) -> PitchDNNModel:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_model(seed)``."""
    r = np.random.default_rng(seed)

    def rl(m, n):
        w = (r.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        b = (r.standard_normal(n) * 0.1).astype(np.float32)
        return nn.np_linear(w, b, device=device)

    def conv(ic, oc):
        w = (r.standard_normal((oc, ic, 3, 3)) / 3).astype(np.float32)
        b = (r.standard_normal(oc) * 0.1).astype(np.float32)
        return nn.Conv2d(torch.as_tensor(w, device=device),
                         torch.as_tensor(b, device=device))

    return PitchDNNModel(
        if_up1=rl(PITCH_IF_FEATURES, 64), if_up2=rl(64, 64),
        conv1=conv(1, 4), conv2=conv(4, 1),
        downsampler=rl(NB_XCORR_FEATURES + 64, 64),
        gru_input=rl(64, 192), gru_recurrent=rl(64, 192), final=rl(64, 192))


_LINEARS = (("dense_if_upsampler_1", "if_up1", PITCH_IF_FEATURES, 64),
            ("dense_if_upsampler_2", "if_up2", 64, 64),
            ("dense_downsampler", "downsampler", NB_XCORR_FEATURES + 64, 64),
            ("dense_final_upsampler", "final", 64, 192),
            ("gru_1_input", "gru_input", 64, 192),
            ("gru_1_recurrent", "gru_recurrent", 64, 192))
_CONVS = (("conv2d_1", "conv1", 1, 4), ("conv2d_2", "conv2", 4, 1))


def model_to_arrays(model: PitchDNNModel) -> list[WeightArray]:
    """The model as blob arrays (the inverse of ``model_from_arrays``), in
    the JAX package's order."""
    out = []
    for name, field, _, _ in _LINEARS:
        out.extend(linear_to_arrays(name, getattr(model, field)))
    for name, field, _, _ in _CONVS:
        conv = getattr(model, field)
        out.append(WeightArray(f"{name}_weights_float", WEIGHT_TYPE_FLOAT,
                               conv.w.detach().cpu().numpy()
                               .astype(np.float32).reshape(-1)))
        out.append(WeightArray(f"{name}_bias", WEIGHT_TYPE_FLOAT,
                               conv.bias.detach().cpu().numpy()
                               .astype(np.float32)))
    return out


def model_from_arrays(arrays, *, device) -> PitchDNNModel:
    """From a parsed weight blob (names per
    dnn/torch/neural-pitch/export_neuralpitch_weights.py)."""
    fields = {}
    for name, field, m, n in _LINEARS:
        fields[field] = linear_params(
            arrays, float_weights=f"{name}_weights_float",
            bias=f"{name}_bias", nb_inputs=m, nb_outputs=n, device=device)
    for name, field, ic, oc in _CONVS:
        fields[field] = conv2d_params(
            arrays, bias=f"{name}_bias", float_weights=f"{name}_weights_float",
            in_channels=ic, out_channels=oc, ktime=3, kheight=3,
            device=device)
    return PitchDNNModel(**fields)
