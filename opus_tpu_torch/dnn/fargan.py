"""FARGAN auto-regressive vocoder: port of ``opus_tpu/dnn/fargan.py``
(reference: dnn/fargan.c, dnn/fargan.h; architecture from
dnn/torch/fargan/fargan.py FARGANCond/FARGANSub).

Synthesizes 16 kHz speech from 20-dim LPCNet features in 40-sample
subframes, 4 per 10 ms frame.  The pitch buffer feeds a gain-normalised
prediction tap into every layer (the "pitch gate").  The model is a
NamedTuple of dense ``Linear`` layers; the state a NamedTuple of [B, ...]
tensors, replaced, never written in place.  The per-subframe de-emphasis
y[n] = x[n] + 0.85*y[n-1] (fargan.c:62) is kernel K2 on the card
(``ops/iir.deemphasis``) and its plain Toeplitz version on the CPU; it
only shapes the output (the pitch buffer holds the pcm before it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.iir import deemphasis
from . import nnet as nn
from .weights import WEIGHT_TYPE_FLOAT, WeightArray, linear_params, \
    linear_to_arrays

FARGAN_CONT_SAMPLES = 320
FARGAN_NB_SUBFRAMES = 4
FARGAN_SUBFRAME_SIZE = 40
FARGAN_FRAME_SIZE = FARGAN_NB_SUBFRAMES * FARGAN_SUBFRAME_SIZE
FARGAN_COND_SIZE = 80
FARGAN_DEEMPHASIS = 0.85
PITCH_MAX_PERIOD = 256          # (pitchdnn.h:10)
NB_FEATURES = 20
NB_BANDS = 18

SIG_NET_INPUT_SIZE = FARGAN_COND_SIZE + 2 * FARGAN_SUBFRAME_SIZE + 4
_PEMBED_DIMS = 12
_FWC0_OUT = 192
_GRU_SIZES = (160, 128, 128)
_GRU_IN = (272, 240, 208)
_GRU_OUT = (480, 384, 384)


class FARGANModel(NamedTuple):
    pembed: torch.Tensor               # [224, 12] pitch embedding
    cond_fdense1: nn.Linear            # 32 -> 64, tanh, no bias
    cond_fconv1: nn.Linear             # 192 -> 128 (k=3), no bias
    cond_fdense2: nn.Linear            # 128 -> 320, tanh, no bias
    cond_gain_dense: nn.Linear         # 80 -> 1
    fwc0_conv: nn.Linear               # 328 -> 192 (k=2), no bias
    fwc0_glu: nn.Linear                # 192 -> 192, no bias
    gain_dense_out: nn.Linear          # 192 -> 4, sigmoid
    gru_input: tuple                   # (272->480, 240->384, 208->384)
    gru_recurrent: tuple               # (160->480, 128->384, 128->384)
    gru_glu: tuple                     # per-GRU GLU gates
    skip_dense: nn.Linear              # 688 -> 128, tanh, no bias
    skip_glu: nn.Linear                # 128 -> 128, no bias
    sig_dense_out: nn.Linear           # 128 -> 40, tanh, no bias


class FARGANState(NamedTuple):
    pitch_buf: torch.Tensor            # [B, 256]
    cond_conv1_mem: torch.Tensor       # [B, 128]
    fwc0_mem: torch.Tensor             # [B, 164]
    gru: tuple                         # ([B, 160], [B, 128], [B, 128])
    deemph_mem: torch.Tensor           # [B]
    last_period: torch.Tensor          # [B] int32


def init_state(batch: int, *, device) -> FARGANState:
    """The zero state of ``batch`` streams on ``device``."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)
    return FARGANState(pitch_buf=z(PITCH_MAX_PERIOD), cond_conv1_mem=z(128),
                       fwc0_mem=z(SIG_NET_INPUT_SIZE),
                       gru=tuple(z(g) for g in _GRU_SIZES),
                       deemph_mem=z(), last_period=z(dtype=torch.int32))


def period_from_feature(features) -> torch.Tensor:
    """Pitch period from feature NB_BANDS (reference: fargan.c:207),
    floor(0.5 + 256 / 2**((1/60) * ((f + 1.5) * 60))) with every step in
    float32 as the JAX code computes it.  The power is taken in float64
    and rounded once to float32 (correctly rounded but for astronomically
    rare cases), so the card and the CPU give the same bits."""
    f = features[..., NB_BANDS].to(torch.float32)
    e = (1.0 / 60.0) * ((f + 1.5) * 60.0)
    p = torch.pow(2.0, e.to(torch.float64)).to(torch.float32)
    return torch.floor(0.5 + 256.0 / p).to(torch.int32)


def compute_cond(model: FARGANModel, conv1_mem, features, period):
    """(reference: compute_fargan_cond dnn/fargan.c:43).  Returns
    (cond [B, 320], new conv mem)."""
    idx = torch.clamp(period - 32, 0, 223).to(torch.int64)
    emb = nn.embedding(model.pembed, idx)
    dense_in = torch.cat([features[..., :NB_FEATURES].to(torch.float32),
                          emb], dim=-1)
    conv1_in = nn.dense(model.cond_fdense1, dense_in, nn.ACTIVATION_TANH)
    fdense2_in, conv1_mem = nn.conv1d(model.cond_fconv1, conv1_mem,
                                      conv1_in, nn.ACTIVATION_TANH)
    cond = nn.dense(model.cond_fdense2, fdense2_in, nn.ACTIVATION_TANH)
    return cond, conv1_mem


def run_subframe(model: FARGANModel, state: FARGANState, cond, period):
    """One 40-sample subframe (reference: run_fargan_subframe
    dnn/fargan.c:69).  cond: [B, 80].  Returns (state, pcm [B, 40]), the
    pcm de-emphasized."""
    sf = FARGAN_SUBFRAME_SIZE
    gain = torch.exp(nn.dense(model.cond_gain_dense, cond,
                              nn.ACTIVATION_LINEAR))          # [B, 1]
    gain_1 = 1.0 / (1e-5 + gain)

    # pred: 44 samples from the pitch buffer one period back, wrapping
    # forward when the period is shorter than the subframe
    period = period.to(torch.int64)
    pos = (PITCH_MAX_PERIOD - period - 2)[..., None] \
        + torch.arange(sf + 4, device=period.device)
    pos = torch.where(pos >= PITCH_MAX_PERIOD, pos - period[..., None], pos)
    # the C's max(0, pos); the upper clip covers the un-primed period 0
    # (gather raises on an index out of range, so it comes first)
    pos = torch.clamp(pos, 0, PITCH_MAX_PERIOD - 1)
    pred = torch.clamp(gain_1 * torch.gather(state.pitch_buf, -1, pos),
                       -1.0, 1.0)
    prev = torch.clamp(gain_1 * state.pitch_buf[..., -sf:], -1.0, 1.0)

    fwc0_in = torch.cat([cond, pred, prev], dim=-1)
    gru1_base, fwc0_mem = nn.conv1d(model.fwc0_conv, state.fwc0_mem,
                                    fwc0_in, nn.ACTIVATION_TANH)
    gru1_base = nn.glu(model.fwc0_glu, gru1_base)
    pitch_gate = nn.dense(model.gain_dense_out, gru1_base,
                          nn.ACTIVATION_SIGMOID)              # [B, 4]

    def gated(base, k):
        return torch.cat([base, pitch_gate[..., k:k + 1] * pred[..., 2:2 + sf],
                          prev], dim=-1)

    g1 = nn.gru(model.gru_input[0], model.gru_recurrent[0], state.gru[0],
                gated(gru1_base, 0))
    g1g = nn.glu(model.gru_glu[0], g1)
    g2 = nn.gru(model.gru_input[1], model.gru_recurrent[1], state.gru[1],
                gated(g1g, 1))
    g2g = nn.glu(model.gru_glu[1], g2)
    g3 = nn.gru(model.gru_input[2], model.gru_recurrent[2], state.gru[2],
                gated(g2g, 2))
    g3g = nn.glu(model.gru_glu[2], g3)

    skip_cat = torch.cat([g1g, g2g, g3g, gru1_base,
                          pitch_gate[..., 3:4] * pred[..., 2:2 + sf], prev],
                         dim=-1)
    skip = nn.dense(model.skip_dense, skip_cat, nn.ACTIVATION_TANH)
    skip = nn.glu(model.skip_glu, skip)
    pcm = nn.dense(model.sig_dense_out, skip, nn.ACTIVATION_TANH) * gain

    pitch_buf = torch.cat([state.pitch_buf[..., sf:], pcm], dim=-1)
    out, mem = deemphasis(pcm, state.deemph_mem, FARGAN_DEEMPHASIS)
    return state._replace(pitch_buf=pitch_buf, fwc0_mem=fwc0_mem,
                          gru=(g1, g2, g3), deemph_mem=mem), out


def synthesize_frame(model: FARGANModel, state: FARGANState, features):
    """One 10 ms frame of 160 samples (reference: fargan_synthesize_impl
    dnn/fargan.c:200).  features: [B, 20].  Returns (state, pcm [B, 160])."""
    period = period_from_feature(features)
    cond, conv1_mem = compute_cond(model, state.cond_conv1_mem, features,
                                   period)
    state = state._replace(cond_conv1_mem=conv1_mem)
    outs = []
    for s in range(FARGAN_NB_SUBFRAMES):
        sub_cond = cond[..., s * FARGAN_COND_SIZE:(s + 1) * FARGAN_COND_SIZE]
        state, pcm = run_subframe(model, state, sub_cond, state.last_period)
        outs.append(pcm)
    return state._replace(last_period=period), torch.cat(outs, dim=-1)


def cont(model: FARGANModel, state: FARGANState, pcm0,
         features0) -> FARGANState:
    """Primes the vocoder from 320 samples of real output and the 5
    feature frames before concealment starts (reference: fargan_cont
    dnn/fargan.c:142).  pcm0: [B, 320]; features0: [B, 5, 20]."""
    pcm0 = pcm0.to(torch.float32)
    period = torch.zeros(features0.shape[:-2], dtype=torch.int32,
                         device=features0.device)
    cond = None
    for i in range(5):
        f = features0[..., i, :]
        state = state._replace(last_period=period)
        period = period_from_feature(f)
        cond, mem = compute_cond(model, state.cond_conv1_mem, f, period)
        state = state._replace(cond_conv1_mem=mem)
    # the pre-emphasized continuation signal
    x0 = torch.cat([torch.zeros_like(pcm0[..., :1]),
                    pcm0[..., 1:] - FARGAN_DEEMPHASIS * pcm0[..., :-1]],
                   dim=-1)
    keep = PITCH_MAX_PERIOD - FARGAN_FRAME_SIZE
    state = state._replace(pitch_buf=torch.cat(
        [state.pitch_buf[..., :keep], x0[..., :FARGAN_FRAME_SIZE]], dim=-1))
    keep = PITCH_MAX_PERIOD - FARGAN_SUBFRAME_SIZE
    for i in range(FARGAN_NB_SUBFRAMES):
        sub_cond = cond[..., i * FARGAN_COND_SIZE:(i + 1) * FARGAN_COND_SIZE]
        state, _ = run_subframe(model, state, sub_cond, state.last_period)
        lo = FARGAN_FRAME_SIZE + i * FARGAN_SUBFRAME_SIZE
        state = state._replace(pitch_buf=torch.cat(
            [state.pitch_buf[..., :keep],
             x0[..., lo:lo + FARGAN_SUBFRAME_SIZE]], dim=-1))
    return state._replace(deemph_mem=pcm0[..., -1].contiguous())


def random_model(seed=0, *, device) -> FARGANModel:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_model(seed)``."""
    r = np.random.default_rng(seed)

    def rl(m, n, bias=False):
        w = (r.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        b = (r.standard_normal(n) * 0.1).astype(np.float32) if bias \
            else None
        return nn.np_linear(w, b, device=device)

    pembed = torch.as_tensor(
        r.standard_normal((224, _PEMBED_DIMS)).astype(np.float32),
        device=device)
    return FARGANModel(
        pembed=pembed,
        cond_fdense1=rl(NB_FEATURES + _PEMBED_DIMS, 64),
        cond_fconv1=rl(192, 128),
        cond_fdense2=rl(128, 4 * FARGAN_COND_SIZE),
        cond_gain_dense=rl(FARGAN_COND_SIZE, 1, bias=True),
        fwc0_conv=rl(2 * SIG_NET_INPUT_SIZE, _FWC0_OUT),
        fwc0_glu=rl(_FWC0_OUT, _FWC0_OUT),
        gain_dense_out=rl(_FWC0_OUT, 4, bias=True),
        gru_input=tuple(rl(_GRU_IN[k], _GRU_OUT[k]) for k in range(3)),
        gru_recurrent=tuple(rl(_GRU_SIZES[k], _GRU_OUT[k])
                            for k in range(3)),
        gru_glu=tuple(rl(_GRU_SIZES[k], _GRU_SIZES[k]) for k in range(3)),
        skip_dense=rl(688, 128),
        skip_glu=rl(128, 128),
        sig_dense_out=rl(128, FARGAN_SUBFRAME_SIZE))


def model_to_arrays(model: FARGANModel) -> list[WeightArray]:
    """The model as blob arrays (the inverse of ``model_from_arrays``)."""
    out = [WeightArray("cond_net_pembed_weights_float", WEIGHT_TYPE_FLOAT,
                       model.pembed.detach().cpu().numpy()
                       .astype(np.float32).reshape(-1))]

    def put(name, lin):
        out.extend(linear_to_arrays(name, lin))

    put("cond_net_fdense1", model.cond_fdense1)
    put("cond_net_fconv1", model.cond_fconv1)
    put("cond_net_fdense2", model.cond_fdense2)
    put("sig_net_cond_gain_dense", model.cond_gain_dense)
    put("sig_net_fwc0_conv", model.fwc0_conv)
    put("sig_net_fwc0_glu_gate", model.fwc0_glu)
    put("sig_net_gain_dense_out", model.gain_dense_out)
    for k in range(3):
        put(f"sig_net_gru{k+1}_input", model.gru_input[k])
        put(f"sig_net_gru{k+1}_recurrent", model.gru_recurrent[k])
        put(f"sig_net_gru{k+1}_glu_gate", model.gru_glu[k])
    put("sig_net_skip_dense", model.skip_dense)
    put("sig_net_skip_glu_gate", model.skip_glu)
    put("sig_net_sig_dense_out", model.sig_dense_out)
    return out


def model_from_arrays(arrays, *, device) -> FARGANModel:
    """From a parsed weight blob (names per
    dnn/torch/fargan/export_fargan_weights.py)."""
    def lin(name, m, n, bias=False):
        return linear_params(arrays, float_weights=f"{name}_weights_float",
                             bias=f"{name}_bias" if bias else None,
                             nb_inputs=m, nb_outputs=n, device=device)
    pembed = arrays["cond_net_pembed_weights_float"].data \
        .astype(np.float32).reshape(224, _PEMBED_DIMS)
    return FARGANModel(
        pembed=torch.as_tensor(pembed, device=device),
        cond_fdense1=lin("cond_net_fdense1", 32, 64),
        cond_fconv1=lin("cond_net_fconv1", 192, 128),
        cond_fdense2=lin("cond_net_fdense2", 128, 320),
        cond_gain_dense=lin("sig_net_cond_gain_dense", 80, 1, bias=True),
        fwc0_conv=lin("sig_net_fwc0_conv", 328, 192),
        fwc0_glu=lin("sig_net_fwc0_glu_gate", 192, 192),
        gain_dense_out=lin("sig_net_gain_dense_out", 192, 4, bias=True),
        gru_input=tuple(lin(f"sig_net_gru{k+1}_input", _GRU_IN[k],
                            _GRU_OUT[k]) for k in range(3)),
        gru_recurrent=tuple(lin(f"sig_net_gru{k+1}_recurrent",
                                _GRU_SIZES[k], _GRU_OUT[k])
                            for k in range(3)),
        gru_glu=tuple(lin(f"sig_net_gru{k+1}_glu_gate", _GRU_SIZES[k],
                          _GRU_SIZES[k]) for k in range(3)),
        skip_dense=lin("sig_net_skip_dense", 688, 128),
        skip_glu=lin("sig_net_skip_glu_gate", 128, 128),
        sig_dense_out=lin("sig_net_sig_dense_out", 128, 40))
