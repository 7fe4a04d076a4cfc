"""DRED RDOVAE encoder and decoder networks: port of
``opus_tpu/dnn/rdovae.py`` (reference: dnn/dred_rdovae_enc.c,
dnn/dred_rdovae_dec.c; architecture from dnn/torch/rdovae/rdovae/rdovae.py
CoreEncoder/CoreDecoder).

Every 40 ms the encoder maps a double feature frame (2 x 20 features) to
an 80-dim latent plus a 24-dim initial decoder state; the decoder maps
one latent (+ a q-level scalar) back to a quadruple feature frame (4 x 20,
newest first).  The model is a NamedTuple of dense ``Linear`` layers; the
state (5 GRU states + 5 conv memories) a NamedTuple of [B, ...] tensors,
replaced, never written in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import nnet as nn
from .weights import WeightArray, linear_params, linear_to_arrays

DRED_NUM_FEATURES = 20
DRED_LATENT_DIM = 80
DRED_STATE_DIM = 24
DRED_FRAME_SIZE = 160          # 10 ms at 16 kHz (dred_config.h:43)
DRED_MAX_LATENTS = 26
DRED_NUM_REDUNDANCY_FRAMES = 2 * DRED_MAX_LATENTS

# input widths per layer, from rdovae.py:382-399 / 495-513
_ENC_GRU_IN = (64, 160, 256, 352, 448)
_DEC_GRU_IN = (96, 192, 288, 384, 480)
_ENC_CONV_DENSE_IN = (96, 192, 288, 384, 480)
_DEC_CONV_DENSE_IN = (160, 256, 352, 448, 544)
_ENC_CONV_DIL = (1, 2, 2, 2, 2)


class RDOVAEEnc(NamedTuple):
    dense1: nn.Linear                  # 40 -> 64, tanh
    gru_input: tuple                   # 5x Linear in -> 96
    gru_recurrent: tuple               # 5x Linear 32 -> 96
    conv_dense: tuple                  # 5x Linear in -> 64, tanh
    conv: tuple                        # 5x Linear 128 -> 64 (k=2)
    zdense: nn.Linear                  # 544 -> 80, linear
    gdense1: nn.Linear                 # 544 -> 128, tanh
    gdense2: nn.Linear                 # 128 -> 24, linear


class RDOVAEDec(NamedTuple):
    dense1: nn.Linear                  # 81 -> 96, tanh
    gru_input: tuple                   # 5x Linear in -> 192
    gru_recurrent: tuple               # 5x Linear 64 -> 192
    glu: tuple                         # 5x Linear 64 -> 64, no bias
    conv_dense: tuple                  # 5x Linear in -> 32, tanh
    conv: tuple                        # 5x Linear 64 -> 32 (k=2)
    output: nn.Linear                  # 576 -> 80, linear
    hidden_init: nn.Linear             # 24 -> 128, tanh
    gru_init: nn.Linear                # 128 -> 320, tanh


class RDOVAEEncState(NamedTuple):
    gru: tuple                         # 5x [..., 32]
    conv: tuple                        # conv memories (dilation-sized)


class RDOVAEDecState(NamedTuple):
    gru: tuple                         # 5x [..., 64]
    conv: tuple                        # 5x [..., 32]


def enc_init_state(batch_shape=(), *, device) -> RDOVAEEncState:
    def z(n):
        return torch.zeros(tuple(batch_shape) + (n,), device=device)
    return RDOVAEEncState(gru=tuple(z(32) for _ in range(5)),
                          conv=tuple(z(64 * _ENC_CONV_DIL[k])
                                     for k in range(5)))


def encode_dframe(model: RDOVAEEnc, state: RDOVAEEncState, features):
    """One 40 ms step (reference: dred_rdovae_encode_dframe
    dred_rdovae_enc.c:47).  features: [..., 40].  Returns (new_state,
    latents [..., 80], initial_state [..., 24])."""
    x = nn.dense(model.dense1, features, nn.ACTIVATION_TANH)
    grus, convs = [], []
    for k in range(5):
        g = nn.gru(model.gru_input[k], model.gru_recurrent[k], state.gru[k],
                   x)
        grus.append(g)
        x = torch.cat([x, g], dim=-1)
        c_in = nn.dense(model.conv_dense[k], x, nn.ACTIVATION_TANH)
        c, mem = nn.conv1d_dilated(model.conv[k], state.conv[k], c_in,
                                   _ENC_CONV_DIL[k], nn.ACTIVATION_TANH)
        convs.append(mem)
        x = torch.cat([x, c], dim=-1)
    latents = nn.dense(model.zdense, x, nn.ACTIVATION_LINEAR)
    hidden = nn.dense(model.gdense1, x, nn.ACTIVATION_TANH)
    initial_state = nn.dense(model.gdense2, hidden, nn.ACTIVATION_LINEAR)
    return (RDOVAEEncState(tuple(grus), tuple(convs)),
            latents[..., :DRED_LATENT_DIM],
            initial_state[..., :DRED_STATE_DIM])


def dec_init_state(model: RDOVAEDec, initial_state) -> RDOVAEDecState:
    """(reference: dred_rdovae_dec_init_states dred_rdovae_dec.c:61)"""
    hidden = nn.dense(model.hidden_init, initial_state, nn.ACTIVATION_TANH)
    init = nn.dense(model.gru_init, hidden, nn.ACTIVATION_TANH)
    batch = tuple(initial_state.shape[:-1])
    return RDOVAEDecState(
        gru=tuple(init[..., 64 * k:64 * (k + 1)] for k in range(5)),
        conv=tuple(torch.zeros(batch + (32,), device=init.device)
                   for _ in range(5)))


def decode_qframe(model: RDOVAEDec, state: RDOVAEDecState, latent_in):
    """One latent -> 4 feature frames, newest first (reference:
    dred_rdovae_decode_qframe dred_rdovae_dec.c:88).  latent_in: [..., 81]
    (latent + q-level scalar).  Returns (new_state, qframe [..., 80])."""
    x = nn.dense(model.dense1, latent_in, nn.ACTIVATION_TANH)
    grus, convs = [], []
    for k in range(5):
        g = nn.gru(model.gru_input[k], model.gru_recurrent[k], state.gru[k],
                   x)
        grus.append(g)
        x = torch.cat([x, nn.glu(model.glu[k], g)], dim=-1)
        c_in = nn.dense(model.conv_dense[k], x, nn.ACTIVATION_TANH)
        c, mem = nn.conv1d(model.conv[k], state.conv[k], c_in,
                           nn.ACTIVATION_TANH)
        convs.append(mem)
        x = torch.cat([x, c], dim=-1)
    qframe = nn.dense(model.output, x, nn.ACTIVATION_LINEAR)
    return RDOVAEDecState(tuple(grus), tuple(convs)), qframe


def decode_all(model: RDOVAEDec, initial_state, latents) -> torch.Tensor:
    """Latent vectors -> 10 ms feature frames (reference:
    DRED_rdovae_decode_all dred_rdovae_dec.c:45).  DRED time runs newest
    first: latents [T, 81] with latents[0] the most recent chunk.  Returns
    [4*T, 20], row f the frame f*10 ms before the newest point."""
    state = dec_init_state(model, initial_state)
    qframes = []
    for z in latents:
        state, q = decode_qframe(model, state, z)
        qframes.append(q)
    return torch.stack(qframes).reshape(-1, DRED_NUM_FEATURES)


def _rand_linear(rng, m, n, bias=True, *, device):
    w = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    return nn.np_linear(w, b, device=device)


def random_enc_model(seed=0, *, device) -> RDOVAEEnc:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_enc_model(seed)``."""
    r = np.random.default_rng(seed)

    def rl(m, n, bias=True):
        return _rand_linear(r, m, n, bias, device=device)
    return RDOVAEEnc(
        dense1=rl(2 * DRED_NUM_FEATURES, 64),
        gru_input=tuple(rl(i, 96) for i in _ENC_GRU_IN),
        gru_recurrent=tuple(rl(32, 96) for _ in range(5)),
        conv_dense=tuple(rl(i, 64) for i in _ENC_CONV_DENSE_IN),
        conv=tuple(rl(128, 64) for _ in range(5)),
        zdense=rl(544, DRED_LATENT_DIM),
        gdense1=rl(544, 128),
        gdense2=rl(128, DRED_STATE_DIM))


def random_dec_model(seed=1, *, device) -> RDOVAEDec:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_dec_model(seed)``."""
    r = np.random.default_rng(seed)

    def rl(m, n, bias=True):
        return _rand_linear(r, m, n, bias, device=device)
    return RDOVAEDec(
        dense1=rl(DRED_LATENT_DIM + 1, 96),
        gru_input=tuple(rl(i, 192) for i in _DEC_GRU_IN),
        gru_recurrent=tuple(rl(64, 192) for _ in range(5)),
        glu=tuple(rl(64, 64, bias=False) for _ in range(5)),
        conv_dense=tuple(rl(i, 32) for i in _DEC_CONV_DENSE_IN),
        conv=tuple(rl(64, 32) for _ in range(5)),
        output=rl(576, 4 * DRED_NUM_FEATURES),
        hidden_init=rl(DRED_STATE_DIM, 128),
        gru_init=rl(128, 320))


def _lin(arrays, name, m, n, bias=True, *, device):
    return linear_params(arrays, float_weights=f"{name}_weights_float",
                         bias=f"{name}_bias" if bias else None,
                         nb_inputs=m, nb_outputs=n, device=device)


def enc_model_from_arrays(arrays, *, device) -> RDOVAEEnc:
    """From a parsed weight blob (array names per dnn/torch/weight-exchange
    c_export and export_rdovae_weights.py)."""
    def lin(name, m, n):
        return _lin(arrays, name, m, n, device=device)
    return RDOVAEEnc(
        dense1=lin("enc_dense1", 2 * DRED_NUM_FEATURES, 64),
        gru_input=tuple(lin(f"enc_gru{k+1}_input", _ENC_GRU_IN[k], 96)
                        for k in range(5)),
        gru_recurrent=tuple(lin(f"enc_gru{k+1}_recurrent", 32, 96)
                            for k in range(5)),
        conv_dense=tuple(lin(f"enc_conv_dense{k+1}", _ENC_CONV_DENSE_IN[k],
                             64) for k in range(5)),
        conv=tuple(lin(f"enc_conv{k+1}", 128, 64) for k in range(5)),
        zdense=lin("enc_zdense", 544, DRED_LATENT_DIM),
        gdense1=lin("gdense1", 544, 128),
        gdense2=lin("gdense2", 128, DRED_STATE_DIM))


def dec_model_from_arrays(arrays, *, device) -> RDOVAEDec:
    def lin(name, m, n, bias=True):
        return _lin(arrays, name, m, n, bias, device=device)
    return RDOVAEDec(
        dense1=lin("dec_dense1", DRED_LATENT_DIM + 1, 96),
        gru_input=tuple(lin(f"dec_gru{k+1}_input", _DEC_GRU_IN[k], 192)
                        for k in range(5)),
        gru_recurrent=tuple(lin(f"dec_gru{k+1}_recurrent", 64, 192)
                            for k in range(5)),
        glu=tuple(lin(f"dec_glu{k+1}", 64, 64, bias=False)
                  for k in range(5)),
        conv_dense=tuple(lin(f"dec_conv_dense{k+1}", _DEC_CONV_DENSE_IN[k],
                             32) for k in range(5)),
        conv=tuple(lin(f"dec_conv{k+1}", 64, 32) for k in range(5)),
        output=lin("dec_output", 576, 4 * DRED_NUM_FEATURES),
        hidden_init=lin("dec_hidden_init", DRED_STATE_DIM, 128),
        gru_init=lin("dec_gru_init", 128, 320))


def model_to_arrays(enc: RDOVAEEnc = None,
                    dec: RDOVAEDec = None) -> list[WeightArray]:
    """The models as blob arrays (the inverse of ``*_from_arrays``, in
    write_lpcnet_weights.c's layout)."""
    out = []

    def put(name, lin):
        out.extend(linear_to_arrays(name, lin))

    if enc is not None:
        put("enc_dense1", enc.dense1)
        for k in range(5):
            put(f"enc_gru{k+1}_input", enc.gru_input[k])
            put(f"enc_gru{k+1}_recurrent", enc.gru_recurrent[k])
            put(f"enc_conv_dense{k+1}", enc.conv_dense[k])
            put(f"enc_conv{k+1}", enc.conv[k])
        put("enc_zdense", enc.zdense)
        put("gdense1", enc.gdense1)
        put("gdense2", enc.gdense2)
    if dec is not None:
        put("dec_dense1", dec.dense1)
        for k in range(5):
            put(f"dec_gru{k+1}_input", dec.gru_input[k])
            put(f"dec_gru{k+1}_recurrent", dec.gru_recurrent[k])
            put(f"dec_glu{k+1}", dec.glu[k])
            put(f"dec_conv_dense{k+1}", dec.conv_dense[k])
            put(f"dec_conv{k+1}", dec.conv[k])
        put("dec_output", dec.output)
        put("dec_hidden_init", dec.hidden_init)
        put("dec_gru_init", dec.gru_init)
    return out
