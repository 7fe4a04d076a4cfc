"""DRED payload coding for the port: copies of ``opus_tpu/dnn/dred.py``
(constants, ``DREDStats``, ``random_stats``, ``compute_quantizer``, the
decoder ``dred_decode`` and the encoder ``dred_encode``), the range coding
numpy on the host; the encoder's quantizer, ``quantize_latents``, runs on
the latents' device over a whole stream batch (reference:
dnn/dred_coding.c, dnn/dred_encoder.c:241-384, dnn/dred_decoder.c; the
payload rides extension id 126, dnn/dred_config.h:32).

A DRED payload codes the RDOVAE decoder's initial state plus every other
latent (40 ms hop), newest first, on a rate ladder: chunk i uses
quantizer level q0 + dQ_table[dQ]*i/16 clamped to qmax, each (level, dim)
with its own scale / decay / p0 statistics driving a Laplace coder.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bitstream.laplace import laplace_decode_p0, laplace_encode_p0
from ..bitstream.range_coder import RangeDecoder, RangeEncoder
from .nnet import tanh_approx
from .rdovae import DRED_LATENT_DIM, DRED_MAX_LATENTS, \
    DRED_NUM_REDUNDANCY_FRAMES, DRED_STATE_DIM

DRED_EXTENSION_ID = 126            # (dred_config.h:32)
DRED_EXPERIMENTAL_VERSION = 12     # (dred_config.h:35)
DRED_MIN_BYTES = 8
DRED_MAX_DATA_SIZE = 1000
DRED_ENC_Q0 = 6
DRED_ENC_Q1 = 15
DRED_NUM_QUANTIZATION_LEVELS = 16
DRED_MAX_FRAMES = 4 * DRED_MAX_LATENTS

# (reference: dQ_table dnn/dred_coding.c:41)
_DQ_TABLE = (0, 2, 3, 4, 6, 8, 12, 16)


def compute_quantizer(q0: int, dq: int, qmax: int, i: int) -> int:
    """(reference: compute_quantizer dnn/dred_coding.c:39)"""
    quant = q0 + (_DQ_TABLE[dq] * i + 8) // 16
    return qmax if quant > qmax else quant


class DREDStats(NamedTuple):
    """Per-(level, dim) Q8 coding statistics (reference:
    dnn/torch/rdovae/export_rdovae_weights.py dump_statistical_model;
    shipped as dred_rdovae_stats_data.c)."""
    latent_scale: np.ndarray       # [16, LATENT] uint8
    latent_dead_zone: np.ndarray
    latent_r: np.ndarray
    latent_p0: np.ndarray
    state_scale: np.ndarray        # [16, STATE] uint8
    state_dead_zone: np.ndarray
    state_r: np.ndarray
    state_p0: np.ndarray


def random_stats(seed=0) -> DREDStats:
    """Plausible random statistics for structural tests (real tables
    ship with the model file)."""
    r = np.random.default_rng(seed)

    def tab(dim):
        scale = r.integers(40, 255, (16, dim)).astype(np.uint8)
        dz = r.integers(0, 60, (16, dim)).astype(np.uint8)
        decay = r.integers(30, 250, (16, dim)).astype(np.uint8)
        p0 = r.integers(10, 240, (16, dim)).astype(np.uint8)
        return scale, dz, decay, p0

    ls, ld, lr, lp = tab(DRED_LATENT_DIM)
    ss, sd, sr, sp = tab(DRED_STATE_DIM)
    return DREDStats(ls, ld, lr, lp, ss, sd, sr, sp)


def quantize_latents(x, scale, dzone):
    """Dead-zone quantization (reference: dred_encode_latents
    dnn/dred_encoder.c:241-263; the approximate tanh) on ``x``'s device,
    every step in float32 in the order of the JAX package's
    ``quantize_latents`` (``opus_tpu/dnn/dred.py:77``).  x: [..., D];
    scale, dzone: the uint8 tables' rows as tensors broadcast against x.
    Returns (q int32, the value before rounding float32): q =
    floor(0.5 + v)."""
    x = x.to(torch.float32)
    delta = dzone.to(torch.float32) / 256.0
    xq = x * scale.to(torch.float32) / 256.0
    dead = tanh_approx(xq / (delta + 0.1))
    v = xq - delta * dead
    return torch.floor(0.5 + v).to(torch.int32), v


def _voice_active(activity, offset: int) -> bool:
    """(reference: dred_voice_active dnn/dred_encoder.c:271)"""
    lo = 8 * offset
    return bool(activity[lo:min(lo + 16, 4 * DRED_MAX_FRAMES)].any())


def latent_skip(activity: np.ndarray, nb_latents: int) -> np.ndarray:
    """Per lane, the latent offset at which ``dred_encode`` starts: the
    first whose 40 ms window holds voice activity, at most nb_latents - 1
    (the skip loop of ``opus_tpu/dnn/dred.py:128-131``).  activity:
    [B, 4 * DRED_MAX_FRAMES] per-2.5 ms flags, newest first.  Returns [B]
    int64."""
    activity = np.asarray(activity)
    lo = np.full(activity.shape[0], max(nb_latents - 1, 0), np.int64)
    for off in reversed(range(nb_latents - 1)):
        a = 8 * off
        active = activity[:, a:min(a + 16, 4 * DRED_MAX_FRAMES)].any(axis=1)
        lo = np.where(active, off, lo)
    return lo


def _encode_symbols(enc: RangeEncoder, q, r, p0):
    """(reference: dred_encode_latents dnn/dred_encoder.c:255) on
    quantized ints."""
    for qi, ri, pi in zip(q.tolist(), r.tolist(), p0.tolist()):
        if ri == 0 or pi == 255:
            continue    # impossible symbol: coded as implicit zero
        laplace_encode_p0(enc, qi, pi << 7, ri << 7)


def dred_encode(stats: DREDStats, q_state: np.ndarray, q_latents: np.ndarray,
                nb_latents: int, dred_offset: int, activity: np.ndarray,
                latent_offset: int, *, q0: int = DRED_ENC_Q0, dq: int = 3,
                qmax: int = DRED_ENC_Q1, max_chunks: int = DRED_MAX_LATENTS,
                max_bytes: int = DRED_MAX_DATA_SIZE):
    """Encode one stream's DRED payload (reference: dred_encode_silk_frame
    dnn/dred_encoder.c:280) from integers ``quantize_latents`` gave: the
    range coding of ``opus_tpu/dnn/dred.py:110`` line for line.

    q_state: [STATE] the state at ``latent_offset`` at level q0;
    q_latents: [>= chunks, LATENT], chunk c the latent 2c + latent_offset
    at level ``compute_quantizer(q0, dq, qmax, c)``; activity: the
    stream's [DRED_MAX_FRAMES * 4] voice activity flags; latent_offset:
    ``latent_skip``'s.  Returns (payload bytes or None, the number of
    latent chunks the payload codes)."""
    activity = np.asarray(activity)
    extra_dred_offset = latent_offset
    enc = RangeEncoder(max_bytes)
    enc.enc_uint(q0, 16)
    enc.enc_uint(dq, 8)
    total_offset = 16 - (dred_offset - extra_dred_offset * 8)
    assert total_offset >= 0
    if total_offset > 31:
        enc.enc_uint(1, 2)
        enc.enc_uint(total_offset >> 5, 256)
        enc.enc_uint(total_offset & 31, 32)
    else:
        enc.enc_uint(0, 2)
        enc.enc_uint(total_offset, 32)
    assert qmax >= q0
    if q0 < 14 and dq > 0:
        # qmax symbol: 0 => qmax==15, else uniform over (q0, 15)
        assert qmax > q0
        nvals = 15 - (q0 + 1)
        if qmax >= 15:
            enc.encode(0, nvals, 2 * nvals)
        else:
            enc.encode(nvals + qmax - (q0 + 1), nvals + qmax - q0,
                       2 * nvals)
    _encode_symbols(enc, np.asarray(q_state), stats.state_r[q0],
                    stats.state_p0[q0])
    if enc.tell() > 8 * max_bytes:
        return None, 0
    bak = enc.save_state()
    dred_encoded = 0
    prev_active = False
    for i in range(0, min(2 * max_chunks, nb_latents - latent_offset), 2):
        q_level = compute_quantizer(q0, dq, qmax, i // 2)
        _encode_symbols(enc, np.asarray(q_latents[i // 2]),
                        stats.latent_r[q_level], stats.latent_p0[q_level])
        if enc.tell() > 8 * max_bytes:
            if i == 0:
                return None, 0
            break
        active = _voice_active(activity, i + latent_offset)
        if active or prev_active:
            bak = enc.save_state()
            dred_encoded = i + 2
        prev_active = active
    if dred_encoded == 0 or (dred_encoded <= 2 and extra_dred_offset):
        return None, 0
    enc.restore_state(bak)
    nbytes = (enc.tell() + 7) // 8
    enc.shrink(nbytes)
    enc.done()
    return bytes(enc.data()[:nbytes]), dred_encoded // 2


def _decode_latents(dec: RangeDecoder, scale, r, p0, dim) -> np.ndarray:
    """(reference: dred_decode_latents dnn/dred_decoder.c:43)"""
    x = np.zeros(dim, np.float32)
    for i in range(dim):
        if r[i] == 0 or p0[i] == 255:
            q = 0
        else:
            q = laplace_decode_p0(dec, int(p0[i]) << 7, int(r[i]) << 7)
        s = int(scale[i])
        x[i] = q * 256.0 / (1 if s == 0 else s)
    return x


class DREDDecoded(NamedTuple):
    dred_offset: int
    nb_latents: int
    state: np.ndarray              # [STATE]
    latents: np.ndarray            # [nb, LATENT+1] newest first


def dred_decode(stats: DREDStats, payload: bytes,
                max_dred_features: int,
                dred_frame_offset: int = 0) -> DREDDecoded:
    """(reference: dred_ec_decode dnn/dred_decoder.c:53)"""
    dec = RangeDecoder(payload)
    q0 = dec.dec_uint(16)
    dq = dec.dec_uint(8)
    extra_offset = 32 * dec.dec_uint(256) if dec.dec_uint(2) else 0
    dred_offset = 16 - dec.dec_uint(32) - extra_offset \
        + dred_frame_offset
    min_feature_frames = max(0, (4 * max_dred_features
                                 + dred_offset + 3) // 4)
    qmax = 15
    if q0 < 14 and dq > 0:
        nvals = 15 - (q0 + 1)
        ft = 2 * nvals
        s = dec.decode(ft)
        if s >= nvals:
            qmax = q0 + (s - nvals) + 1
            dec.update(s, s + 1, ft)
        else:
            dec.update(0, nvals, ft)
    state = _decode_latents(dec, stats.state_scale[q0],
                            stats.state_r[q0], stats.state_p0[q0],
                            DRED_STATE_DIM)
    out = []
    num_bytes = len(payload)
    i = 0
    while i < min(DRED_NUM_REDUNDANCY_FRAMES,
                  (min_feature_frames + 1) // 2):
        if 8 * num_bytes - dec.tell() <= 7:
            break
        q_level = compute_quantizer(q0, dq, qmax, i // 2)
        lat = _decode_latents(dec, stats.latent_scale[q_level],
                              stats.latent_r[q_level],
                              stats.latent_p0[q_level], DRED_LATENT_DIM)
        out.append(np.concatenate(
            [lat, [q_level * 0.125 - 1.0]]).astype(np.float32))
        i += 2
    latents = np.stack(out) if out else \
        np.zeros((0, DRED_LATENT_DIM + 1), np.float32)
    return DREDDecoded(dred_offset, len(out), state, latents)
