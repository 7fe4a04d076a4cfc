"""DRED payload decoding for the port: copies of the decoder side of
``opus_tpu/dnn/dred.py`` (constants, ``DREDStats``, ``random_stats``,
``compute_quantizer``, ``_decode_latents``, ``dred_decode``), numpy on the
host (reference: dnn/dred_coding.c, dnn/dred_decoder.c; the payload rides
extension id 126, dnn/dred_config.h:32).

A DRED payload codes the RDOVAE decoder's initial state plus every other
latent (40 ms hop), newest first, on a rate ladder: chunk i uses
quantizer level q0 + dQ_table[dQ]*i/16 clamped to qmax, each (level, dim)
with its own scale / decay / p0 statistics driving a Laplace coder.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..bitstream.laplace import laplace_decode_p0
from ..bitstream.range_coder import RangeDecoder
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
