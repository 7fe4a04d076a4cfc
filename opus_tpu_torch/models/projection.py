"""The projection (ambisonics, mapping family 3) Opus decoder over B lanes:
a port of ``opus_tpu/models/projection.py`` (``order_plus_one_from_channels``,
``streams_from_channels`` :27-45, ``OpusProjectionDecoder`` :103-136;
reference: src/opus_projection_decoder.c, src/mapping_matrix.c).

The internal channels (2 x coupled + uncoupled streams) come from a
``BatchedOpusMSDecoder`` with the identity mapping, then the demixing
matrix mixes them into the output channels.  The matrix arrives as the
stream header's bytes: little-endian int16, column-major [channels x
internal] (Q15).  The float path is one product of [B, W, internal] by
[internal, channels] (the JAX package computes it in numpy, outside any
Pallas kernel).  The int16 path is the reference's integer demix, bit for
bit: the internal channels quantised to int16 first, then each output
sample the sum over the internal channels of (x * m + 16384) >> 15, in
int64, wrapped to int16 as numpy's cast wraps it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .multistream import BatchedOpusMSDecoder


def order_plus_one_from_channels(channels: int) -> int:
    """(reference: get_order_plus_one_from_channels
    opus_projection_encoder.c:92)"""
    if channels < 1 or channels > 227:
        raise ValueError("bad channel count")
    opo = int(math.isqrt(channels))
    nondiegetic = channels - opo * opo
    if nondiegetic not in (0, 2):
        raise ValueError("bad ambisonics channel count")
    return opo


def streams_from_channels(channels: int):
    """(reference: get_streams_from_channels, family 3)"""
    order_plus_one_from_channels(channels)
    return (channels + 1) // 2, channels // 2


def demixing_from_bytes(blob: bytes, channels: int,
                        internal: int) -> np.ndarray:
    """The header's matrix -> int64 [channels, internal] Q15."""
    want = channels * internal * 2
    if len(blob) != want:
        raise ValueError(f"demixing matrix must be {want} bytes")
    return np.frombuffer(blob, dtype="<i2").astype(np.int64).reshape(
        internal, channels).T.copy()


class BatchedOpusProjectionDecoder:
    """B projection streams of one layout decoded to ``channels`` output
    channels at ``fs`` (the card by default, ``device="cpu"`` for the
    plain versions).  ``decode(packets)`` -> (pcm float32 [B, W,
    channels], n [B]); ``decode_int16`` the integer demix; ``ms``: the
    multistream decoder of the internal channels (its ``status``,
    ``final_range``, ``set_state``)."""

    def __init__(self, batch: int, fs: int, channels: int, streams: int,
                 coupled_streams: int, demixing_matrix: bytes,
                 device="cuda", max_payload: int = 1275):
        self.internal = 2 * coupled_streams + (streams - coupled_streams)
        self.channels = channels
        m = demixing_from_bytes(demixing_matrix, channels, self.internal)
        self.ms = BatchedOpusMSDecoder(batch, fs, self.internal, streams,
                                       coupled_streams,
                                       list(range(self.internal)), device,
                                       max_payload)
        dev = self.ms.device
        self.demix_q15 = torch.as_tensor(m, device=dev)
        # [internal, channels]: the float product's right side
        self.demix = torch.as_tensor((m.T / 32768.0).astype(np.float32),
                                     device=dev)

    def decode(self, packets):
        """(projection.py:119-122)"""
        x, n = self.ms.decode(packets)
        return torch.matmul(x, self.demix), n

    def decode_int16(self, packets):
        """The integer demix (projection.py:124-136)."""
        from ..utils.soft_clip import float2int16_lanes
        x, n = self.ms.decode(packets)
        return self.demix_int16(float2int16_lanes(x)), n

    def demix_int16(self, x16):
        """x16 [B, W, internal] int16 -> [B, W, channels] int16:
        sum_k ((x_k * m_ck + 16384) >> 15), wrapped to int16."""
        x = x16.to(torch.int64)[:, :, None, :]
        y = ((x * self.demix_q15 + 16384) >> 15).sum(dim=3)
        return (((y + 32768) & 0xFFFF) - 32768).to(torch.int16)
