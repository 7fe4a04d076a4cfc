"""The DRED side of an Opus encoder for a batch of streams: the port's
counterpart of ``OpusEncoder``'s DRED hooks (``opus_tpu/models/
opus_encoder.py``: ``enable_dred`` :326, the latent step before SILK
:850-856, ``_attach_dred`` :342-378; reference: src/opus_encoder.c
:2028-2041 and :2604-2644).

Tracked config 5's encode half: ``step`` runs every frame on the PCM the
codec encodes (``BatchedDREDEnc.compute_latents`` on the device, the
per-lane voice activity history on the host); ``attach`` builds each
lane's DRED payload and carries it in the packet's padding as extension
126, with the ``'D', 12`` experimental prefix, through the repacketizer.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..bitstream.extensions import ExtensionData
from ..bitstream.repacketizer import Repacketizer
from ..dnn import dred
from ..dnn.dred_dec import DRED_EXPERIMENTAL_BYTES
from ..dnn.dred_enc import BatchedDREDEnc


class BatchedDREDEncoder:
    """DRED for B streams in lockstep (one rate, channel count and frame
    size) on one device, the card by default (``device="cpu"`` for the
    plain CPU run).  ``duration_frames_10ms``: the redundancy window, 0 to
    104 (``OPUS_SET_DRED_DURATION``)."""

    def __init__(self, enc_model, pitch_model, stats: dred.DREDStats,
                 batch: int, fs: int = 48000, channels: int = 1,
                 duration_frames_10ms: int = 40, device="cuda"):
        if not 0 <= duration_frames_10ms <= 104:
            raise ValueError("bad DRED duration")
        self.dred = BatchedDREDEnc(fs, channels, enc_model, pitch_model,
                                   stats, batch, device=device)
        self.device = self.dred.device
        self.fs = fs
        self.channels = channels
        self.batch = batch
        self.duration = duration_frames_10ms
        self.activity_mem = np.zeros((batch, 4 * dred.DRED_MAX_FRAMES),
                                     np.uint8)

    def step(self, pcm, activity, extra_delay: int = 0):
        """One encoder frame (``opus_encoder.py:850-856``): the latents of
        pcm [B, N * channels] (float, [-1, 1]) and the voice activity
        [B] (0/1) pushed into each lane's history, ``N * 400 / fs`` 2.5 ms
        slots.  ``extra_delay``: the encoder's delay compensation in
        samples.  Returns the frame's 16 kHz samples [B, N * 16000 / fs]
        (float32, int16 scale), or None when the duration is 0."""
        if self.duration <= 0:
            return None
        frame_size = pcm.shape[1] // self.channels
        f400 = frame_size * 400 // self.fs
        x16 = self.dred.compute_latents(pcm, frame_size, extra_delay)
        act = np.asarray(activity, np.uint8).reshape(self.batch, 1)
        self.activity_mem = np.concatenate(
            [np.repeat(act, f400, axis=1), self.activity_mem[:, :-f400]],
            axis=1)
        return x16

    def attach(self, packets: List[bytes], max_data_bytes: int,
               bitrate: int, pad: bool = False) -> List[bytes]:
        """``_attach_dred`` for every lane: the DRED window and byte budget
        from the duration and each packet's length, q0 and dQ from the
        bitrate (reference: compute_dred_bitrate :710-712), the payloads
        (``BatchedDREDEnc.encode_payloads``) carried as extension 126 by
        ``Repacketizer.out_range`` (``pad``: fill to max_data_bytes, as a
        CBR encoder does).  A lane whose payload is None, or whose packet
        does not repacketize, keeps its packet."""
        dred_chunks = min((self.duration + 5) // 4,
                          dred.DRED_NUM_REDUNDANCY_FRAMES // 2)
        budgets = []
        for p in packets:
            left = min(dred.DRED_MAX_DATA_SIZE, max_data_bytes - len(p) - 3)
            left -= (left + 1 + DRED_EXPERIMENTAL_BYTES) // 255
            ok = dred_chunks >= 1 and \
                left >= dred.DRED_MIN_BYTES + DRED_EXPERIMENTAL_BYTES
            budgets.append(left - DRED_EXPERIMENTAL_BYTES if ok else None)
        rate_off = bitrate - 12000
        q0 = min(15, max(4, 51 - 3 * max(1, rate_off).bit_length()))
        dq = 3 if rate_off > 36000 else 5
        payloads, _chunks = self.dred.encode_payloads(
            self.activity_mem, dred_chunks, budgets, q0=q0, dq=dq)
        out = []
        for p, payload in zip(packets, payloads):
            if payload is None:
                out.append(p)
                continue
            ext = ExtensionData(
                id=dred.DRED_EXTENSION_ID, frame=0,
                data=bytes([ord('D'), dred.DRED_EXPERIMENTAL_VERSION])
                + payload)
            rp = Repacketizer()
            if rp.cat(p) != 0:
                out.append(p)
                continue
            res = rp.out_range(0, rp.nb_frames, max_data_bytes, pad=pad,
                               extensions=[ext])
            out.append(res if isinstance(res, bytes) else p)
        return out
