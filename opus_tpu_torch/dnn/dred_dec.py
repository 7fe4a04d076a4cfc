"""DRED decoder-side objects of the port: copies of ``opus_tpu/dnn/
dred_dec.py`` (reference: src/opus_decoder.c opus_dred_parse :1551 /
opus_dred_process :1588 / opus_decoder_dred_decode :1611,
dred_find_payload :1468).

Two-stage API: ``OpusDREDDecoder.parse`` range-decodes the extension-126
payload into latents on the host (cheap, per packet); ``process`` runs the
RDOVAE decoder into 10 ms feature frames on the decoder's device (deferred,
only when loss actually happens).  ``process_batch`` does the second stage
for a whole stream batch in one pass and returns a ``DREDBatch``, which
``feed_dred_fec`` queues into a B-lane deep-PLC instance as FEC.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..bitstream import packet as pkt
from ..bitstream.extensions import ExtensionData, ExtensionIterator
from ..ops.lanes import lane_mask
from . import dred, rdovae
from .nnet import to_device

DRED_EXPERIMENTAL_BYTES = 2     # (dred_config.h:36)


def dred_find_payload(data: bytes):
    """Returns (payload bytes, dred_frame_offset) or None (reference:
    dred_find_payload src/opus_decoder.c:1468)."""
    parsed = pkt.packet_parse(data)
    if isinstance(parsed, int):
        return None
    frame_size = pkt.packet_get_samples_per_frame(data, 48000)
    it = ExtensionIterator(parsed.padding, parsed.count)
    while True:
        ext = it.find(dred.DRED_EXTENSION_ID)
        if not isinstance(ext, ExtensionData):
            return None
        frame_offset = ext.frame * frame_size // 120
        if len(ext.data) > DRED_EXPERIMENTAL_BYTES \
                and ext.data[0] == ord('D') \
                and ext.data[1] == dred.DRED_EXPERIMENTAL_VERSION:
            return bytes(ext.data[2:]), frame_offset


class OpusDRED(NamedTuple):
    """(reference: OpusDRED struct, src/opus_private.h).  ``fec_features``
    is a [4 * nb_latents, 20] tensor, newest first, once processed."""
    process_stage: int
    dred_offset: int
    nb_latents: int
    state: np.ndarray
    latents: np.ndarray
    fec_features: Optional[torch.Tensor]


class DREDBatch(NamedTuple):
    """Processed DRED of B streams: ``fec_features`` [B, R, 20] on the
    device (row r the features r * 10 ms before the lane's newest point,
    rows at and past 4 * nb_latents unused), ``nb_latents`` and
    ``dred_offset`` [B] int host arrays.  A lane without DRED has
    nb_latents 0."""
    fec_features: torch.Tensor
    nb_latents: np.ndarray
    dred_offset: np.ndarray


class OpusDREDDecoder:
    """(reference: OpusDREDDecoder) the RDOVAE decoder model on a device
    (the card by default) and the coding statistics, numpy on the host."""

    def __init__(self, dec_model: rdovae.RDOVAEDec, stats: dred.DREDStats,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OpusDREDDecoder: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.model = to_device(dec_model, self.device)
        self.stats = stats

    def parse(self, data: bytes, max_dred_samples: int, fs: int,
              defer_processing: bool = True):
        """(reference: opus_dred_parse src/opus_decoder.c:1551).
        Returns (OpusDRED | None, dred_end_samples)."""
        found = dred_find_payload(data)
        if found is None:
            return None, 0
        payload, frame_offset = found
        res = dred.dred_decode(self.stats, payload,
                               max_dred_samples * 400 // fs // 4,
                               frame_offset)
        if res.nb_latents == 0:
            return None, 0
        out = OpusDRED(1, res.dred_offset, res.nb_latents, res.state,
                       res.latents, None)
        if not defer_processing:
            out = self.process(out)
        dred_end = max(0, -res.dred_offset * fs // 400)
        return out, dred_end

    def process(self, d: OpusDRED) -> OpusDRED:
        """(reference: opus_dred_process src/opus_decoder.c:1588)"""
        if d.process_stage == 2:
            return d
        feats = rdovae.decode_all(
            self.model, torch.as_tensor(d.state, device=self.device),
            torch.as_tensor(d.latents, device=self.device))
        return d._replace(process_stage=2, fec_features=feats)

    def process_batch(self, dreds: Sequence[Optional[OpusDRED]]) -> DREDBatch:
        """``process`` for B streams at once (None: a stream without DRED):
        one RDOVAE pass over the lanes, the latent chunks zero-padded to the
        widest window (a lane's rows past its own chunks are never read)."""
        b = len(dreds)
        t = max([d.nb_latents for d in dreds if d is not None], default=1)
        state0 = np.zeros((b, rdovae.DRED_STATE_DIM), np.float32)
        lat = np.zeros((t, b, rdovae.DRED_LATENT_DIM + 1), np.float32)
        nb = np.zeros(b, np.int64)
        offs = np.zeros(b, np.int64)
        for i, d in enumerate(dreds):
            if d is None:
                continue
            state0[i] = d.state
            lat[:d.nb_latents, i] = d.latents
            nb[i] = d.nb_latents
            offs[i] = d.dred_offset
        from ..models.batched_dnn import rdovae_decode_frames
        _, q = rdovae_decode_frames(
            self.model, torch.as_tensor(state0, device=self.device),
            torch.as_tensor(lat, device=self.device))
        feats = q.transpose(0, 1).reshape(b, 4 * t,
                                          rdovae.DRED_NUM_FEATURES)
        return DREDBatch(feats, nb, offs)


def feed_dred_fec(lpcnet, d: DREDBatch, dred_offset, fs: int,
                  frame_size, lanes=None):
    """Queues DRED features into a B-lane deep-PLC instance for the coming
    concealment call (reference: src/opus_decoder.c:735-760) on the lanes
    of ``lanes`` ([B] bool, default all; the other lanes' queues stay as
    they are), each lane at its own ``dred_offset`` and ``frame_size``
    (samples at fs, ints or [B] ints).  A lane queues two initial rows only
    if its own ``blend`` is 0; a feature row inside the lane's window is
    queued, an offset past it is a skip and a negative offset nothing."""
    b = lpcnet.batch
    dev = d.fec_features.device
    f10 = fs // 100
    m = lane_mask(lanes, b, dev)
    lpcnet.fec_clear(m)
    init = torch.where(lpcnet.blend == 0, 2, 0)
    fpf = np.maximum(1, np.broadcast_to(np.asarray(frame_size, np.int64),
                                        (b,)) // f10)
    base = np.floor((np.asarray(dred_offset, np.float64)
                     + d.dred_offset * f10 / 4) / f10).astype(np.int64)
    base = torch.as_tensor(np.broadcast_to(base, (b,)).copy(), device=dev)
    total = init + torch.as_tensor(fpf, device=dev)
    hi = torch.as_tensor(4 * np.asarray(d.nb_latents, np.int64) - 1,
                         device=dev)
    rows = d.fec_features.shape[1]
    for i in range(2 + int(fpf.max(initial=1))):
        offs = init - i - 2 + base
        present = (offs >= 0) & (offs <= hi)
        idx = torch.clamp(offs, 0, rows - 1)
        row = torch.gather(d.fec_features, 1, idx[:, None, None].expand(
            -1, 1, d.fec_features.shape[2]))[:, 0]
        lpcnet.fec_add(row, present, m & (i < total) & (offs >= 0))
