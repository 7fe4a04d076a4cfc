"""Batched neural loss recovery: DRED payloads -> RDOVAE feature decode ->
FARGAN continuation + synthesis for a whole stream batch (tracked
config 5).  Port of ``opus_tpu/models/dnn_recovery.py``.

The cheap per-packet range decode stays on the host (bytes -> quantized
latents, dnn/dred_decoder.c:53, ``parse_batch``); the heavy part runs on
one device over the stream batch (reference: opus_dred_parse/process
src/opus_decoder.c:1551/1588 feeding the deep-PLC + FARGAN stack,
src/opus_decoder.c:735-760 and dnn/fargan.c:142/200):

    state0   [B, 24]      RDOVAE initial-state vectors
    latents  [T, B, 81]   newest-first latent chunks (+ q-level scalar)
    pcm0     [B, 320]     last 20 ms of in-order decoded output
    cont_idx [B, 5]       feature rows priming the vocoder, oldest first
    play_idx [B, F]       feature rows to synthesize, in playback order
      -> pcm [B, F*160]   concealment waveform at 16 kHz

The products are ``torch.matmul`` (no TPU kernel lies on this path); the
FARGAN de-emphasis is kernel K2 on the card.  Rows < 0 select a zero
feature vector, the analogue of fec_add(None) when the DRED window
undershoots the loss.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..dnn import dred, fargan as fg, rdovae
from ..dnn.dred_dec import dred_find_payload
from ..dnn.nnet import to_device
from .batched_dnn import fargan_synthesize_frames, rdovae_decode_frames


class ParsedBatch(NamedTuple):
    state0: np.ndarray        # [B, 24]
    latents: np.ndarray       # [T, B, 81] newest first, zero padded
    nb_latents: np.ndarray    # [B] int32  valid chunks per stream
    dred_offset: np.ndarray   # [B] int32  (dred_decode offsets)
    has_dred: np.ndarray      # [B] bool


def parse_batch(stats: dred.DREDStats, packets: List[Optional[bytes]],
                max_dred_samples: int, fs: int) -> ParsedBatch:
    """Host stage: range-decodes every stream's DRED extension payload and
    stacks the results zero-padded to the widest latent window.  A packet
    of None, or one without a DRED payload, gives a stream with no DRED."""
    b = len(packets)
    decs = []
    for data in packets:
        found = dred_find_payload(data) if data is not None else None
        if found is None:
            decs.append(None)
            continue
        payload, frame_offset = found
        res = dred.dred_decode(stats, payload,
                               max_dred_samples * 400 // fs // 4,
                               frame_offset)
        decs.append(res if res.nb_latents else None)
    tmax = max([d.nb_latents for d in decs if d is not None], default=1)
    state0 = np.zeros((b, rdovae.DRED_STATE_DIM), np.float32)
    lat = np.zeros((tmax, b, rdovae.DRED_LATENT_DIM + 1), np.float32)
    nb = np.zeros(b, np.int32)
    offs = np.zeros(b, np.int32)
    has = np.zeros(b, bool)
    for i, d in enumerate(decs):
        if d is None:
            continue
        state0[i] = d.state
        lat[:d.nb_latents, i] = d.latents
        nb[i] = d.nb_latents
        offs[i] = d.dred_offset
        has[i] = True
    return ParsedBatch(state0, lat, nb, offs, has)


def playback_rows(parsed: ParsedBatch, loss_offset_frames: np.ndarray,
                  n_frames: int):
    """The feature-row schedule of feed_dred_fec (src/opus_decoder.c:752):
    row r holds the features r*10 ms before the newest DRED point.  With
    the loss starting loss_offset_frames*10 ms past the anchor,
    concealment frame t (forward in time) reads row base - 2 - t, with
    base = floor(loss_offset_frames + dred_offset / 4); the 5 fargan_cont
    priming rows (oldest first) are base - 2 + (5 - j).  Rows outside
    [0, 4*nb_latents) are -1 (zero features).  Returns (cont [B, 5],
    play [B, n_frames]) int32."""
    b = len(parsed.nb_latents)
    play = np.full((b, n_frames), -1, np.int32)
    cont = np.full((b, 5), -1, np.int32)
    for i in range(b):
        if not parsed.has_dred[i]:
            continue
        hi = 4 * int(parsed.nb_latents[i]) - 1
        base = int(np.floor(float(loss_offset_frames[i])
                            + float(parsed.dred_offset[i]) / 4.0))
        for t in range(n_frames):
            r = base - 2 - t
            play[i, t] = r if 0 <= r <= hi else -1
        for j in range(5):
            r = base - 2 + (5 - j)
            cont[i, j] = r if 0 <= r <= hi else -1
    return cont, play


class BatchedDREDRecovery:
    """DRED recovery for a stream batch on one device (the default: the
    card; ``device="cpu"`` for the plain CPU run): RDOVAE decode over the
    latent chunks, FARGAN priming on the last good 20 ms, then the
    concealment synthesis."""

    def __init__(self, dec_model: rdovae.RDOVAEDec, stats: dred.DREDStats,
                 fargan_model: fg.FARGANModel, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedDREDRecovery: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.dec_model = to_device(dec_model, self.device)
        self.stats = stats
        self.fargan = to_device(fargan_model, self.device)

    def _pipeline(self, state0, latents, pcm0, cont_idx, play_idx):
        """The device stage on tensors of this recovery's device (shapes in
        the module docstring).  Returns pcm [B, F*160]."""
        _, qframes = rdovae_decode_frames(self.dec_model, state0, latents)
        t, b = qframes.shape[0], qframes.shape[1]
        feats = qframes.transpose(0, 1).reshape(b, 4 * t,
                                                rdovae.DRED_NUM_FEATURES)
        # row -1 -> the appended zero row (fec_add(None)); remainder, not
        # fmod, so that -1 wraps to the last row
        feats = torch.cat([feats, feats.new_zeros(
            (b, 1, rdovae.DRED_NUM_FEATURES))], dim=1)

        def rows(idx):
            idx = torch.remainder(idx.to(torch.int64), 4 * t + 1)
            return torch.gather(feats, 1, idx[..., None].expand(
                -1, -1, rdovae.DRED_NUM_FEATURES))

        fstate = fg.init_state(b, device=feats.device)
        fstate = fg.cont(self.fargan, fstate, pcm0, rows(cont_idx))
        _, pcm = fargan_synthesize_frames(self.fargan, fstate,
                                          rows(play_idx).transpose(0, 1))
        return pcm.transpose(0, 1).reshape(b, -1)

    def recover(self, parsed: ParsedBatch, pcm0, loss_offset_frames,
                n_frames: int) -> torch.Tensor:
        """pcm0: [B, 320] last good output (float, 16 kHz).  Returns
        [B, n_frames*160] concealment PCM on this recovery's device."""
        cont_idx, play_idx = playback_rows(parsed, loss_offset_frames,
                                           n_frames)
        dev = self.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        b = len(parsed.nb_latents)
        return self._pipeline(t(parsed.state0), t(parsed.latents),
                             t(pcm0).reshape(b, -1),
                             t(cont_idx, torch.int64),
                             t(play_idx, torch.int64))
