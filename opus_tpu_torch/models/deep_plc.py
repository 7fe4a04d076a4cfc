"""Batched deep PLC with DRED (tracked config 5's concealment half): the
counterpart of ``OpusDecoder.load_deep_plc`` + ``OpusDecoder.dred_decode``
(``opus_tpu/models/opus_decoder.py:76-114``; reference:
opus_decoder_dred_decode src/opus_decoder.c:1611).

``BatchedDeepPLC`` holds one B-lane ``LPCNetPLC`` and, at 48 kHz, the
16 -> 48 kHz upsampler state.  ``dred_decode`` queues each lane's DRED
features as FEC, conceals frame_size // (fs / 100) frames of 10 ms (the
LPCNet feature analysis, the pitch DNN, the PLC network and FARGAN, whose
de-emphasis is kernel K2 on the card) and returns int16 PCM at 16 or
48 kHz.  The 48 kHz output goes through ``silk/resampler.upsample_to_48k``
in 10 ms pieces with the state carried, bit-exact with the JAX decoder's
``Resampler(16000, 48000).process`` on each 160-sample piece.  The
down-sampling rates (8, 12 and 24 kHz) are not ported.
"""

from __future__ import annotations

import torch

from ..dnn import fargan as fg, pitchdnn as pdnn, plc as plcmod
from ..dnn.dred_dec import DREDBatch, feed_dred_fec
from ..silk.resampler import upsample_to_48k, upsampler_init

RATES = (16000, 48000)


class BatchedDeepPLC:
    """Deep PLC of B mono streams at fs (16 or 48 kHz) on one device: the
    card by default, ``device="cpu"`` for the plain CPU run."""

    def __init__(self, plc_model: plcmod.PLCModel,
                 pitch_model: pdnn.PitchDNNModel,
                 fargan_model: fg.FARGANModel, batch: int, fs: int = 48000,
                 device="cuda"):
        if fs not in RATES:
            raise ValueError(f"BatchedDeepPLC: fs {fs} (only 16000 and "
                             f"48000: the down-sampling resampler is not "
                             f"ported)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedDeepPLC: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.fs = fs
        self.lpcnet = plcmod.LPCNetPLC(plc_model, pitch_model, fargan_model,
                                       batch, device=self.device)
        self.rs = upsampler_init(batch, 16, self.device) \
            if fs != 16000 else None

    def dred_decode(self, dreds: DREDBatch, dred_offset,
                    frame_size: int) -> torch.Tensor:
        """Concealment audio from processed DRED (reference:
        opus_decoder_dred_decode src/opus_decoder.c:1611).  dred_offset:
        [B] samples at fs.  Returns int16 [B, frame_size] on the device."""
        if frame_size <= 0:
            raise ValueError("bad frame size")
        f10 = self.fs // 100
        feed_dred_fec(self.lpcnet, dreds, dred_offset, self.fs, frame_size)
        pieces = []
        for _ in range(max(1, frame_size // f10)):
            out16 = self.lpcnet.conceal()
            if self.rs is not None:
                up, self.rs = upsample_to_48k(out16, self.rs, 16, frame_ms=10)
                out16 = up.to(torch.int16)
            pieces.append(out16)
        return torch.cat(pieces, dim=1)[:, :frame_size]
