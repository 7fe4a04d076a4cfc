"""Batched deep PLC with DRED (tracked config 5's concealment half): the
counterpart of ``OpusDecoder.load_deep_plc`` + ``OpusDecoder.dred_decode``
(``opus_tpu/models/opus_decoder.py:76-114``; reference:
opus_decoder_dred_decode src/opus_decoder.c:1611).

``BatchedDeepPLC`` holds one B-lane ``LPCNetPLC`` and, at rates other than
16 kHz, the state of the decoder-direction ``Resampler(16000, fs)``.
``dred_decode`` queues each lane's DRED features as FEC, conceals each
lane's frame_size // (fs / 100) frames of 10 ms (the LPCNet feature
analysis, the pitch DNN, the PLC network and FARGAN, whose de-emphasis is
kernel K2 on the card) and returns int16 PCM at fs.  Every lane has its own
offset and frame size, and a lane mask limits the call to the streams that
resume after a loss; the other lanes' state stays as it was, bit for bit.
The output goes through the resampler in 10 ms pieces with the state
carried, bit-exact with the JAX decoder's ``Resampler(16000, fs).process``
on each 160-sample piece: ``silk/resampler.upsample_to_48k`` at 48 kHz,
``resample_16k`` at 8, 12 and 24 kHz.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dnn import fargan as fg, pitchdnn as pdnn, plc as plcmod
from ..dnn.dred_dec import DREDBatch, feed_dred_fec
from ..ops.lanes import lane_mask, select_lanes
from ..silk.resampler import (dec_resampler_init, resample_16k,
                              upsample_to_48k, upsampler_init)

RATES = (8000, 12000, 16000, 24000, 48000)


class BatchedDeepPLC:
    """Deep PLC of B mono streams at fs (8, 12, 16, 24 or 48 kHz) on one
    device: the card by default, ``device="cpu"`` for the plain CPU run."""

    def __init__(self, plc_model: plcmod.PLCModel,
                 pitch_model: pdnn.PitchDNNModel,
                 fargan_model: fg.FARGANModel, batch: int, fs: int = 48000,
                 device="cuda"):
        if fs not in RATES:
            raise ValueError(f"BatchedDeepPLC: fs {fs} (one of {RATES})")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedDeepPLC: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.fs = fs
        self.batch = batch
        self.lpcnet = plcmod.LPCNetPLC(plc_model, pitch_model, fargan_model,
                                       batch, device=self.device)
        # per concealed 10 ms frame of the last dred_decode: (the lanes it
        # concealed, those that took a FEC row, FARGAN's pitch period)
        self.trace = []
        self.rs = None
        if fs == 48000:
            self.rs = upsampler_init(batch, 16, self.device)
        elif fs != 16000:
            self.rs = dec_resampler_init(batch, fs, self.device)

    def _resample(self, pcm16):
        if self.fs == 48000:
            return upsample_to_48k(pcm16, self.rs, 16, frame_ms=10)
        return resample_16k(pcm16, self.rs, self.fs)

    def dred_decode(self, dreds: DREDBatch, dred_offset, frame_size,
                    lanes=None) -> torch.Tensor:
        """Concealment audio from processed DRED (reference:
        opus_decoder_dred_decode src/opus_decoder.c:1611) on the lanes of
        ``lanes`` ([B] bool, default all).  dred_offset and frame_size:
        samples at fs, ints or [B] ints.  Conceals max(n10) 10 ms frames,
        each lane stopping at its own n10 = max(1, frame_size // (fs /
        100)).  Returns int16 [B, max frame_size] on the device: lane i's
        first frame_size[i] samples are its audio, the rest (and every
        sample of a lane outside the mask) are zero."""
        b = self.batch
        fsz = np.broadcast_to(np.asarray(frame_size, np.int64), (b,)).copy()
        m = lane_mask(lanes, b, self.device)
        sel = m.cpu().numpy()
        if not sel.any():
            return torch.zeros((b, 0), dtype=torch.int16, device=self.device)
        if (fsz[sel] <= 0).any():
            raise ValueError("bad frame size")
        f10 = self.fs // 100
        feed_dred_fec(self.lpcnet, dreds, dred_offset, self.fs, fsz, m)
        n10 = np.maximum(1, fsz // f10)
        n10_t = torch.as_tensor(n10, device=self.device)
        pieces = []
        self.trace = []
        for k in range(int(n10[sel].max())):
            mk = m & (k < n10_t)
            out16 = self.lpcnet.conceal(mk)
            self.trace.append((mk, self.lpcnet.fec_used,
                               self.lpcnet.fargan.last_period))
            if self.rs is not None:
                out, rs = self._resample(out16)
                self.rs = select_lanes(mk, rs, self.rs)
                out16 = torch.where(mk[:, None], out,
                                    torch.zeros_like(out)).to(torch.int16)
            pieces.append(out16)
        width = int(fsz[sel].max())
        out = torch.cat(pieces, dim=1)[:, :width]
        valid = torch.arange(width, device=self.device)[None, :] \
            < torch.as_tensor(fsz, device=self.device)[:, None]
        return torch.where(valid & m[:, None], out, torch.zeros_like(out))
