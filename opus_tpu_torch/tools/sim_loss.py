"""Simulated-loss decoding over a batch of streams: the batched
counterpart of ``opus_demo decode -loss|-sim_loss|-lossfile ...``'s loop
(``opus_tpu/tools/opus_demo.py:109-190``; reference: src/opus_demo.c's
decode loop), for 48 kHz mono CELT streams of 20 ms packets, in
opus_demo's three ways of handling a lost packet:

- plain (``dred=False, inbandfec=False``): a lost lane conceals its 20 ms
  in its own tick with the classic CELT concealment
  (``KernelCeltDecoder.conceal``, ``celt/plc.py``; opus_demo.py:159);
- ``inbandfec=True``: a lost lane adds its 20 ms to a pending span, and
  the packet that ends the run first conceals that span classically in
  pieces of 20 ms (a CELT-only stream carries no LBRR:
  ``OpusDecoder.decode(..., decode_fec=True)`` conceals,
  opus_decoder.py:143-146 and :298-318), then decodes;
- ``dred=True``: the pending span is concealed from the resuming packet's
  DRED (``OpusDREDDecoder.parse`` on the host, ``process_batch`` on the
  device, ``BatchedDeepPLC.dred_decode(..., lanes=)``: deep PLC with the
  FEC queue, FARGAN and its de-emphasis, kernel K2 on the card, and the 16
  -> 48 kHz upsampler), or classically where the packet carries no DRED
  (opus_demo.py:136-148).  ``inbandfec`` takes precedence, as in
  opus_demo.

Every lane that received its packet then decodes it through
``KernelCeltDecoder`` with ``active`` (K1 and K2 on the card); a lost
packet never reaches the decoder.  ``flush()`` conceals each lane's
pending span at the stream's end classically (opus_demo.py:175-176).  The
output is int16 per lane, as opus_demo writes it (``floor(x * 32768 +
0.5)``, clipped).  As in the JAX package's loop, good frames are not fed to
deep PLC (``lpcnet.update``) and a DRED concealment leaves the CELT state
where the last packet left it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..bitstream import packet as pkt
from ..dnn import dred as dredmod, fargan as fg, pitchdnn as pdnn
from ..dnn import plc as plcmod, rdovae
from ..dnn.dred_dec import OpusDREDDecoder
from ..models.celt_dec_kernel import KernelCeltDecoder
from ..models.deep_plc import BatchedDeepPLC

FS = 48000
FRAME = 960
CELT_FB_20MS = 31        # TOC configuration: CELT-only, full band, 20 ms


def celt_frame(data: bytes) -> bytes:
    """The CELT frame of a one-frame mono CELT-only FB 20 ms packet."""
    parsed = pkt.packet_parse(data)
    if isinstance(parsed, int) or data[0] >> 3 != CELT_FB_20MS \
            or data[0] & 4 or parsed.count != 1:
        raise ValueError("BatchedLossDecoder: 20 ms mono CELT-only packets "
                         "of one frame only")
    return parsed.frames[0]


def to_int16(pcm) -> torch.Tensor:
    """Float PCM -> int16 as opus_demo writes it."""
    return torch.clamp(torch.floor(pcm.to(torch.float64) * 32768 + 0.5),
                       -32768, 32767).to(torch.int16)


class _Out:
    """A tick's int16 output, assembled segment by segment: lane i's
    segments follow each other from sample 0."""

    def __init__(self, batch: int, device):
        self.parts = []
        self.pos = np.zeros(batch, np.int64)
        self.device = device

    def add(self, seg, n):
        """seg [B, L] int16: lane i contributes its first n[i] samples."""
        n = np.asarray(n, np.int64)
        if n.any():
            self.parts.append((seg, self.pos.copy(), n))
            self.pos = self.pos + n

    def build(self):
        b = len(self.pos)
        width = int(self.pos.max(initial=0))
        out = torch.zeros((b, width + 1), dtype=torch.int16,
                          device=self.device)
        for seg, pos, n in self.parts:
            k = torch.arange(seg.shape[1], device=self.device)[None, :]
            ln = torch.as_tensor(n, device=self.device)[:, None]
            idx = torch.where(k < ln, torch.as_tensor(
                pos, device=self.device)[:, None] + k, width)
            out.scatter_(1, idx, seg)
        return out[:, :width], self.pos.copy()


class BatchedLossDecoder:
    """opus_demo's loss loop over B streams on one device, the card by
    default (``device="cpu"``: the plain versions).  The DNN models are
    needed only with ``dred=True``."""

    def __init__(self, batch: int, plc_model: plcmod.PLCModel = None,
                 pitch_model: pdnn.PitchDNNModel = None,
                 fargan_model: fg.FARGANModel = None,
                 dred_model: rdovae.RDOVAEDec = None,
                 stats: dredmod.DREDStats = None, max_payload: int = 1275,
                 device="cuda", dred: bool = True, inbandfec: bool = False):
        self.batch = batch
        self.device = torch.device(device)
        self.use_dred = dred
        self.inbandfec = inbandfec
        self.celt = KernelCeltDecoder(batch, max_payload=max_payload,
                                      device=self.device)
        self.plc = self.dred = None
        if dred:
            if None in (plc_model, pitch_model, fargan_model, dred_model,
                        stats):
                raise ValueError("BatchedLossDecoder: dred=True needs the "
                                 "PLC, pitch, FARGAN and RDOVAE models and "
                                 "the DRED statistics")
            self.plc = BatchedDeepPLC(plc_model, pitch_model, fargan_model,
                                      batch, fs=FS, device=self.device)
            self.dred = OpusDREDDecoder(dred_model, stats,
                                        device=self.device)
        self._pending = np.zeros(batch, np.int64)
        self.resumes = 0                # lanes concealed from DRED
        # the lanes concealed from DRED in the last tick ([B] bool numpy)
        self.dred_lanes = np.zeros(batch, bool)
        # one entry per classic concealment call: its lanes and per-lane
        # branch, pitch period and zeroing decision (numpy [B] each)
        self.classic_trace = []
        # the last tick's CELT float PCM [B, 960] (zeros on lost lanes) and
        # error flags [B]
        self.pcm = None
        self.err = torch.zeros(batch, dtype=torch.bool, device=self.device)

    def pending(self) -> np.ndarray:
        """[B] samples of lost audio not concealed yet."""
        return self._pending.copy()

    def final_range(self) -> torch.Tensor:
        """[B] the CELT decoder's final range after each lane's last
        decoded packet."""
        return self.celt.final_range()

    def _conceal(self, frames: np.ndarray, out: _Out):
        """Conceals frames[i] 20 ms frames of lane i classically, one call
        a frame over the lanes that still have one, into ``out``."""
        for p in range(int(frames.max(initial=0))):
            m = frames > p
            pcm = self.celt.conceal(torch.as_tensor(m, device=self.device))
            tr = self.celt.plc_trace
            self.classic_trace.append(dict(
                lanes=m, **{k: v.cpu().numpy() for k, v in tr.items()}))
            out.add(to_int16(pcm[:, 0]), np.where(m, FRAME, 0))

    def tick(self, packets: Sequence[bytes], lost):
        """One 20 ms tick: B packets (a lost lane's packet is not read) and
        B loss flags.  Returns (pcm int16 [B, W] on the device, n [B]
        numpy): lane i's output this tick is pcm[i, :n[i]]: its concealed
        pending span then its decoded packet, or in the plain loop its
        concealed frame (n = 0 on a lane whose loss is deferred)."""
        b = self.batch
        lost = np.asarray(torch.as_tensor(lost).cpu(), bool).reshape(b)
        recv = ~lost
        for i in np.nonzero(recv)[0]:
            if pkt.packet_get_samples_per_frame(packets[i], FS) != FRAME:
                raise ValueError("BatchedLossDecoder: 20 ms packets only")
        defer = self.inbandfec or self.use_dred
        out = _Out(b, self.device)
        resume = recv & (self._pending > 0)
        span = np.where(resume, self._pending, 0)
        self.dred_lanes = np.zeros(b, bool)
        if resume.any():
            classic = resume.copy()
            if self.use_dred and not self.inbandfec:
                dreds = [None] * b
                for i in np.nonzero(resume)[0]:
                    d, _ = self.dred.parse(packets[i], int(span[i]), FS)
                    dreds[i] = d
                    classic[i] = d is None
                self.dred_lanes = resume & ~classic
            if self.dred_lanes.any():
                conc = self.plc.dred_decode(
                    self.dred.process_batch(dreds), span, span,
                    lanes=torch.as_tensor(self.dred_lanes,
                                          device=self.device))
                self.resumes += int(self.dred_lanes.sum())
                out.add(conc, np.where(self.dred_lanes, span, 0))
            self._conceal(np.where(classic, span // FRAME, 0), out)
        frames = [celt_frame(packets[i]) if recv[i] else b""
                  for i in range(b)]
        buf, lens = self.celt.pack(frames)
        act = torch.as_tensor(recv, device=self.device)
        pcm, err = self.celt.decode_packed(buf, lens, active=act)
        self.pcm, self.err = pcm.reshape(b, FRAME), err
        out.add(to_int16(self.pcm), np.where(recv, FRAME, 0))
        if not defer:
            self._conceal(lost.astype(np.int64), out)
        self._pending = np.where(lost & defer, self._pending + FRAME,
                                 np.where(resume, 0, self._pending))
        return out.build()

    def flush(self):
        """The stream's end: conceals every lane's pending span classically
        (opus_demo.py:175-176) -> (pcm int16 [B, W], n [B]) as ``tick``;
        ``pending()`` is zero after it."""
        out = _Out(self.batch, self.device)
        self._conceal(self._pending // FRAME, out)
        self._pending = np.zeros(self.batch, np.int64)
        return out.build()
