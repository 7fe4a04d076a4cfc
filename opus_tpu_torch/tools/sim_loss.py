"""Simulated-loss decoding with DRED over a batch of streams: the batched
counterpart of ``opus_demo decode -loss|-sim_loss|-lossfile ... -dred``'s
loop (``opus_tpu/tools/opus_demo.py:109-180``; reference: src/opus_demo.c's
decode loop), for 48 kHz mono CELT streams of 20 ms packets.

``BatchedLossDecoder.tick(packets, lost)`` takes one packet and one loss
flag per lane (``tools/loss.py`` makes the flags):

- a lost lane adds the packet's 20 ms to its pending span;
- a lane that receives a packet after a loss run parses the packet's DRED
  (``OpusDREDDecoder.parse`` on the host, ``process_batch`` on the device)
  and conceals its own pending span with ``BatchedDeepPLC.dred_decode(...,
  lanes=resuming)`` (deep PLC with the FEC queue, FARGAN and its
  de-emphasis, kernel K2 on the card, and the 16 -> 48 kHz upsampler);
- every lane that received its packet then decodes it through
  ``KernelCeltDecoder`` with ``active`` (K1 and K2 on the card); a lost
  packet never reaches the decoder.

The output is int16 per lane, as opus_demo writes it (``floor(x * 32768 +
0.5)``, clipped).  Two cases need the classic (non-neural) PLC, which is
not ported: a resuming packet without DRED raises ``NotImplementedError``
naming the lanes, and a loss run at the stream's end stays pending
(``pending()``); neither is concealed some other way.  As in the JAX
package's loop, good frames are not fed to deep PLC (``lpcnet.update``)
and the CELT state does not see the concealed span.
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


class BatchedLossDecoder:
    """opus_demo's loss loop with ``-dred`` over B streams on one device,
    the card by default (``device="cpu"``: the plain versions)."""

    def __init__(self, batch: int, plc_model: plcmod.PLCModel,
                 pitch_model: pdnn.PitchDNNModel,
                 fargan_model: fg.FARGANModel, dred_model: rdovae.RDOVAEDec,
                 stats: dredmod.DREDStats, max_payload: int = 1275,
                 device="cuda"):
        self.batch = batch
        self.device = torch.device(device)
        self.celt = KernelCeltDecoder(batch, max_payload=max_payload,
                                      device=self.device)
        self.plc = BatchedDeepPLC(plc_model, pitch_model, fargan_model,
                                  batch, fs=FS, device=self.device)
        self.dred = OpusDREDDecoder(dred_model, stats, device=self.device)
        self._pending = np.zeros(batch, np.int64)
        self.resumes = 0
        # the last tick's CELT float PCM [B, 960] (zeros on lost lanes) and
        # error flags [B]
        self.pcm = None
        self.err = torch.zeros(batch, dtype=torch.bool, device=self.device)

    def pending(self) -> np.ndarray:
        """[B] samples of lost audio not concealed yet (a loss run at the
        stream's end is left here: the classic PLC would conceal it)."""
        return self._pending.copy()

    def final_range(self) -> torch.Tensor:
        """[B] the CELT decoder's final range after each lane's last
        decoded packet."""
        return self.celt.state["seed"]

    def tick(self, packets: Sequence[bytes], lost):
        """One 20 ms tick: B packets (a lost lane's packet is not read) and
        B loss flags.  Returns (pcm int16 [B, W] on the device, n [B]
        numpy): lane i's output this tick is pcm[i, :n[i]], its concealed
        pending span then its decoded packet (n = 0 on a lost lane)."""
        b = self.batch
        lost = np.asarray(torch.as_tensor(lost).cpu(), bool).reshape(b)
        recv = ~lost
        for i in np.nonzero(recv)[0]:
            if pkt.packet_get_samples_per_frame(packets[i], FS) != FRAME:
                raise ValueError("BatchedLossDecoder: 20 ms packets only")
        resume = recv & (self._pending > 0)
        span = np.where(resume, self._pending, 0)
        conc = None
        if resume.any():
            dreds = [None] * b
            missing = []
            for i in np.nonzero(resume)[0]:
                d, _ = self.dred.parse(packets[i], int(span[i]), FS)
                if d is None:
                    missing.append(int(i))
                dreds[i] = d
            if missing:
                raise NotImplementedError(
                    f"BatchedLossDecoder: lanes {missing} resume with a "
                    f"packet that carries no DRED; the classic PLC that "
                    f"would conceal them is not ported")
            conc = self.plc.dred_decode(self.dred.process_batch(dreds), span,
                                        span, lanes=torch.as_tensor(
                                            resume, device=self.device))
            self.resumes += int(resume.sum())
        frames = [celt_frame(packets[i]) if recv[i] else b""
                  for i in range(b)]
        buf, lens = self.celt.pack(frames)
        act = torch.as_tensor(recv, device=self.device)
        pcm, err = self.celt.decode_packed(buf, lens, active=act)
        self.pcm, self.err = pcm.reshape(b, FRAME), err
        dec16 = to_int16(self.pcm)
        self._pending = np.where(lost, self._pending + FRAME,
                                 np.where(resume, 0, self._pending))
        n = np.where(recv, span + FRAME, 0)
        width = int(n.max(initial=0))
        pos = torch.arange(width, device=self.device)[None, :]
        sp = torch.as_tensor(span, device=self.device)[:, None]
        k = pos - sp
        out = torch.gather(dec16, 1, k.clamp(0, FRAME - 1))
        if conc is not None:
            c = torch.gather(conc, 1, pos.clamp(max=conc.shape[1] - 1)
                             .expand(b, -1))
            out = torch.where(pos < sp, c, out)
        keep = torch.as_tensor(recv, device=self.device)[:, None] & (k < FRAME)
        return torch.where(keep, out, torch.zeros_like(out)), n
