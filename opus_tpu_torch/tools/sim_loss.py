"""Simulated-loss decoding over a batch of streams: the batched
counterpart of ``opus_demo decode -loss|-sim_loss|-lossfile ...``'s loop
(``opus_tpu/tools/opus_demo.py:109-190``; reference: src/opus_demo.c's
decode loop) for 48 kHz mono streams of 20 ms one-frame packets of one
mode a decoder (``mode``): CELT-only fullband (TOC configuration 31,
``KernelCeltDecoder``), SILK-only wideband (configuration 9,
``FusedSilkDecoder`` at 48 kHz) or hybrid fullband (configuration 15,
``FusedHybridDecoder``); a packet of another mode raises ValueError.
opus_demo's three ways of handling a lost packet:

- plain (``dred=False, inbandfec=False``): a lost lane conceals its 20 ms
  in its own tick with the classic concealment (``conceal``: CELT's
  ``celt/plc.py``, SILK's ``models/silk_plc.py``, hybrid both;
  opus_demo.py:159);
- ``inbandfec=True``: a lost lane adds its 20 ms to a pending span, and
  the packet that ends the run first conceals that span less 20 ms in
  pieces of 20 ms, then decodes its LBRR frame (SILK's in-band FEC, with
  the CELT half of a hybrid frame concealed) into the last 20 ms, or
  conceals it where the packet carries none, then decodes the packet
  (``OpusDecoder.decode(..., decode_fec=True)``, opus_decoder.py:134-160;
  a CELT-only stream carries no LBRR, so it conceals the whole span);
- ``dred=True``: the pending span is concealed from the resuming packet's
  DRED (``OpusDREDDecoder.parse`` on the host, ``process_batch`` on the
  device, ``BatchedDeepPLC.dred_decode(..., lanes=)``: deep PLC with the
  FEC queue, FARGAN and its de-emphasis, kernel K2 on the card, and the 16
  -> 48 kHz upsampler), or classically where the packet carries no DRED
  (opus_demo.py:136-148).  ``inbandfec`` takes precedence, as in
  opus_demo.

Every lane that received its packet then decodes it with ``active`` (K1
and K2, K4, or all three on the card); a lost packet never reaches the
decoder.  A received frame of 0 or 1 byte (DTX) is concealed instead,
20 ms, its final range 0 (opus_decoder.py:292-300).  A lane that has
decoded nothing conceals zeros.  ``flush()`` conceals each lane's pending
span at the stream's end classically (opus_demo.py:175-176).  The output
is int16 per lane, as opus_demo writes it (``floor(x * 32768 + 0.5)``,
clipped; a SILK frame is int16 already).  As in the JAX package's loop,
good frames are not fed to deep PLC (``lpcnet.update``) and a DRED
concealment leaves the decoder's state where the last packet left it.
``events`` records each call that emitted 20 ms: the call ("decode",
"conceal", "fec" or "dred"), its lanes, each lane's kind (``DECODED`` ..
``DTX``), the final range after it and, for SILK and hybrid, the SILK
loss count.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..bitstream import packet as pkt
from ..bitstream.range_coder import RangeDecoder
from ..dnn import dred as dredmod, fargan as fg, pitchdnn as pdnn
from ..dnn import plc as plcmod, rdovae
from ..dnn.dred_dec import OpusDREDDecoder
from ..models.celt_dec_kernel import KernelCeltDecoder
from ..models.deep_plc import BatchedDeepPLC
from ..models.fused_silk_dec import FusedSilkDecoder
from ..models.hybrid_dec_fused import FusedHybridDecoder
from ..ops.lanes import LaneOut

FS = 48000
FRAME = 960
CELT_FB_20MS = 31        # TOC configuration: CELT-only, full band, 20 ms
# TOC configuration of each mode's 20 ms packets
CONFIGS = dict(celt=CELT_FB_20MS, silk=9, hybrid=15)
# the kinds of a 20 ms slot in ``events``
DECODED, CONCEALED, DRED, ZEROS, LBRR, DTX = range(6)


def mode_frame(data: bytes, mode: str) -> bytes:
    """The frame of a one-frame mono 20 ms packet of ``mode``."""
    parsed = pkt.packet_parse(data)
    if isinstance(parsed, int) or data[0] >> 3 != CONFIGS[mode] \
            or data[0] & 4 or parsed.count != 1:
        raise ValueError(f"BatchedLossDecoder: 20 ms mono {mode} packets "
                         f"(TOC configuration {CONFIGS[mode]}) of one frame "
                         f"only")
    return parsed.frames[0]


def lbrr_flag(frame: bytes) -> bool:
    """Whether a SILK or hybrid frame carries an LBRR frame: the second
    bit of its SILK header (silk/dec_API.c:252)."""
    rd = RangeDecoder(frame)
    rd.dec_bit_logp(1)
    return bool(rd.dec_bit_logp(1))


def to_int16(pcm) -> torch.Tensor:
    """Float PCM -> int16 as opus_demo writes it."""
    return torch.clamp(torch.floor(pcm.to(torch.float64) * 32768 + 0.5),
                       -32768, 32767).to(torch.int16)


class BatchedLossDecoder:
    """opus_demo's loss loop over B streams of one ``mode`` ("celt",
    "silk" or "hybrid") on one device, the card by default
    (``device="cpu"``: the plain versions).  The DNN models are needed
    only with ``dred=True``.  ``inbandfec``: True, False or a [B] bool mask
    of the lanes that run opus_demo's ``-inbandfec`` loop (the others run
    the plain or the ``-dred`` loop)."""

    def __init__(self, batch: int, plc_model: plcmod.PLCModel = None,
                 pitch_model: pdnn.PitchDNNModel = None,
                 fargan_model: fg.FARGANModel = None,
                 dred_model: rdovae.RDOVAEDec = None,
                 stats: dredmod.DREDStats = None, max_payload: int = 1275,
                 device="cuda", dred: bool = True, inbandfec: bool = False,
                 mode: str = "celt"):
        if mode not in CONFIGS:
            raise ValueError(f"BatchedLossDecoder: mode {mode!r}, expected "
                             f"one of {sorted(CONFIGS)}")
        self.batch = batch
        self.mode = mode
        self.device = torch.device(device)
        self.use_dred = dred
        self.inbandfec = inbandfec
        self._fec_lanes = np.broadcast_to(np.asarray(inbandfec, bool),
                                          (batch,)).copy()
        if mode == "celt":
            self.decoder = KernelCeltDecoder(batch, max_payload=max_payload,
                                             device=self.device)
        elif mode == "silk":
            self.decoder = FusedSilkDecoder(batch, fs_khz=16, fs_out=FS,
                                            max_payload=max_payload,
                                            device=self.device)
        else:
            self.decoder = FusedHybridDecoder(batch, max_payload=max_payload,
                                              device=self.device)
        # the CELT decoder (mode "celt"), whose concealment keeps a trace
        self.celt = self.decoder if mode == "celt" else None
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
        self._rng = torch.zeros(batch, dtype=torch.int64, device=self.device)
        self.resumes = 0                # lanes concealed from DRED
        # the lanes concealed from DRED in the last tick ([B] bool numpy)
        self.dred_lanes = np.zeros(batch, bool)
        # one entry per classic CELT concealment call: its lanes and
        # per-lane branch, pitch period and zeroing decision (numpy [B])
        self.classic_trace = []
        # one entry per call that emitted 20 ms on some lanes, in order:
        # lanes, kind, range and (SILK / hybrid) loss_cnt, numpy [B] each
        self.events = []
        # the last tick's decoded float PCM [B, 960] (zeros on lanes that
        # did not decode a packet) and error flags [B]
        self.pcm = None
        self.err = torch.zeros(batch, dtype=torch.bool, device=self.device)

    def pending(self) -> np.ndarray:
        """[B] samples of lost audio not concealed yet."""
        return self._pending.copy()

    def final_range(self) -> torch.Tensor:
        """[B] each lane's final range after its last 20 ms: the decoder's
        after a decoded packet or an in-band FEC frame, 0 after a
        concealment (opus_decoder.py:300)."""
        return self._rng

    def _lane_state(self) -> dict:
        """The per-lane state holding ``decoded_any`` (and, SILK and
        hybrid, the SILK ``loss_cnt``)."""
        st = self.decoder.state
        return st["silk"] if self.mode == "hybrid" else st

    def _event(self, call, m, kind, rng, out, pcm16):
        """Records one emitting ``call`` ("decode", "conceal" or "fec")
        over the lanes m ([B] bool numpy) with kind [B] and the final range
        rng [B] after it, and adds its 20 ms to ``out``."""
        mt = torch.as_tensor(m, device=self.device)
        self._rng = torch.where(mt, rng, self._rng)
        ev = dict(call=call, lanes=m, kind=np.where(m, kind, -1),
                  rng=self._rng.cpu().numpy())
        if self.mode != "celt":
            ev["loss_cnt"] = self._lane_state()["loss_cnt"].cpu().numpy()
        self.events.append(ev)
        out.add(pcm16, np.where(m, FRAME, 0))

    def _conceal_call(self, m: np.ndarray, kind: int, out: LaneOut):
        """One 20 ms concealment on the lanes of m ([B] bool numpy); a lane
        that has decoded nothing emits zeros (kind ZEROS)."""
        mt = torch.as_tensor(m, device=self.device)
        had = self._lane_state()["decoded_any"].cpu().numpy()
        pcm = self.decoder.conceal(mt)
        if self.mode == "celt":
            pcm16 = to_int16(pcm[:, 0])
            tr = self.celt.plc_trace
            self.classic_trace.append(dict(
                lanes=m, **{k: v.cpu().numpy() for k, v in tr.items()}))
        else:
            pcm16 = pcm if self.mode == "silk" else to_int16(pcm)
        self._event("conceal", m, np.where(had, kind, ZEROS), torch.zeros_like(
            self._rng), out, pcm16)

    def _conceal(self, frames: np.ndarray, out: LaneOut, kind=CONCEALED):
        """Conceals frames[i] 20 ms frames of lane i, one call a frame over
        the lanes that still have one, into ``out``."""
        for p in range(int(frames.max(initial=0))):
            self._conceal_call(frames > p, kind, out)

    def _fec(self, lanes, frames, dtx, out: LaneOut):
        """The in-band FEC frame of the resuming lanes (``lanes`` [B] bool
        numpy): the LBRR frame of their packet decoded in place of the last
        lost 20 ms (or concealed where it carries none), a DTX packet's
        concealment (opus_decoder.py:143-160, :292-297)."""
        fl = lanes & ~dtx
        if fl.any():
            buf, lens = self.decoder.pack(frames)
            mt = torch.as_tensor(fl, device=self.device)
            pcm, _err = self.decoder.decode_packed(buf, lens, active=mt,
                                                   fec=mt)
            pcm16 = pcm if self.mode == "silk" else to_int16(pcm)
            kind = np.array([LBRR if fl[i] and lbrr_flag(frames[i])
                             else CONCEALED for i in range(self.batch)])
            self._event("fec", fl, kind, self.decoder.final_range, out,
                        pcm16)
        if (lanes & dtx).any():
            self._conceal_call(lanes & dtx, DTX, out)

    def tick(self, packets: Sequence[bytes], lost):
        """One 20 ms tick: B packets (a lost lane's packet is not read) and
        B loss flags.  Returns (pcm int16 [B, W] on the device, n [B]
        numpy): lane i's output this tick is pcm[i, :n[i]]: its concealed
        pending span, its FEC frame, then its decoded packet, or in the
        plain loop its concealed frame (n = 0 on a lane whose loss is
        deferred)."""
        b = self.batch
        lost = np.asarray(torch.as_tensor(lost).cpu(), bool).reshape(b)
        recv = ~lost
        for i in np.nonzero(recv)[0]:
            if pkt.packet_get_samples_per_frame(packets[i], FS) != FRAME:
                raise ValueError("BatchedLossDecoder: 20 ms packets only")
        frames = [mode_frame(packets[i], self.mode) if recv[i] else b""
                  for i in range(b)]
        dtx = recv & np.array([len(f) <= 1 for f in frames])
        good = recv & ~dtx
        fecl = self._fec_lanes
        defer = fecl | self.use_dred
        out = LaneOut(b, self.device)
        resume = recv & (self._pending > 0)
        span = np.where(resume, self._pending, 0)
        self.dred_lanes = np.zeros(b, bool)
        if resume.any():
            classic = resume.copy()
            if self.use_dred and (resume & ~fecl).any():
                dreds = [None] * b
                for i in np.nonzero(resume & ~fecl)[0]:
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
                m = self.dred_lanes
                self.events.append(dict(call="dred", lanes=m,
                                        kind=np.where(m, DRED, -1),
                                        span=span // FRAME))
                out.add(conc, np.where(m, span, 0))
            lbrr = classic & fecl if self.mode != "celt" \
                else np.zeros(b, bool)
            self._conceal(np.where(classic, span // FRAME - lbrr, 0), out)
            if lbrr.any():
                self._fec(lbrr, frames, dtx, out)
        self.pcm = torch.zeros((b, FRAME), dtype=torch.float32,
                               device=self.device)
        self.err = torch.zeros(b, dtype=torch.bool, device=self.device)
        if good.any():
            buf, lens = self.decoder.pack(frames)
            act = torch.as_tensor(good, device=self.device)
            pcm, self.err = self.decoder.decode_packed(buf, lens, active=act)
            if self.mode == "silk":
                pcm16 = pcm
                self.pcm = pcm.to(torch.float32) * (1.0 / 32768.0)
            else:
                self.pcm = pcm.reshape(b, FRAME)
                pcm16 = to_int16(self.pcm)
            self._event("decode", good, DECODED, self.decoder.final_range()
                        if self.mode == "celt" else self.decoder.final_range,
                        out, pcm16)
        if dtx.any():
            self._conceal_call(dtx, DTX, out)
        if (lost & ~defer).any():
            self._conceal((lost & ~defer).astype(np.int64), out)
        self._pending = np.where(lost & defer, self._pending + FRAME,
                                 np.where(resume, 0, self._pending))
        return out.build()

    def flush(self):
        """The stream's end: conceals every lane's pending span classically
        (opus_demo.py:175-176) -> (pcm int16 [B, W], n [B]) as ``tick``;
        ``pending()`` is zero after it."""
        out = LaneOut(self.batch, self.device)
        self._conceal(self._pending // FRAME, out)
        self._pending = np.zeros(self.batch, np.int64)
        return out.build()
