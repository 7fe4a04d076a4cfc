"""The top-level Opus decoder over B independent streams at 8, 12, 16,
24 or 48 kHz, with one or two output channels.

Port of ``opus_tpu/models/opus_decoder.py`` (``OpusDecoder(fs,
channels)``: the TOC, code 0-3 framing, mode dispatch, mode transitions
and redundancy frames, loss and DTX, in-band FEC, ``decode_int16``,
``decode24``, ``OPUS_SET_GAIN``) for every packet of TOC configurations
0-31, mono or
stereo: CELT-only at 2.5-20 ms, SILK-only NB/MB/WB at 10-60 ms (2-3
frames in one SILK packet at 40/60 ms) and hybrid SWB/FB at 10/20 ms.
Each lane gets its own packet (or None) at every call, and each lane's
mode, bandwidth, frame size and coded channel count may change from
packet to packet.  A stereo packet on a one-channel decoder is mixed
down as libopus does (the SILK mid channel; CELT's two spectra averaged,
with ``disable_inv``); a mono packet on a two-channel decoder is
synthesised into both channels.  Below 48 kHz the SILK output is
resampled to the decoder's rate and the CELT synthesis runs at 48 kHz and
keeps every (48000 / fs)-th de-emphasised sample, as libopus does.  A
packet that carries a quality extension (extension 124 in its padding,
which the JAX package decodes at 48 and 96 kHz) is refused on its lane
with OPUS_UNIMPLEMENTED: QEXT is not ported, and neither is 96 kHz.

How a call runs.  The packets are parsed on the host and each lane's
work is laid out as a list of jobs: its frames, or the concealment of a
lost packet in the pieces the reference conceals it in
(opus_decoder.py:298-323).  Round r runs the r-th job of every lane.  A
round follows ``_decode_frame`` (:280-488) stage by stage over the lanes
that need each stage: the transition concealment, the SILK half
(``silk_api.SilkLanes``: the header, the LBRR frames, the stereo
predictor, each SILK frame of the packet, mid/side -> left/right, the
resamplers), the redundancy signal, the CELT -> SILK redundant frame,
the CELT frame (or a SILK frame's hybrid -> SILK fade), the SILK -> CELT
redundant frame, then the splices, crossfades and gain lane by lane under
masks.  Inside a stage the lanes are grouped by what fixes the code path
-- (internal rate, SILK subframes, frames, coded channels) for SILK, (LM,
start band, end band, coded channels) for CELT -- and each group runs on
its own lanes, gathered out of the per-lane state and scattered back: a
call costs its lanes' work, not B lanes' for every group.  The host reads
the redundancy flags back once a round.

State, one per lane: the CELT decoder's (``fused_celt_init_state`` with
both channels' energy memory, and the second output channel's synthesis
state on a two-channel decoder: the same for every frame size and band
range, as libopus keeps one CELT decoder), the SILK side
(``silk_api.SilkLanes``), and on the host the mode, bandwidth, coded
channels, redundancy and band-range fields of the scalar decoder
(``prev_mode``, ``prev_redundancy``, the CELT decoder's ``start`` and
``end``).

Kernels: K1 (every CELT frame, redundant frame and fade frame; LM 0-3;
its mono or its stereo instantiation by the frame's coded channels), K2
(every CELT synthesis and concealment, one row per output channel), K4
(every SILK frame and concealment of each coded channel) on the card,
their plain versions on CPU tensors.  Errors: an invalid packet (or a
QEXT one) sets ``status`` on its lane for that call and leaves the lane's
state untouched; a lane that K1 or the SILK symbol pass flags stays
``flagged``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bitstream import packet as pkt
from ..bitstream.extensions import ExtensionData, ExtensionIterator
from ..celt.plc import decode_lost
from ..ops import rc_kernel as K
from ..ops.device_cache import const
from ..ops.lanes import LaneOut
from ..ops.mdct import _window
from ..utils.soft_clip import float2int16_lanes, soft_clip_lanes
from .celt_dec_fused import fused_celt_init_state
from .celt_dec_kernel import dec_tabs, kernel_celt_decode_to_pcm
from .silk_api import SilkLanes, put as _put, take as _take

FS = 48000              # the CELT mode's rate: its synthesis runs at 48 kHz
RATES = (8000, 12000, 16000, 24000, 48000)
F2_5_48 = 120           # 2.5 ms at 48 kHz: the CELT overlap
QEXT_EXTENSION_ID = 124     # (reference: celt/celt.h QEXT_EXTENSION_ID)
CELT, SILK, HYBRID = (int(pkt.Mode.CELT_ONLY), int(pkt.Mode.SILK_ONLY),
                      int(pkt.Mode.HYBRID))
# the CELT end band of each bandwidth (opus_decoder.py:413)
END_BAND = {int(pkt.Bandwidth.NARROWBAND): 13,
            int(pkt.Bandwidth.MEDIUMBAND): 17,
            int(pkt.Bandwidth.WIDEBAND): 17,
            int(pkt.Bandwidth.SUPERWIDEBAND): 19,
            int(pkt.Bandwidth.FULLBAND): 21}
HYBRID_START = 17
HYBRID_CELT = -1     # a concealment of the CELT half alone (FEC frames)


def _isr_khz(mode: int, bw: int) -> int:
    """The SILK internal rate of a frame (opus_decoder.py:354-358)."""
    if mode == SILK and bw == int(pkt.Bandwidth.NARROWBAND):
        return 8
    if mode == SILK and bw == int(pkt.Bandwidth.MEDIUMBAND):
        return 12
    return 16


@lru_cache(maxsize=None)
def _fade_gain(inc: int) -> np.ndarray:
    """smooth_fade's gains at 48000 / inc Hz (src/opus_decoder.c:220,
    opus_decoder.py:235-246): the squared 120-sample CELT window taken at
    every inc-th sample, float32."""
    w = _window(F2_5_48)[::inc]
    return (w * w).astype(np.float32)


def _smooth_fade(in1, in2, inc: int, dev):
    """g * in2 + (1 - g) * in1 over 2.5 ms [..., 120 / inc]."""
    g = const(("opus_fade", inc), lambda: _fade_gain(inc), dev)
    return g * in2 + (1.0 - g) * in1


def has_qext(parsed) -> bool:
    """Whether a parsed packet's padding carries a quality extension for
    one of its frames (opus_decoder.py:217-233)."""
    if not parsed.padding:
        return False
    it = ExtensionIterator(parsed.padding, parsed.count)
    while True:
        ext = it.find(QEXT_EXTENSION_ID)
        if not isinstance(ext, ExtensionData):
            return False
        if 0 <= ext.frame < parsed.count:
            return True


def to_int24(pcm):
    """decode24's conversion (opus_decoder.py:187-197): RES2INT24, round to
    nearest (half to even) of pcm * 2^23 in float64, clipped to int32."""
    x = torch.round(pcm.to(torch.float64) * 8388608.0)
    return x.clamp(-(1 << 31), (1 << 31) - 1).to(torch.int32)


class BatchedOpusDecoder:
    """B independent Opus streams decoded to float PCM at ``fs`` (8000,
    12000, 16000, 24000 or 48000 Hz) with ``channels`` (1 or 2) output
    channels on the card (the default device: kernels K1, K2 and K4), or
    on the plain versions with ``device="cpu"``.

    ``decode(packets)``: one packet (bytes) or None (lost) a lane ->
    (pcm float32 [B, W] with one channel, [B, W, 2] with two; n [B]
    numpy): lane i's output is pcm[i, :n[i]] (n counts samples per
    channel).  ``decode_int16`` adds
    the soft clip (one memory per lane and channel) and FLOAT2INT16,
    ``decode24`` the 24-bit conversion (int32, no soft clip).
    ``final_range`` [B] is each lane's ``rangeFinal``; ``status`` [B]
    (numpy) is 0, or OPUS_INVALID_PACKET on a lane whose packet of this
    call was invalid, or OPUS_UNIMPLEMENTED on a lane whose packet carries
    a quality extension (QEXT is not ported; either way the lane's state
    is untouched); ``flagged`` [B] (numpy)
    holds for a lane that K1 or the SILK symbol pass has flagged, for the
    rest of its stream.  ``set_gain(q8, lanes)`` is OPUS_SET_GAIN.
    ``events`` counts the frames of each kind that ran (for the tests and
    the card's report); ``celt_used`` [B] (numpy) holds, after a call, on
    the lanes where a CELT frame, redundant frame, fade frame or
    concealment contributed to the output (elsewhere the output is SILK's
    int16 / 32768 exactly)."""

    def __init__(self, batch: int, fs: int = 48000, channels: int = 1,
                 device="cuda", max_payload: int = 1275):
        if fs == 96000:
            raise ValueError("BatchedOpusDecoder: 96 kHz needs the quality "
                             "extension (QEXT), which the port does not "
                             "decode yet")
        if fs not in RATES:
            raise ValueError(f"BatchedOpusDecoder: fs must be one of {RATES}")
        if channels not in (1, 2):
            raise ValueError("BatchedOpusDecoder: channels must be 1 or 2")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedOpusDecoder: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.batch = batch
        self.fs = fs
        # CELT's decimation, and the frame lengths at fs
        self.ds = FS // fs
        self.f20, self.f10, self.f5, self.f2_5 = (fs // 50, fs // 100,
                                                  fs // 200, fs // 400)
        self.channels = channels
        # libopus sets disable_inv on a decoder with one output channel
        # (opus_decoder.py:42)
        self.disable_inv = channels == 1
        self.P = max_payload
        b, dev = batch, self.device
        self.events = {}
        self.celt = self._celt_fresh(b)
        self.silk = SilkLanes(b, channels, dev, self.events, fs // 1000)
        # one soft clip memory a lane ([B]) or a lane and channel ([B, 2])
        self.softclip_mem = torch.zeros((b, channels)[:channels],
                                        dtype=torch.float32, device=dev)
        self.rng = torch.zeros(b, dtype=torch.int64, device=dev)
        self.prev_mode = np.zeros(b, np.int64)
        self.prev_redundancy = np.zeros(b, bool)
        self.mode = np.zeros(b, np.int64)
        self.bandwidth = np.zeros(b, np.int64)
        self.stream_channels = np.full(b, channels, np.int64)
        self.frame_size = np.full(b, fs // 400, np.int64)
        self.last_packet_duration = np.zeros(b, np.int64)
        self.celt_start = np.zeros(b, np.int64)
        self.celt_end = np.full(b, 21, np.int64)
        self.decode_gain = np.zeros(b, np.int64)
        self.status = np.zeros(b, np.int64)
        self.flagged = np.zeros(b, bool)
        self.celt_used = np.zeros(b, bool)

    # ---- public API ---------------------------------------------------

    HOST_KEYS = ("prev_mode", "prev_redundancy", "mode", "bandwidth",
                 "stream_channels", "frame_size", "last_packet_duration",
                 "celt_start", "celt_end", "decode_gain")

    def get_state(self) -> dict:
        """Every lane's state (device tensors and host arrays, copies):
        what ``set_state`` takes, and ``convert.opus_decoder_state`` makes
        from the JAX package's decoders."""
        return dict(celt=self.celt, silk=self.silk.get_state(),
                    softclip_mem=self.softclip_mem, rng=self.rng,
                    host={k: getattr(self, k).copy()
                          for k in self.HOST_KEYS})

    def set_state(self, st: dict) -> None:
        """Takes a ``get_state`` / ``convert.opus_decoder_state`` dict."""
        dev = self.device

        def to(t):
            if isinstance(t, dict):
                return {k: to(v) for k, v in t.items()}
            return t.to(dev)
        self.celt = to(st["celt"])
        self.silk.set_state(st["silk"])
        self.softclip_mem = to(st["softclip_mem"])
        self.rng = to(st["rng"])
        for k in self.HOST_KEYS:
            setattr(self, k, np.array(st["host"][k]))

    @property
    def final_range(self):
        return self.rng

    def set_gain(self, gain_q8: int, lanes=None) -> None:
        """OPUS_SET_GAIN (Q8 dB) on ``lanes`` ([B] bool, default all)."""
        if not -32768 <= gain_q8 <= 32767:
            raise ValueError("gain out of range")
        m = np.ones(self.batch, bool) if lanes is None else np.asarray(
            lanes, bool)
        self.decode_gain = np.where(m, gain_q8, self.decode_gain)

    def decode_int16(self, packets, decode_fec=None, frame_size=None):
        """``decode``, then ``opus_pcm_soft_clip`` and FLOAT2INT16 per lane
        and channel (opus_decoder.py:177) -> (pcm int16 [B, W] or [B, W,
        2], n [B])."""
        pcm, n = self.decode(packets, decode_fec, frame_size)
        return self.soft_clip_int16(pcm, n)

    def decode24(self, packets, decode_fec=None, frame_size=None):
        """``decode``, then RES2INT24 (opus_decoder.py:187) -> (pcm int32
        [B, W] or [B, W, 2] in 24-bit scale, n [B])."""
        pcm, n = self.decode(packets, decode_fec, frame_size)
        return to_int24(pcm), n

    def soft_clip_int16(self, pcm, n):
        """The soft clip (each lane's and channel's memory) and FLOAT2INT16
        of ``decode``'s output (pcm, n) -> (pcm int16, n)."""
        if pcm.dim() == 2:
            pcm = pcm[:, :, None]
        b, w, c = pcm.shape
        rows = pcm.permute(0, 2, 1).reshape(b * c, w)
        rows, mem = soft_clip_lanes(rows, self.softclip_mem.reshape(-1),
                                    n=np.repeat(n, c))
        self.softclip_mem = mem.reshape(self.softclip_mem.shape)
        out = float2int16_lanes(rows.reshape(b, c, w).permute(0, 2, 1))
        return (out[:, :, 0] if c == 1 else out), n

    def decode(self, packets, decode_fec=None, frame_size=None):
        """packets: B entries, bytes (TOC included) or None (lost);
        decode_fec ([B] bool): lanes that decode the packet's in-band FEC
        (its LBRR frames) in place of the lost audio before it
        (opus_decoder.py:134-160); frame_size ([B] samples, optional):
        the audio a lost or FEC lane conceals or covers (default: the last
        packet's duration, or the packet's frame size; an entry of 0
        takes the default).  An FEC size off the 2.5 ms grid raises
        ValueError before any lane changes."""
        b = self.batch
        if len(packets) != b:
            raise ValueError(f"decode: {len(packets)} packets for {b} lanes")
        fec = np.zeros(b, bool) if decode_fec is None else np.asarray(
            decode_fec, bool)
        req = [None] * b if frame_size is None else [
            int(v) or None for v in np.asarray(frame_size, np.int64)]
        for i in range(b):
            self._check(packets[i], bool(fec[i]), req[i])
        self.status = np.zeros(b, np.int64)
        self.celt_used = np.zeros(b, bool)
        jobs = [self._plan(i, packets[i], bool(fec[i]), req[i])
                for i in range(b)]
        out = LaneOut(b, self.device, torch.float32)
        depth = max((len(j) for j in jobs), default=0)
        for r in range(depth):
            self._round([j[r] if r < len(j) else None for j in jobs], out)
        pcm, n = out.build()
        c = self.channels
        if c == 1:
            return pcm, n
        return pcm.reshape(b, -1, c), n // c

    # ---- host planning -----------------------------------------------

    def _conceal_jobs(self, i: int, n: int, jobs: list) -> None:
        """The concealment of n samples on lane i in the reference's
        pieces (opus_decoder.py:298-323), appended to ``jobs``; a lane
        that has decoded nothing gets zeros."""
        if self.prev_mode[i] == 0:
            jobs.append(("zeros", n))
            return
        mode = CELT if self.prev_redundancy[i] else int(self.prev_mode[i])
        f20, f10, f5 = self.f20, self.f10, self.f5
        done = 0
        while done < n:
            chunk = min(n - done, f20)
            if chunk < f20:
                if chunk > f10:
                    chunk = f10
                elif mode != SILK and f5 < chunk < f10:
                    chunk = f5
            jobs.append(("conceal", chunk, mode))
            done += chunk

    def _check(self, data, fec: bool, req) -> None:
        """The refusal of a lane's arguments, raised before any lane's
        state or host field changes."""
        if data is None or len(data) == 0:
            return
        if fec and req is not None and req % (self.fs // 400):
            raise ValueError("FEC/PLC frame size must be a multiple of "
                             "2.5 ms")

    def _plan(self, i: int, data, fec: bool, req):
        """Lane i's jobs for this call; sets the per-packet fields
        (mode, bandwidth, coded channels, frame size, last duration) as
        decode() does."""
        jobs = []
        if data is None or len(data) == 0:
            n = req if req is not None else (
                int(self.last_packet_duration[i]) or self.f20)
            self._conceal_jobs(i, n, jobs)
            if self.prev_mode[i] != 0:
                self.last_packet_duration[i] = n
            return jobs
        data = bytes(data)
        parsed = pkt.packet_parse(data)
        nfs = pkt.packet_get_samples_per_frame(data, self.fs)
        if isinstance(parsed, int) or nfs * parsed.count * 25 > self.fs * 3 \
                or max((len(f) for f in parsed.frames), default=0) > self.P:
            self.status[i] = pkt.OPUS_INVALID_PACKET
            return jobs
        if not fec and has_qext(parsed):
            self.status[i] = pkt.OPUS_UNIMPLEMENTED
            return jobs
        mode = int(pkt.packet_get_mode(data))
        bw = int(pkt.packet_get_bandwidth(data))
        sc = int(pkt.packet_get_nb_channels(data))
        if fec:
            n = req if req is not None else nfs
            if n < nfs or mode == CELT or self.mode[i] == CELT:
                self._conceal_jobs(i, n, jobs)
                if self.prev_mode[i] != 0:
                    self.last_packet_duration[i] = n
                return jobs
            if n != nfs:
                self._conceal_jobs(i, n - nfs, jobs)
            self.mode[i], self.bandwidth[i], self.frame_size[i] = mode, bw, nfs
            self.stream_channels[i] = sc
            jobs.append(("frame", parsed.frames[0], nfs, mode, bw, True, sc))
            self.last_packet_duration[i] = n
            return jobs
        self.mode[i], self.bandwidth[i], self.frame_size[i] = mode, bw, nfs
        self.stream_channels[i] = sc
        for f in parsed.frames:
            jobs.append(("frame", f, nfs, mode, bw, False, sc))
        self.last_packet_duration[i] = nfs * parsed.count
        return jobs

    # ---- one round -----------------------------------------------------

    def _count(self, key: str, n: int) -> None:
        if n:
            self.events[key] = self.events.get(key, 0) + int(n)

    def _idx(self, lanes) -> torch.Tensor:
        return torch.as_tensor(np.nonzero(lanes)[0], device=self.device)

    def _round(self, jobs, out: LaneOut) -> None:
        b, c = self.batch, self.channels
        width = max([self.f20] + [j[2] for j in jobs
                             if j is not None and j[0] == "frame"])
        pcm = torch.zeros((b, c, width), dtype=torch.float32,
                          device=self.device)
        n_out = np.zeros(b, np.int64)
        zeros = np.array([j is not None and j[0] == "zeros" for j in jobs])
        n_out[zeros] = [j[1] for j in jobs if j is not None
                        and j[0] == "zeros"]
        if zeros.any():
            out.add(torch.zeros((b, int(n_out.max()) * c),
                                device=self.device), n_out * c)
            n_out[:] = 0
        conc = [(i, j) for i, j in enumerate(jobs)
                if j is not None and j[0] == "conceal"]
        frames = [(i, j) for i, j in enumerate(jobs)
                  if j is not None and j[0] == "frame"]
        for i, j in conc:
            n_out[i] = j[1]
        # a frame of 0-1 bytes is DTX: concealed, at most the TOC's
        # duration (opus_decoder.py:292-297)
        dtx = [(i, j) for i, j in frames if len(j[1]) <= 1]
        if dtx:
            sub = []
            for i, j in dtx:
                js = []
                self._conceal_jobs(i, j[2], js)
                n_out[i] = j[2]
                if js[0][0] == "zeros":
                    # no packet decoded yet: zeros, the range cleared
                    self.rng[i] = 0
                    continue
                sub.append((i, js))
            self._count("dtx", len(dtx))
            for i, js in sub:
                # a DTX frame of up to 20 ms is one piece
                conc.append((i, js[0]))
        if conc:
            self._run_conceal(conc, pcm)
        frames = [(i, j) for i, j in frames if len(j[1]) > 1]
        if frames:
            for i, j in frames:
                n_out[i] = j[2]
            self._run_frames(frames, pcm)
        if n_out.any():
            # interleaved: sample t of channel k at t * channels + k
            out.add(pcm.permute(0, 2, 1).reshape(b, -1), n_out * c)

    # ---- concealment -------------------------------------------------

    def _run_conceal(self, conc, pcm) -> None:
        """The concealment pieces ``conc`` ((lane, ("conceal", chunk,
        mode))) into pcm rows (opus_decoder.py:248-278, :318-323)."""
        lanes = np.zeros(self.batch, bool)
        for i, j in conc:
            lanes[i] = True
        self._conceal_into(conc, pcm)
        for i, j in conc:
            self.prev_mode[i] = j[2]
        self.prev_redundancy[lanes] = False
        idx = self._idx(lanes)
        self.rng = self.rng.index_fill(0, idx, 0)
        self._count("concealed", len(conc))

    def _conceal_into(self, conc, dst) -> None:
        """Runs the pieces ``conc`` and writes each lane's piece into
        ``dst`` (a [B, CC, >= chunk] f32 tensor) from sample 0; the CELT
        half of a hybrid piece (or of an FEC frame, mode HYBRID_CELT) is
        added on top (opus_decoder.py:248-278)."""
        b = self.batch
        silk = {}
        celt = {}
        for i, (_k, chunk, mode) in conc:
            if mode in (SILK, HYBRID):
                fs = int(self.silk.fs[0][i]) or 16
                nb = 2 if max(10, 1000 * chunk // self.fs) == 10 else 4
                nch = int(self.silk.n_int[i]) or 1
                silk.setdefault((fs, nb, nch), []).append(i)
            if mode != SILK:
                n = min(self.f20, chunk)
                if mode == HYBRID:
                    self.celt_start[i] = HYBRID_START
                key = (n, int(self.celt_start[i]), int(self.celt_end[i]),
                       mode in (HYBRID, HYBRID_CELT))
                celt.setdefault(key, []).append(i)
        for (fs, nb, nch), items in silk.items():
            lanes = np.zeros(b, bool)
            lanes[items] = True
            idx = self._idx(lanes)
            out = self.silk.conceal_group(lanes, fs, nb, nch)
            x = out.to(torch.float32) * (1.0 / 32768.0)
            w = min(x.shape[2], dst.shape[2])
            dst[idx, :, :w] = x[:, :, :w]
        for (n, start, end, accum), lanes_i in celt.items():
            lanes = np.zeros(b, bool)
            lanes[lanes_i] = True
            idx = self._idx(lanes)
            tabs = dec_tabs(FS, n * self.ds, start, end)
            st = _take(self.celt, idx)
            one = torch.ones(len(lanes_i), dtype=torch.bool,
                             device=self.device)
            y, new, _tr = decode_lost(st, tabs, one,
                                      out_channels=self.channels,
                                      downsample=self.ds)
            self.celt = _put(self.celt, idx, new)
            self.celt_used[lanes] = True
            if accum:
                dst[idx, :, :n] = dst[idx, :, :n] + y
            else:
                dst[idx, :, :n] = y
            self._count(f"celt_conceal_lm{tabs.lm}", len(lanes_i))

    # ---- decoded frames ----------------------------------------------

    def _celt_fresh(self, n: int) -> dict:
        st = fused_celt_init_state(n, dec_tabs(FS, 960), self.device,
                                   out_channels=self.channels)
        st["decoded_any"] = torch.ones_like(st["decoded_any"])
        return st

    def _celt_reset(self, lanes) -> None:
        if lanes.any():
            idx = self._idx(lanes)
            self.celt = _put(self.celt, idx, self._celt_fresh(len(idx)))
            self._count("celt_reset", int(lanes.sum()))

    def _pack(self, frames):
        """The round's frames -> (buf [B, P] u8, lens [B]) on the device."""
        width = max(len(j[1]) for _i, j in frames)
        buf = np.zeros((self.batch, width), np.uint8)
        lens = np.zeros(self.batch, np.int64)
        for i, j in frames:
            buf[i, :len(j[1])] = np.frombuffer(j[1], np.uint8)
            lens[i] = len(j[1])
        return (torch.from_numpy(buf).to(self.device),
                torch.from_numpy(lens).to(self.device))

    def _celt_decode(self, groups, buf, lens, d, dst, accum_lanes=None):
        """CELT frames by group: groups {(n, start, end, C): lanes [B]
        bool} (n the frame's samples at fs) over buf/lens (full B rows),
        continuing from d (full-B range decoder dict) where given.  Writes (or, on ``accum_lanes``, adds)
        the PCM into dst rows [B, CC, >= n]; returns (rng [B], err [B]) on
        the device (zeros outside the groups)."""
        rng = torch.zeros(self.batch, dtype=torch.int64, device=self.device)
        err = torch.zeros(self.batch, dtype=torch.bool, device=self.device)
        for (n, start, end, c), lanes in groups.items():
            idx = self._idx(lanes)
            tabs = dec_tabs(FS, n * self.ds, start, end)
            st = _take(self.celt, idx)
            d0 = None if d is None else _take(d, idx)
            kw = {} if c == 1 and self.channels == 1 else dict(
                channels=c, out_channels=self.channels,
                disable_inv=self.disable_inv)
            if self.ds > 1:
                kw["downsample"] = self.ds
            y, new, e = kernel_celt_decode_to_pcm(
                buf.index_select(0, idx), lens.index_select(0, idx), st, tabs,
                d0=d0, **kw)
            if y.dim() == 2:
                y = y[:, None]
            self.celt = _put(self.celt, idx, new)
            self.celt_used[lanes] = True
            if accum_lanes is not None:
                acc = torch.as_tensor(accum_lanes[lanes], device=self.device)
                y = torch.where(acc[:, None, None], dst[idx, :, :n] + y, y)
            dst[idx, :, :n] = y
            rng = rng.index_copy(0, idx, new["rng_final"])
            err = err.index_copy(0, idx, e)
            self._count(f"celt_lm{tabs.lm}_start{start}"
                        + ("_stereo" if c == 2 else ""), len(idx))
        return rng, err

    def _run_frames(self, frames, pcm) -> None:
        """``_decode_frame`` (opus_decoder.py:280-488) for the lanes of
        ``frames`` ((lane, ("frame", bytes, n, mode, bw, fec, channels)))
        into pcm [B, CC, >= n]."""
        b, dev = self.batch, self.device
        cc = self.channels
        f20, f10, f5, f2_5 = self.f20, self.f10, self.f5, self.f2_5
        inc = self.ds
        on = np.zeros(b, bool)
        mode = np.zeros(b, np.int64)
        bw = np.zeros(b, np.int64)
        size = np.zeros(b, np.int64)
        sc = np.ones(b, np.int64)
        fec = np.zeros(b, bool)
        for i, j in frames:
            on[i] = True
            size[i], mode[i], bw[i], fec[i], sc[i] = j[2], j[3], j[4], j[5], \
                j[6]
        self._count("fec_frames", int(fec.sum()))
        prev = self.prev_mode.copy()
        prev_red = self.prev_redundancy.copy()
        is_celt = on & (mode == CELT)
        transition = on & (prev > 0) & (
            (is_celt & (prev != CELT) & ~prev_red)
            | (~is_celt & (prev == CELT)))
        buf, lens = self._pack(frames)
        pcm_tr = torch.zeros((b, cc, f5), dtype=torch.float32, device=dev)

        # (a) the transition into CELT: conceal up to 5 ms in the old mode
        # first (:330-342)
        ta = transition & is_celt
        if ta.any():
            self._conceal_into([(i, ("conceal", min(f5, int(size[i])),
                                     int(prev[i])))
                                for i in np.nonzero(ta)[0]], pcm_tr)
            self._count("transition_conceal", int(ta.sum()))

        # (b) the SILK half (:344-370): every SILK frame of the packet
        silk_on = on & ~is_celt
        d_full = None
        sil_err = torch.zeros(b, dtype=torch.bool, device=dev)
        if silk_on.any():
            self.silk.reset(silk_on & (prev == CELT))
            isr = np.array([_isr_khz(int(mode[i]), int(bw[i])) if silk_on[i]
                            else 0 for i in range(b)])
            nfr = np.where(size > f20, size // f20, 1)
            nb = np.where(size == f10, 2, 4)
            s2m = self.silk.prepare(silk_on, sc, isr,
                                    isr * np.where(size == f10, 10, 20))
            d_full = K.rk_init(buf, lens)
            keys = sorted({(int(isr[i]), int(nb[i]), int(nfr[i]), int(sc[i]))
                           for i in np.nonzero(silk_on)[0]})
            for fs, nbk, nf, nch in keys:
                g = silk_on & (isr == fs) & (nb == nbk) & (nfr == nf) \
                    & (sc == nch)
                idx = self._idx(g)
                out, d, e = self.silk.decode_group(g, fs, nbk, nf, nch,
                                                   buf, lens, fec, s2m)
                d_full = _put(d_full, idx, d)
                sil_err = sil_err.index_copy(0, idx, e)
                w = out.shape[2]
                pcm[idx, :, :w] = out.to(torch.float32) * (1.0 / 32768.0)

        # (c) the redundancy signal (:372-398)
        red = np.zeros(b, bool)
        c2s = np.zeros(b, bool)
        red_bytes = np.zeros(b, np.int64)
        lens2 = lens
        if silk_on.any():
            hyb = torch.as_tensor(mode == HYBRID, device=dev)
            can = torch.as_tensor(silk_on & ~fec, device=dev) & (
                K.rk_tell(d_full) + 17 + torch.where(hyb, 20, 0) <= 8 * lens)
            d = d_full
            bit, d = K.rk_dec_bit_logp(d, buf, lens, 12, can & hyb)
            r = can & (~hyb | (bit != 0))
            cbit, d = K.rk_dec_bit_logp(d, buf, lens, 1, r)
            ub, d = K.rk_dec_uint(d, buf, lens, 256, r & hyb)
            rb = torch.where(hyb, ub + 2, lens - ((K.rk_tell(d) + 7) >> 3))
            rb = torch.where(r, rb, 0)
            l2 = lens - rb
            bad = r & (l2 * 8 < K.rk_tell(d))
            r = r & ~bad
            rb = torch.where(bad, 0, rb)
            l2 = torch.where(bad, 0, l2)
            d_full = d
            lens2 = torch.where(r | bad, l2, lens)
            red = r.cpu().numpy()
            c2s = red & (cbit.cpu().numpy() != 0)
            red_bytes = rb.cpu().numpy()
        transition = transition & ~red
        endband = np.array([END_BAND.get(int(v), 21) for v in bw])
        l2_np = lens2.cpu().numpy() if silk_on.any() else None

        # (d) the transition out of CELT without redundancy (:400-403)
        td = transition & ~is_celt
        if td.any():
            self._conceal_into([(i, ("conceal", min(f5, int(size[i])),
                                     int(prev[i])))
                                for i in np.nonzero(td)[0]], pcm_tr)
            self._count("transition_conceal", int(td.sum()))
        self.celt_end[on] = endband[on]

        # the redundant frames' bytes (frame[len2:len2 + red_bytes])
        red_rng = torch.zeros(b, dtype=torch.int64, device=dev)
        red_pcm = torch.zeros((b, cc, f20), dtype=torch.float32, device=dev)
        rbuf = rlens = None
        if red.any():
            rows = []
            for i, j in frames:
                if red[i]:
                    a = int(l2_np[i])
                    rows.append((i, (None, j[1][a:a + int(red_bytes[i])])))
            rbuf, rlens = self._pack(rows)

        # (e) the 5 ms CELT -> SILK redundant frame (:421-427)
        e_lanes = red & c2s
        if e_lanes.any():
            self.celt_start[e_lanes] = 0
            rr, re = self._celt_decode(
                self._groups(e_lanes, np.full(b, f5), endband, 0, sc),
                rbuf, rlens, None, red_pcm)
            red_rng = torch.where(torch.as_tensor(e_lanes, device=dev), rr,
                                  red_rng)
            self._count("redundancy_celt_to_silk", int(e_lanes.sum()))
        start_band = np.where(is_celt, 0, HYBRID_START)
        self.celt_start[on] = start_band[on]

        # (f) the CELT frame, or a SILK frame's fade (:429-448)
        rng = torch.where(torch.as_tensor(silk_on, device=dev),
                          d_full["rng"] if d_full is not None else 0,
                          torch.zeros(b, dtype=torch.int64, device=dev))
        k1_err = torch.zeros(b, dtype=torch.bool, device=dev)
        celt_on = on & (mode != SILK)
        if celt_on.any():
            self._celt_reset(celt_on & (mode != prev) & (prev > 0)
                             & ~prev_red)
            reg = celt_on & ~fec
            if reg.any():
                hyb_reg = reg & (mode == HYBRID)
                rr, k1_err = self._celt_decode(
                    self._groups(reg, np.minimum(f20, size), endband,
                                 start_band, sc),
                    buf, lens2, d_full if hyb_reg.any() else None, pcm,
                    accum_lanes=hyb_reg)
                rng = torch.where(torch.as_tensor(reg, device=dev), rr, rng)
            fc = celt_on & fec
            if fc.any():
                # in-band FEC: the CELT half concealed (:429-436)
                self._conceal_into([(i, ("conceal", min(f20, int(size[i])),
                                         HYBRID_CELT))
                                    for i in np.nonzero(fc)[0]], pcm)
                rng = torch.where(torch.as_tensor(fc, device=dev),
                                  self.celt["seed"], rng)
        fade = on & (mode == SILK) & (prev == HYBRID) & ~(
            red & c2s & prev_red)
        if fade.any():
            self.celt_start[fade] = 0
            fbuf = torch.full((b, 2), 0xFF, dtype=torch.uint8, device=dev)
            flen = torch.as_tensor(np.where(fade, 2, 0), device=dev)
            tmp = torch.zeros((b, cc, f20), dtype=torch.float32, device=dev)
            self._celt_decode(self._groups(fade, np.full(b, f2_5), endband,
                                           0, sc), fbuf, flen, None, tmp)
            fl = torch.as_tensor(fade, device=dev)[:, None, None]
            pcm[:, :, :f2_5] = torch.where(
                fl, pcm[:, :, :f2_5] + tmp[:, :, :f2_5], pcm[:, :, :f2_5])
            self._count("fade_hybrid_to_silk", int(fade.sum()))

        # (g) the 5 ms SILK -> CELT redundant frame and its fade (:451-460)
        g_lanes = red & ~c2s
        if g_lanes.any():
            self._celt_reset(g_lanes)
            self.celt_start[g_lanes] = 0
            rr, _re = self._celt_decode(
                self._groups(g_lanes, np.full(b, f5), endband, 0, sc),
                rbuf, rlens, None, red_pcm)
            red_rng = torch.where(torch.as_tensor(g_lanes, device=dev), rr,
                                  red_rng)
            for n in np.unique(size[g_lanes]):
                m = torch.as_tensor(g_lanes & (size == n), device=dev)
                a = int(n) - f2_5
                faded = _smooth_fade(pcm[:, :, a:a + f2_5],
                                     red_pcm[:, :, f2_5:f5], inc, dev)
                pcm[:, :, a:a + f2_5] = torch.where(
                    m[:, None, None], faded, pcm[:, :, a:a + f2_5])
            self._count("redundancy_silk_to_celt", int(g_lanes.sum()))

        # (h) CELT -> SILK: the redundant audio spliced in (:461-468)
        h_lanes = red & c2s & ((prev != SILK) | prev_red)
        if h_lanes.any():
            m = torch.as_tensor(h_lanes, device=dev)[:, None, None]
            head = torch.where(m, red_pcm[:, :, :f2_5], pcm[:, :, :f2_5])
            mid = torch.where(m, _smooth_fade(red_pcm[:, :, f2_5:f5],
                                              pcm[:, :, f2_5:f5], inc, dev),
                              pcm[:, :, f2_5:f5])
            pcm[:, :, :f2_5] = head
            pcm[:, :, f2_5:f5] = mid

        # (i) the transition crossfade (:469-479)
        if transition.any():
            long_ = torch.as_tensor(transition & (size >= f5),
                                    device=dev)[:, None, None]
            short = torch.as_tensor(transition & (size < f5),
                                    device=dev)[:, None, None]
            head = torch.where(long_, pcm_tr[:, :, :f2_5], pcm[:, :, :f2_5])
            head = torch.where(short, _smooth_fade(
                pcm_tr[:, :, :f2_5], pcm[:, :, :f2_5], inc, dev), head)
            mid = torch.where(long_, _smooth_fade(
                pcm_tr[:, :, f2_5:f5], pcm[:, :, f2_5:f5], inc, dev),
                pcm[:, :, f2_5:f5])
            pcm[:, :, :f2_5] = head
            pcm[:, :, f2_5:f5] = mid
            self._count("transition", int(transition.sum()))

        # (j) the gain, the final range, the mode memory (:481-488)
        gl = on & (self.decode_gain != 0)
        if gl.any():
            g = torch.as_tensor(np.where(gl, 2.0 ** (
                6.48814081e-4 * self.decode_gain), 1.0), dtype=torch.float32,
                device=dev)
            pcm.mul_(g[:, None, None])
        self.rng = torch.where(torch.as_tensor(on, device=dev),
                               rng ^ red_rng, self.rng)
        bad = (k1_err | sil_err).cpu().numpy() & on
        self.flagged |= bad
        self.prev_mode[on] = mode[on]
        self.prev_redundancy[on] = (red & ~c2s)[on]
        self._count("frames", int(on.sum()))

    def _groups(self, lanes, n, endband, start, channels):
        """{(n, start, end, C): lanes [B] bool} over ``lanes``."""
        start = np.broadcast_to(np.asarray(start), lanes.shape)
        out = {}
        for i in np.nonzero(lanes)[0]:
            key = (int(n[i]), int(start[i]), int(endband[i]),
                   int(channels[i]))
            if key not in out:
                out[key] = np.zeros(self.batch, bool)
            out[key][i] = True
        return out
