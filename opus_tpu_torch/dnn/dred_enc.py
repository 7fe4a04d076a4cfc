"""The DRED encoder state for a batch of streams: port of
``opus_tpu/dnn/dred_enc.py`` (``DREDEnc``; reference: dnn/dred_encoder.c).

Every lane runs the reference's encoder on its own PCM, and the lanes
advance in lockstep (one sample rate, frame size and extra delay), so the
fills and offsets are host ints shared by all of them:

- the input is downmixed and resampled to 16 kHz (``convert_to_16k``: the
  elliptic anti-alias filters of dred_encoder.c:180-230, a float64
  recurrence on the device, one step a sample over [B] lanes x 8 taps);
- every 20 ms of 16 kHz audio, two 10 ms LPCNet feature frames
  (``features.compute_frame_features``) feed the RDOVAE encoder
  (``rdovae.encode_dframe``), whose latent and initial state are pushed,
  newest first, into a [B, DRED_MAX_FRAMES] ring on the device;
- at packet time ``encode_payloads`` quantizes every lane's ladder in one
  device call (``dred.quantize_latents``), copies the integers to the
  host once and range-codes each lane there (``dred.dred_encode``), as the
  decoder side's ``parse_batch`` parses per lane.

Each step follows the numpy reference's dtypes: float64 for the filter and
the int16 rounding, float32 for the buffered 16 kHz samples, the features
and the networks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dred, features as feat, rdovae
from .nnet import to_device
from .pitchdnn import PitchDNNModel

RESAMPLING_ORDER = 8
FRAME16 = 2 * feat.FRAME_SIZE        # 20 ms at 16 kHz: one RDOVAE step

# ellip(7, .2, 70, ...) anti-alias filters (reference:
# dred_encoder.c:180-230; direct-form II transposed, b0 separate)
_FILTERS = {
    48000: (0.004523418224,
            (0.005873358047, 0.012980854831, 0.014531340042,
             0.014531340042, 0.012980854831, 0.005873358047,
             0.004523418224, 0.0),
            (-3.878718597768, 7.748834257468, -9.653651699533,
             8.007342726666, -4.379450178552, 1.463182111810,
             -0.231720677804, 0.0)),
    12000: (0.002033596776,
            (-0.001017101081, 0.003673127243, 0.001009165267,
             0.001009165267, 0.003673127243, -0.001017101081,
             0.002033596776, 0.0),
            (-4.930414411612, 11.291643096504, -15.322037343815,
             13.216403930898, -7.220409219553, 2.310550142771,
             -0.334338618782, 0.0)),
    8000: (0.020109185709,
           (0.081670120929, 0.180401598565, 0.259391051971,
            0.259391051971, 0.180401598565, 0.081670120929,
            0.020109185709, 0.0),
           (-1.393651933659, 2.609789872676, -2.403541968806,
            2.056814957331, -1.148908574570, 0.473001413788,
            -0.110359852412, 0.0)),
}
_FILTERS[24000] = _FILTERS[48000]
# the zero-stuffing factor that brings each rate to 16 or 48 kHz
_UP = {8000: 2, 12000: 4, 16000: 1, 24000: 2, 48000: 1}


def filter_df2t(x, b0: float, b, a, mem):
    """(reference: filter_df2t dred_encoder.c:113) over [B] lanes in
    float64, one step a sample, the 8 taps at once:
    y = x b0 + mem[0]; mem[:8] = (mem[1:9] + b x) + a (-y), each product
    and sum rounded as the numpy loop rounds it (a (-y) = -(a y) exactly,
    so the update subtracts a y).  x: [B, N] f64; mem: [B, 9] f64, its
    last entry never written (the taps' ninth coefficients are 0).
    Returns (y [B, N] f64, new mem)."""
    dev = x.device
    xt = x.t().contiguous()                               # [N, B]
    bv = torch.tensor(b, dtype=torch.float64, device=dev)
    av = torch.tensor(a, dtype=torch.float64, device=dev)
    p = xt * b0
    bx = xt[:, :, None] * bv                              # [N, B, 8]
    m = mem.clone()
    y = torch.empty_like(xt)
    w = torch.empty((x.shape[0], RESAMPLING_ORDER), dtype=torch.float64,
                    device=dev)
    z = torch.empty_like(w)
    for i in range(xt.shape[0]):
        torch.add(p[i], m[:, 0], out=y[i])
        torch.add(m[:, 1:], bx[i], out=w)
        torch.mul(av, y[i, :, None], out=z)
        torch.sub(w, z, out=m[:, :RESAMPLING_ORDER])
    return y.t(), m


def float2int16(x):
    """floor(0.5 + clip(32768 x, -32768, 32767)) in x's dtype (float64
    here), as ``opus_tpu/dnn/dred_enc.py:63``."""
    return torch.floor(0.5 + torch.clamp(x * 32768.0, -32768, 32767))


def convert_to_16k(pcm, fs: int, channels: int, mem, out_len: int):
    """(reference: dred_convert_to_16k dred_encoder.c:136) for [B] lanes.
    pcm: [B, N * channels] float64, interleaved; mem: [B, 9] the filter
    state (float64).  Returns (out_len samples at 16 kHz, float32 in
    int16 scale, new mem)."""
    up = _UP[fs]
    if channels == 1:
        mono = float2int16(pcm) * up
    else:
        mono = float2int16(0.5 * (pcm[:, 0::2] + pcm[:, 1::2])) * up
    mono = mono + 1e-30
    b, n = mono.shape
    downmix = torch.zeros((b, up * n), dtype=torch.float64,
                          device=pcm.device)
    downmix[:, ::up] = mono
    if fs == 16000:
        return downmix[:, :out_len].to(torch.float32), mem
    b0, bb, aa = _FILTERS[fs]
    y, mem = filter_df2t(downmix, b0, bb, aa, mem)
    if fs == 8000:
        return y[:, :out_len].to(torch.float32), mem
    return y[:, ::3][:, :out_len].to(torch.float32), mem


class BatchedDREDEnc:
    """``DREDEnc`` for B streams on one device (the card by default;
    ``device="cpu"`` for the plain CPU run).  The ring holds the
    latents [B, DRED_MAX_FRAMES, 80] and initial states [B,
    DRED_MAX_FRAMES, 24], newest first; ``input_buffer`` [B, fill] the
    16 kHz samples not yet analysed.  Host ints: ``latents_buffer_fill``,
    ``dred_offset``, ``latent_offset``."""

    def __init__(self, fs: int, channels: int, enc_model: rdovae.RDOVAEEnc,
                 pitch_model: PitchDNNModel, stats: dred.DREDStats,
                 batch: int, device="cuda"):
        if fs not in _UP:
            raise ValueError(f"BatchedDREDEnc: unsupported rate {fs}")
        if channels not in (1, 2):
            raise ValueError("BatchedDREDEnc: mono or stereo only")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedDREDEnc: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.fs = fs
        self.channels = channels
        self.batch = batch
        self.model = to_device(enc_model, self.device)
        self.pitch_model = to_device(pitch_model, self.device)
        self.stats = stats
        self._tabs = {k: torch.as_tensor(np.asarray(getattr(stats, k),
                                                    np.float32),
                                         device=self.device)
                      for k in ("latent_scale", "latent_dead_zone",
                                "state_scale", "state_dead_zone")}
        self.reset()

    def reset(self):
        b, dev = self.batch, self.device
        self.feat_state = feat.init_state(b, device=dev)
        self.rdovae_state = rdovae.enc_init_state((b,), device=dev)
        self.input_buffer = torch.zeros((b, 0), device=dev)
        self.resample_mem = torch.zeros((b, RESAMPLING_ORDER + 1),
                                        dtype=torch.float64, device=dev)
        self.latents = torch.zeros((b, dred.DRED_MAX_FRAMES,
                                    rdovae.DRED_LATENT_DIM), device=dev)
        self.states = torch.zeros((b, dred.DRED_MAX_FRAMES,
                                   rdovae.DRED_STATE_DIM), device=dev)
        self.latents_buffer_fill = 0
        self.dred_offset = 0
        self.latent_offset = 0
        self.quantized = None

    @property
    def input_buffer_fill(self) -> int:
        return self.input_buffer.shape[1]

    def process_frame(self, frame16):
        """(reference: dred_process_frame dred_encoder.c:88): two feature
        frames of 20 ms at 16 kHz ([B, 320] f32) -> one RDOVAE step, its
        latent and state pushed at the front of the ring."""
        fbuf = []
        for k in range(2):
            self.feat_state, f = feat.compute_frame_features(
                self.feat_state,
                frame16[:, k * feat.FRAME_SIZE:(k + 1) * feat.FRAME_SIZE],
                self.pitch_model)
            fbuf.append(f[:, :rdovae.DRED_NUM_FEATURES])
        self.rdovae_state, lat, ist = rdovae.encode_dframe(
            self.model, self.rdovae_state, torch.cat(fbuf, dim=1))
        self.latents = torch.cat([lat[:, None], self.latents[:, :-1]], dim=1)
        self.states = torch.cat([ist[:, None], self.states[:, :-1]], dim=1)
        self.latents_buffer_fill = min(self.latents_buffer_fill + 1,
                                       dred.DRED_NUM_REDUNDANCY_FRAMES)

    def compute_latents(self, pcm, frame_size: int, extra_delay: int = 0):
        """(reference: dred_compute_latents dred_encoder.c:211).  pcm:
        [B, frame_size * channels] on the device.  Returns the frame's
        16 kHz samples [B, frame_size * 16000 / fs] f32 (int16 scale)."""
        pcm = pcm.to(self.device, torch.float64)
        frame_size16k = frame_size * 16000 // self.fs
        curr_offset16k = 40 + extra_delay * 16000 // self.fs \
            - self.input_buffer_fill
        self.dred_offset = math.floor((curr_offset16k + 20.0) / 40.0)
        self.latent_offset = 0
        pos = 0
        out = []
        ch = self.channels
        while frame_size16k > 0:
            process16k = min(FRAME16, frame_size16k)
            process = process16k * self.fs // 16000
            x16, self.resample_mem = convert_to_16k(
                pcm[:, pos * ch:(pos + process) * ch], self.fs, ch,
                self.resample_mem, process16k)
            out.append(x16)
            self.input_buffer = torch.cat([self.input_buffer, x16], dim=1)
            if self.input_buffer_fill >= FRAME16:
                curr_offset16k += FRAME16
                self.process_frame(self.input_buffer[:, :FRAME16])
                self.input_buffer = self.input_buffer[:, FRAME16:]
                if self.dred_offset < 6:
                    self.dred_offset += 8
                else:
                    self.latent_offset += 1
            pos += process
            frame_size16k -= process16k
        return torch.cat(out, dim=1)

    def quantize(self, latent_offset, max_chunks: int, q0: int, dq: int,
                 qmax: int) -> dict:
        """Every lane's ladder quantized in one device pass: chunk c the
        latent 2c + latent_offset[lane] at level
        ``compute_quantizer(q0, dq, qmax, c)``, the state at
        latent_offset[lane] at level q0.  Returns, on the device, the
        gathered floats ``x_latents`` [B, C, 80] and ``x_state`` [B, 24],
        their int32 codes ``q_*`` and their float32 values before
        rounding ``v_*``."""
        dev = self.device
        lo = torch.as_tensor(np.asarray(latent_offset), device=dev)
        c = torch.arange(max_chunks, device=dev)
        idx = torch.clamp(2 * c[None] + lo[:, None],
                          max=dred.DRED_MAX_FRAMES - 1)
        lat = torch.gather(self.latents, 1, idx[..., None].expand(
            -1, -1, rdovae.DRED_LATENT_DIM))
        levels = torch.as_tensor(
            [dred.compute_quantizer(q0, dq, qmax, k)
             for k in range(max_chunks)], device=dev)
        ql, vl = dred.quantize_latents(lat,
                                       self._tabs["latent_scale"][levels],
                                       self._tabs["latent_dead_zone"][levels])
        st = self.states[torch.arange(self.batch, device=dev), lo]
        qs, vs = dred.quantize_latents(st, self._tabs["state_scale"][q0],
                                       self._tabs["state_dead_zone"][q0])
        return dict(x_latents=lat, q_latents=ql, v_latents=vl, x_state=st,
                    q_state=qs, v_state=vs)

    def encode_payloads(self, activity_mem, max_chunks: int, max_bytes,
                        q0: int = dred.DRED_ENC_Q0, dq: int = 3,
                        qmax: int = dred.DRED_ENC_Q1):
        """Every lane's payload (``DREDEnc.encode_payload``, without the
        experimental version prefix).  activity_mem: [B, 4 *
        DRED_MAX_FRAMES] uint8 numpy; max_bytes: an int or a [B] sequence
        (None: leave the lane out).  The quantization runs on the device,
        the range coding per lane on the host; ``self.quantized`` keeps
        ``quantize``'s tensors with the lanes' ``latent_offset`` and coded
        ``chunks``.  Returns ([B] payload bytes or None, [B] coded latent
        chunks)."""
        b = self.batch
        if isinstance(max_bytes, (int, np.integer)):
            max_bytes = [int(max_bytes)] * b
        nb = self.latents_buffer_fill
        lo = dred.latent_skip(activity_mem, nb)
        qd = self.quantize(lo, max_chunks, q0, dq, qmax)
        ints = torch.cat([qd["q_state"], qd["q_latents"].reshape(b, -1)],
                         dim=1).cpu().numpy()
        q_state = ints[:, :rdovae.DRED_STATE_DIM]
        q_lat = ints[:, rdovae.DRED_STATE_DIM:].reshape(
            b, max_chunks, rdovae.DRED_LATENT_DIM)
        payloads, chunks = [], []
        for i in range(b):
            if max_bytes[i] is None:
                payloads.append(None)
                chunks.append(0)
                continue
            p, n = dred.dred_encode(
                self.stats, q_state[i], q_lat[i], nb, self.dred_offset,
                activity_mem[i], int(lo[i]), q0=q0, dq=dq, qmax=qmax,
                max_chunks=max_chunks, max_bytes=max_bytes[i])
            payloads.append(p)
            chunks.append(n)
        self.quantized = dict(qd, latent_offset=lo,
                              chunks=np.asarray(chunks, np.int64))
        return payloads, chunks
