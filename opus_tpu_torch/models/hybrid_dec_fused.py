"""Hybrid (SILK + CELT) decode, packets -> 48 kHz PCM, mono, 20 ms.

Port of ``opus_tpu/models/hybrid_dec_fused.py`` (``hybrid_init_state``,
``fused_hybrid_decode``, ``FusedHybridDecoder``).  One range decoder runs
through both halves, as in the reference frame loop
(src/opus_decoder.c:432-646):

1. the SILK decoder (``fused_silk_decode``, kernel K4) decodes the 16 kHz
   low band and hands back its live range-decoder dict;
2. the redundancy signal is parsed on the lanes (:522-541); lanes that
   carry redundancy set ``error`` (the 5 ms CELT redundancy frame and its
   crossfade are a mode-transition feature, not the steady-state path);
3. the CELT half continues from that coder over bands 17..end
   (``kernel_celt_decode_to_pcm`` with ``d0``, kernel K1 at start 17,
   then the synthesis with K2), reading ``lens - redundancy bytes`` as
   the scalar decoder shrinks ``dec.storage``;
4. SILK's output, enhanced by LACE or NoLACE when OSCE is on, one 16 kHz
   sample late through the decoder's mono 2-sample buffer (``smid``,
   silk/dec_API.c sStereo.sMid; the resampler reads from its second
   sample), is upsampled to 48 kHz (``silk/resampler.py``, or the neural
   bandwidth extension in its place, ``dnn/bbwe.py``) and the CELT
   synthesis is added on top.

Held to the scalar ``opus_tpu/models/opus_decoder.py`` ``OpusDecoder``
(final range equal, PCM within float tolerance), which, unlike the JAX
fused path, does the CELT half's special hybrid folding and delays
SILK's output by that one sample before the upsampler.  The JAX fused
path has no OSCE and no BBWE; the scalar decoder enhances the SILK half
of a hybrid frame as a SILK-only one (silk/decoder.py decode_frame) and
hands it to BBWE at 48 kHz (silk/api.py).  Loss (``fused_hybrid_conceal``,
``fec``): the SILK concealment or LBRR frame under the CELT noise
concealment at start band 17, accumulated (opus_decoder.py:248-278,
:363, :432).  Scope: mono, 20 ms, steady-state hybrid (no mode
transitions, no redundancy); out-of-envelope lanes set ``error``.
"""

from __future__ import annotations

import torch

from ..dnn.bbwe import BBWE
from ..dnn.osce import OSCEEnhancer
from ..ops import rc_kernel as K
from ..celt.plc import decode_lost
from ..ops.lanes import lane_mask, select_lanes
from ..silk.resampler import upsampler_init
from .celt_dec_fused import fused_celt_init_state
from .celt_dec_kernel import dec_tabs, kernel_celt_decode_to_pcm
from .fused_silk_dec import (fused_init_state, fused_silk_conceal,
                             fused_silk_decode, silk_out_48k)

HYBRID_START = 17          # the first CELT band of a hybrid frame


def hybrid_init_state(batch: int, tabs, device="cpu") -> dict:
    """The per-stream state: ``silk`` (fused_init_state at 16 kHz; its
    ``decoded_any`` is the stream's), ``celt`` (fused_celt_init_state),
    ``rs`` (the upsampler's) and ``smid`` [B, 2] (the last two 16 kHz
    samples of the previous frame)."""
    return dict(silk=fused_init_state(batch, 16, device),
                celt=fused_celt_init_state(batch, tabs, device),
                rs=upsampler_init(batch, 16, device),
                smid=torch.zeros((batch, 2), dtype=torch.int64,
                                 device=device))


def _celt_conceal(celt: dict, tabs, lanes):
    """The CELT half of a concealed or FEC-decoded hybrid frame: the noise
    concealment at start band 17 (``celt/plc.decode_lost``, K2 for its
    de-emphasis) on ``lanes``, whatever the CELT half decoded before (the
    Opus decoder has gated the lanes: src/opus_decoder.c:593-612, and its
    FEC path conceals even a stream's first frame).  Returns (pcm [B,
    960] f32, the new CELT state)."""
    pcm, st, _trace = decode_lost(
        dict(celt, decoded_any=torch.ones_like(celt["decoded_any"])), tabs,
        lanes)
    return pcm[:, 0, :], dict(st, decoded_any=celt["decoded_any"])


def fused_hybrid_decode(buf, lens, state: dict, tabs, frame_fn=None,
                        osce=None, bwe=None, fec=None, active=None):
    """One 20 ms hybrid frame per stream on the tensors' device.

    buf: [B, P] uint8 frame payload bytes (no TOC); lens: [B] byte
    lengths; tabs: a start-17 ``DecTabs``; frame_fn: the CELT symbol
    pass (default kernel K1's wrapper); osce: an ``OSCEEnhancer`` for the
    SILK half, bwe: a ``BBWE`` in the upsampler's place (each optional,
    carrying its own state).  ``fec`` ([B] bool): lanes that decode the
    SILK half's LBRR frame (or conceal it where the packet has none) and
    conceal the CELT half (src/opus_decoder.c:363, :432, :606);
    ``active`` ([B] bool): lanes outside it decode nothing (K1 does not
    run when no active lane decodes a regular frame).  Returns (pcm [B,
    960] f32, new state, error [B] bool); the final range is the new
    state's ``celt["seed"]`` (the CELT coder's, or on FEC lanes the
    concealment's LCG state: opus_decoder.py:608), which the enhancement
    never touches."""
    assert tabs.start == HYBRID_START
    lens = lens.to(torch.int64).clamp(0, buf.shape[1])
    b = buf.shape[0]
    act = lane_mask(active, b, buf.device)
    fl = torch.zeros_like(act) if fec is None else lane_mask(fec, b,
                                                             buf.device)
    reg = act & ~fl

    # ---- SILK low band, 16 kHz internal (src/opus_decoder.c:461) ----
    xq16, silk_state, err, d, *osce_in = fused_silk_decode(
        buf, lens, state["silk"], fs_khz=16, nb_subfr=4, return_rc=True,
        return_osce=osce is not None, lbrr=fec, active=active)
    if osce is not None:
        xq16 = osce.enhance_frame(xq16, **osce_in[0])

    pcm_c = torch.zeros((b, 960), dtype=torch.float32, device=buf.device)
    celt_state = state["celt"]
    if bool(reg.any()):
        # ---- redundancy signalling (src/opus_decoder.c:522-541) ----
        can_red = reg & (K.rk_tell(d) + 17 + 20 <= 8 * lens)
        red_bit, d = K.rk_dec_bit_logp(d, buf, lens, 12, can_red)
        red = can_red & (red_bit != 0)
        red_bytes = torch.zeros_like(lens)
        if bool(red.any()):
            _c2s, d = K.rk_dec_bit_logp(d, buf, lens, 1, red)
            rb, d = K.rk_dec_uint(d, buf, lens, 256, red)
            red_bytes = torch.where(red, rb + 2, 0)
        lens2 = lens - red_bytes
        err = err | red | (lens2 * 8 < K.rk_tell(d)) | (d["error"] != 0)

        # ---- CELT high band from the same coder, start 17 (:595-608) ----
        pcm3, celt_state, err_c = kernel_celt_decode_to_pcm(
            buf, lens2, state["celt"], tabs, frame_fn, d0=d)
        pcm_c = pcm3[:, 0, :]
        err = err | err_c
    if fec is not None and bool(fl.any()):
        pcm_f, st_f = _celt_conceal(state["celt"], tabs, fl)
        pcm_c = torch.where(fl[:, None], pcm_f, pcm_c)
        celt_state = select_lanes(fl, st_f, celt_state)

    # ---- 16 -> 48 kHz upsample, then accumulate (:476, :608) ----
    silk48, rs_state, smid = silk_out_48k(xq16, state["smid"], state["rs"],
                                          bwe, 20)
    pcm = pcm_c + silk48.to(torch.float32) * (1.0 / 32768.0)
    return pcm, dict(silk=silk_state, celt=celt_state, rs=rs_state,
                     smid=smid), err


def fused_hybrid_conceal(state: dict, tabs, lanes):
    """One lost hybrid frame (src/opus_decoder.c:404-612 with data ==
    NULL): the SILK concealment at 16 kHz (``fused_silk_conceal``, the
    packet-loss path's gain index reset included) upsampled to 48 kHz,
    the CELT noise concealment at start band 17 added on top.  Every lane
    runs; the CELT half's state moves only on ``lanes``.  Returns (pcm [B,
    960] f32, new state)."""
    xq16, silk_state = fused_silk_conceal(state["silk"], fs_khz=16,
                                          nb_subfr=4)
    silk_state["last_gain_index"] = torch.full_like(
        silk_state["last_gain_index"], 10)
    silk48, rs_state, smid = silk_out_48k(xq16, state["smid"], state["rs"],
                                          None, 20)
    pcm_c, celt_state = _celt_conceal(state["celt"], tabs, lanes)
    pcm = pcm_c + silk48.to(torch.float32) * (1.0 / 32768.0)
    return pcm, dict(silk=silk_state, celt=celt_state, rs=rs_state,
                     smid=smid)


class FusedHybridDecoder:
    """Packets-in -> 48 kHz-PCM-out mono hybrid decoder at 20 ms with
    everything on the card (the default device; kernels K1, K2 and K4),
    the plain torch versions when ``device="cpu"``.  end: the last CELT
    band + 1 (21 fullband, 19 superwideband).  ``set_osce`` and
    ``set_osce_bwe`` switch on OSCE for the SILK half and BBWE in the
    upsampler's place, as on ``FusedSilkDecoder``.  Loss, lane by lane:
    ``conceal(lanes)``, ``decode_packed(..., fec=lanes)`` (the SILK
    half's LBRR frame, the CELT half concealed), ``decode_packed(...,
    active=lanes)`` and ``reset(lanes)``, as on ``FusedSilkDecoder``
    (none of them with OSCE or BBWE on)."""

    def __init__(self, batch: int, end: int = 21, max_payload: int = 512,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FusedHybridDecoder: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.batch = batch
        self.P = max_payload
        self.tabs = dec_tabs(48000, 960, HYBRID_START, end)
        self.osce = None             # the OSCEEnhancer, if switched on
        self.bwe = None              # the BBWE, if switched on
        self.reset()

    def set_osce(self, method: int, model) -> None:
        """LACE (1) or NoLACE (2) enhancement of the SILK half with
        ``model`` (the port's ``dnn.osce`` model on the decoder's device);
        0 switches it off (src/opus_decoder.c:443-455)."""
        self.osce = OSCEEnhancer(method, model, self.batch,
                                 device=self.device) if method else None

    def set_osce_bwe(self, model) -> None:
        """BBWE with ``model`` (the port's ``dnn.bbwe`` model) in place of
        the SILK half's upsampler; None switches it off."""
        self.bwe = BBWE(model, self.batch, device=self.device) \
            if model is not None else None

    def _plain_only(self, what: str) -> None:
        if self.osce is not None or self.bwe is not None:
            raise ValueError(f"FusedHybridDecoder: {what} with OSCE or BBWE "
                             f"on is not ported")

    @property
    def final_range(self):
        """[B] each lane's final range after its last frame: the range
        decoder's, the CELT concealment's LCG state after an FEC frame,
        0 after a concealment (src/opus_decoder.c:334, :608)."""
        return self._rng

    def pack(self, payloads):
        """list of B byte strings -> (buf [B, P] uint8, lens [B]) on the
        decoder's device; raises ValueError on a payload longer than P."""
        return K.pack_payloads(payloads, self.batch, self.P, self.device)

    def _commit(self, m, state, rng):
        """The lanes of m ([B] bool, None: every lane) take the new state
        and final range; the others keep theirs bit for bit."""
        if m is None:
            self.state, self._rng = state, rng
            return
        self.state = select_lanes(m, state, self.state)
        self._rng = torch.where(m, rng, self._rng)

    def decode_packed(self, buf_u8, lens, active=None, fec=None):
        """buf [B, P] uint8, lens [B] on the device -> (pcm [B, 960] f32,
        err [B] bool).  ``fec`` ([B] bool): those lanes decode the SILK
        half's LBRR frame and conceal the CELT half; ``active`` ([B]
        bool, default every lane): a lane outside it keeps its state bit
        for bit, returns zeros and raises no error flag."""
        if active is not None or fec is not None:
            self._plain_only("active or fec")
        pcm, state, err = fused_hybrid_decode(
            buf_u8, lens, self.state, self.tabs, osce=self.osce,
            bwe=self.bwe, fec=fec, active=active)
        if active is None:
            self._commit(None, state, state["celt"]["seed"])
            return pcm, err
        m = lane_mask(active, self.batch, self.device)
        self._commit(m, state, state["celt"]["seed"])
        return torch.where(m[:, None], pcm, 0.0), err & m

    def conceal(self, lanes=None):
        """One lost frame on the lanes of ``lanes`` ([B] bool, default every
        lane) -> pcm [B, 960] f32; the other lanes, and a lane that has
        decoded no packet yet, keep their state bit for bit and return
        zeros."""
        self._plain_only("conceal")
        m = lane_mask(lanes, self.batch, self.device) \
            & self.state["silk"]["decoded_any"]
        if not bool(m.any()):
            return torch.zeros((self.batch, 960), dtype=torch.float32,
                               device=self.device)
        pcm, state = fused_hybrid_conceal(self.state, self.tabs, m)
        self._commit(m, state, torch.zeros_like(self._rng))
        return torch.where(m[:, None], pcm, 0.0)

    def reset(self, lanes=None):
        """The lanes of ``lanes`` ([B] bool, default every lane) back to the
        decoder's initial state (and the enhancers', if on)."""
        state = hybrid_init_state(self.batch, self.tabs, self.device)
        rng = torch.zeros((self.batch,), dtype=torch.int64,
                          device=self.device)
        self._commit(None if lanes is None else lane_mask(
            lanes, self.batch, self.device), state, rng)
        for enh in (self.osce, self.bwe):
            if enh is not None:
                enh.reset(lanes)

    def decode(self, payloads):
        return self.decode_packed(*self.pack(payloads))
