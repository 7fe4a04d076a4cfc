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
hands it to BBWE at 48 kHz (silk/api.py).  Scope: mono, 20 ms,
steady-state hybrid (no mode transitions, no redundancy, no loss);
out-of-envelope lanes set ``error``.
"""

from __future__ import annotations

import torch

from ..dnn.bbwe import BBWE
from ..dnn.osce import OSCEEnhancer
from ..ops import rc_kernel as K
from ..silk.resampler import upsampler_init
from .celt_dec_fused import fused_celt_init_state
from .celt_dec_kernel import dec_tabs, kernel_celt_decode_to_pcm
from .fused_silk_dec import fused_init_state, fused_silk_decode, silk_out_48k

HYBRID_START = 17          # the first CELT band of a hybrid frame


def hybrid_init_state(batch: int, tabs, device="cpu") -> dict:
    """The per-stream state: ``silk`` (fused_init_state at 16 kHz),
    ``celt`` (fused_celt_init_state), ``rs`` (the upsampler's) and
    ``smid`` [B, 2] (the last two 16 kHz samples of the previous frame)."""
    return dict(silk=fused_init_state(batch, 16, device),
                celt=fused_celt_init_state(batch, tabs, device),
                rs=upsampler_init(batch, 16, device),
                smid=torch.zeros((batch, 2), dtype=torch.int64,
                                 device=device))


def fused_hybrid_decode(buf, lens, state: dict, tabs, frame_fn=None,
                        osce=None, bwe=None):
    """One 20 ms hybrid frame per stream on the tensors' device.

    buf: [B, P] uint8 frame payload bytes (no TOC); lens: [B] byte
    lengths; tabs: a start-17 ``DecTabs``; frame_fn: the CELT symbol
    pass (default kernel K1's wrapper); osce: an ``OSCEEnhancer`` for the
    SILK half, bwe: a ``BBWE`` in the upsampler's place (each optional,
    carrying its own state).  Returns (pcm [B, 960] f32, new state, error
    [B] bool); the final range is the new state's ``celt["seed"]``, which
    the enhancement never touches."""
    assert tabs.start == HYBRID_START
    lens = lens.to(torch.int64).clamp(0, buf.shape[1])

    # ---- SILK low band, 16 kHz internal (src/opus_decoder.c:461) ----
    xq16, silk_state, err, d, *osce_in = fused_silk_decode(
        buf, lens, state["silk"], fs_khz=16, nb_subfr=4, return_rc=True,
        return_osce=osce is not None)
    if osce is not None:
        xq16 = osce.enhance_frame(xq16, **osce_in[0])

    # ---- redundancy signalling (src/opus_decoder.c:522-541) ----
    can_red = K.rk_tell(d) + 17 + 20 <= 8 * lens
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
    pcm_c, celt_state, err_c = kernel_celt_decode_to_pcm(
        buf, lens2, state["celt"], tabs, frame_fn, d0=d)
    err = err | err_c

    # ---- 16 -> 48 kHz upsample, then accumulate (:476, :608) ----
    silk48, rs_state, smid = silk_out_48k(xq16, state["smid"], state["rs"],
                                          bwe, 20)
    pcm = pcm_c[:, 0, :] + silk48.to(torch.float32) * (1.0 / 32768.0)
    return pcm, dict(silk=silk_state, celt=celt_state, rs=rs_state,
                     smid=smid), err


class FusedHybridDecoder:
    """Packets-in -> 48 kHz-PCM-out mono hybrid decoder at 20 ms with
    everything on the card (the default device; kernels K1, K2 and K4),
    the plain torch versions when ``device="cpu"``.  end: the last CELT
    band + 1 (21 fullband, 19 superwideband).  ``set_osce`` and
    ``set_osce_bwe`` switch on OSCE for the SILK half and BBWE in the
    upsampler's place, as on ``FusedSilkDecoder``."""

    def __init__(self, batch: int, end: int = 21, max_payload: int = 512,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FusedHybridDecoder: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.batch = batch
        self.P = max_payload
        self.tabs = dec_tabs(48000, 960, HYBRID_START, end)
        self.state = hybrid_init_state(batch, self.tabs, self.device)
        self.osce = None             # the OSCEEnhancer, if switched on
        self.bwe = None              # the BBWE, if switched on

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

    @property
    def final_range(self):
        """[B] the range decoder's final state of the last frame."""
        return self.state["celt"]["seed"]

    def pack(self, payloads):
        """list of B byte strings -> (buf [B, P] uint8, lens [B]) on the
        decoder's device; raises ValueError on a payload longer than P."""
        return K.pack_payloads(payloads, self.batch, self.P, self.device)

    def decode_packed(self, buf_u8, lens):
        """buf [B, P] uint8, lens [B] on the device -> (pcm [B, 960] f32,
        err [B] bool)."""
        pcm, self.state, err = fused_hybrid_decode(
            buf_u8, lens, self.state, self.tabs, osce=self.osce, bwe=self.bwe)
        return pcm, err

    def decode(self, payloads):
        return self.decode_packed(*self.pack(payloads))
