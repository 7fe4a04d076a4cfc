"""Packets -> PCM at 2.5-20 ms with the symbol pass of kernel K1.

Port of ``opus_tpu/models/celt_dec_kernel.py`` (``build_frame_fn``'s
``fn``, ``kernel_celt_decode_to_pcm`` and ``KernelCeltDecoder``).
``decode_frame`` is the wrapper of kernel K1: a CPU tensor runs the plain
torch symbol pass (``celt_dec_fused.fused_celt_decode_frame``), a CUDA
tensor runs the hand-written CUDA kernel
(``opus_tpu_torch/csrc/celt_dec_frame.cu``) or raises.  The TPU-only
parts of the JAX module (the ``batch % 1024`` rule, the [W, R, 128]
word packing, the node program and the wrapper matrices) are gone: the
kernel reads each stream's bytes from ``buf [B, P]`` directly.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..celt.plc import channel_state, decode_lost, fold_tails, from_rows, \
    to_rows
from ..celt.tables import COMB_GAINS, COMBFILTER_MINPERIOD
from ..ops.device_cache import const
from ..ops.lanes import lane_mask, select_lanes
from ..ops.rc_kernel import M32, ilog, pack_payloads, pack_state
from .celt_dec_fused import DecTabs, fused_celt_decode_frame, \
    fused_celt_init_state
from .batched_decode import decode_step

INT_KEYS = ("silence", "is_transient", "intra", "anti_collapse_on",
            "pf_pitch", "pf_tapset", "error", "tell", "rng")

# launches of kernel K1's mono and two-channel instantiations (counted
# where the kernel is launched, only there)
launches = 0
launches_stereo = 0

@lru_cache(maxsize=None)
def dec_tabs(fs: int = 48000, frame_size: int = 960, start: int = 0,
             end: int | None = None) -> DecTabs:
    return DecTabs(fs, frame_size, start, end)


def k1_table(tabs: DecTabs, device):
    """K1's flat table for ``tabs`` on ``device``, uploaded once; the key
    holds the band range, so decoders of several ranges (CELT-only and
    hybrid) in one process each get their own."""
    return const(("k1_table", int(tabs.mode.Fs), tabs.lm, tabs.start,
                  tabs.end_band), tabs.kernel_table, device)


def decode_frame(buf_u8, lens, old_e, prevmin, seed, tabs=None,
                 d0=None) -> dict:
    """One frame's mono CELT symbol pass for B streams over the coded
    bands [tabs.start, tabs.end_band).

    buf_u8 [B, P] uint8 packet bytes, lens [B] byte lengths (clamped to
    [0, P]), old_e/prevmin [B, nb] f32 (energy memory and min of the two
    previous frames' energies), seed [B] (uint32 values, int64); d0: the
    live range-decoder dict to continue from (a hybrid frame's SILK
    coder), or None to start one on the packet.  Returns X [B,
    M*eBands[nb]] (zero outside the coded bands), energies [B, nb] and
    pf_gain [B] (f32), and the int64 [B] lanes silence, is_transient,
    intra, anti_collapse_on, pf_pitch, pf_tapset, error, tell and rng."""
    tabs = dec_tabs() if tabs is None else tabs
    if buf_u8.device.type == "cpu":
        return decode_frame_plain(buf_u8, lens, old_e, prevmin, seed, tabs,
                                  d0)
    return _decode_frame_cuda(buf_u8, lens, old_e, prevmin, seed, tabs, d0)


def decode_frame_plain(buf_u8, lens, old_e, prevmin, seed, tabs,
                       d0=None) -> dict:
    """The plain torch version of kernel K1 (any device); it also returns
    ``pulses`` [B, nb], each band's bit allocation (8th bits).  X is zero
    on silence lanes, as K1 leaves it (the synthesis zeroes a silence
    frame's spectrum; at LM 0 the masked pass would leave the sign of the
    one-bin bands there)."""
    lens = lens.to(torch.int64).clamp(0, buf_u8.shape[1])
    nb = tabs.nb
    out, d = fused_celt_decode_frame(
        buf_u8, lens, [old_e[:, i] for i in range(nb)],
        [prevmin[:, i] for i in range(nb)], seed.to(torch.int64), tabs,
        torch.ones_like(lens, dtype=torch.bool), d0)
    res = {k: out[k].to(torch.int64) for k in INT_KEYS[:6]}
    silence = res["silence"] != 0
    res.update(X=torch.where(silence[:, None], 0.0, out["X"]), energies=torch.stack(out["energies"], dim=1),
               pf_gain=out["pf_gain"], error=d["error"],
               tell=d["nbits_total"] - ilog(d["rng"]), rng=d["rng"],
               pulses=torch.stack(out["pulses"], dim=1))
    return res


def decode_frame2(buf_u8, lens, old_e, prevmin, seed, tabs, d0=None,
                  disable_inv: bool = False) -> dict:
    """One frame's two-channel CELT symbol pass for B streams: the wrapper
    of K1's stereo instantiation (a CPU tensor runs its plain version,
    ``celt_dec_fused.fused_celt_decode_frame`` with two channels; a CUDA tensor
    launches the kernel or raises).  As ``decode_frame``, with old_e,
    prevmin and the returned energies [B, 2, nb] and X [B, 2, nx];
    disable_inv: the decoder's flag (1 with one output channel), which
    zeroes the inversion of the bands at and above the intensity band."""
    if buf_u8.device.type == "cpu":
        return decode_frame2_plain(buf_u8, lens, old_e, prevmin, seed, tabs,
                                   d0, disable_inv)
    return _decode_frame_cuda(buf_u8, lens, old_e, prevmin, seed, tabs, d0,
                              channels=2, disable_inv=disable_inv)


def decode_frame2_plain(buf_u8, lens, old_e, prevmin, seed, tabs, d0=None,
                        disable_inv: bool = False) -> dict:
    """The plain torch version of K1's stereo instantiation (any device);
    also returns ``pulses`` [B, nb], ``intensity`` and ``dual_stereo``
    [B]."""
    lens = lens.to(torch.int64).clamp(0, buf_u8.shape[1])
    nb = tabs.nb

    def lists(e):
        e = e.to(torch.float32)
        return [[e[:, c, i] for i in range(nb)] for c in range(2)]
    out, d = fused_celt_decode_frame(
        buf_u8, lens, lists(old_e), lists(prevmin), seed.to(torch.int64),
        tabs, torch.ones_like(lens, dtype=torch.bool), d0, bool(disable_inv))
    res = {k: out[k].to(torch.int64) for k in INT_KEYS[:6]}
    silence = res["silence"] != 0
    res.update(X=torch.where(silence[:, None, None], 0.0, out["X"]),
               energies=torch.stack([torch.stack(e, dim=1)
                                     for e in out["energies"]], dim=1),
               pf_gain=out["pf_gain"],
               error=d["error"], tell=d["nbits_total"] - ilog(d["rng"]),
               rng=d["rng"], pulses=torch.stack(out["pulses"], dim=1),
               intensity=out["intensity"],
               dual_stereo=out["dual_stereo"].to(torch.int64))
    return res


def _decode_frame_cuda(buf_u8, lens, old_e, prevmin, seed, tabs,
                       d0=None, lib=None, channels: int = 1,
                       disable_inv: bool = False) -> dict:
    """K1's launch (its mono or, channels=2, its stereo instantiation);
    lib: another build of its source (a profile build), else the port's
    library."""
    from ..cuda_build import check_launch, library

    global launches, launches_stereo
    dev = buf_u8.device
    if not buf_u8.is_cuda or any(t.device != dev for t in
                                 (lens, old_e, prevmin, seed)):
        raise ValueError("decode_frame: all inputs on one CUDA device")
    b, p = buf_u8.shape
    nb = tabs.nb
    eshape = (b, nb) if channels == 1 else (b, channels, nb)
    if buf_u8.dtype != torch.uint8 or old_e.shape != eshape \
            or prevmin.shape != eshape or seed.shape != (b,):
        raise ValueError(f"decode_frame: buf [B, P] uint8, old_e/prevmin "
                         f"{list(eshape)} f32, seed [B]")
    buf_u8 = buf_u8.contiguous()
    lens32 = lens.clamp(0, p).to(torch.int32).contiguous()
    old_e = old_e.to(torch.float32).contiguous()
    prevmin = prevmin.to(torch.float32).contiguous()
    seed = seed.to(torch.int64).contiguous()
    rc_in = None
    if d0 is not None:
        rc_in = pack_state(d0)
        rc_in = torch.where(rc_in >= 1 << 31, rc_in - (1 << 32),
                            rc_in).to(torch.int32).contiguous()
        if rc_in.shape[0] != b or rc_in.device != dev:
            raise ValueError("decode_frame: d0 lanes [B] on the same device")
    tab = k1_table(tabs, dev)
    nx = tabs.nx
    x = torch.empty((b, nx) if channels == 1 else (b, channels, nx),
                    dtype=torch.float32, device=dev)
    energies = torch.empty(eshape, dtype=torch.float32, device=dev)
    ints = torch.empty((b, 9), dtype=torch.int32, device=dev)
    pf_gain = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = library() if lib is None else lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    vp = ctypes.c_void_p
    args = (vp(buf_u8.data_ptr()), p, vp(lens32.data_ptr()),
            vp(old_e.data_ptr()), vp(prevmin.data_ptr()),
            vp(seed.data_ptr()),
            vp(None if rc_in is None else rc_in.data_ptr()),
            vp(tab.data_ptr()), vp(x.data_ptr()), vp(energies.data_ptr()),
            vp(ints.data_ptr()), vp(pf_gain.data_ptr()), b, nx)
    if channels == 1:
        rc = lib.opus_celt_dec_frame_launch(*args, vp(stream))
        check_launch(rc, "celt_dec_frame")
        launches += 1
    else:
        rc = lib.opus_celt_dec_frame2_launch(*args, int(bool(disable_inv)),
                                             vp(stream))
        check_launch(rc, "celt_dec_frame2")
        launches_stereo += 1
    ints = ints.to(torch.int64)
    res = {k: ints[:, j] for j, k in enumerate(INT_KEYS)}
    res["rng"] = res["rng"] & M32
    res.update(X=x, energies=energies, pf_gain=pf_gain)
    return res


def geometry(p: int, channels: int = 1) -> dict:
    """K1's launch geometry on the current card at packet stride ``p``
    (bytes), of its mono or (channels=2) stereo instantiation; see
    ``cuda_build.geometry``."""
    from ..cuda_build import geometry as geo

    return geo("opus_celt_dec_frame_occupancy" if channels == 1
               else "opus_celt_dec_frame2_occupancy", p)


def _decay(old, l1, l2, ld, tabs: DecTabs):
    """One channel's energies after a loss (celt_decoder.c:1251-1300): on
    lanes whose last frames were lost, each coded band decays toward where
    the two frames before the loss pointed."""
    lost = ld != 0
    if not bool(lost.any()):
        return old
    e0 = old.to(torch.float64)
    l1 = l1.to(torch.float64)
    l2 = l2.to(torch.float64)
    missing = torch.clamp(ld >> tabs.lm, max=10).to(torch.float64)[:, None]
    safety = {0: 1.5, 1: 0.5}.get(tabs.lm, 0.0)
    slope = torch.clamp(torch.maximum(l1 - e0, 0.5 * (l2 - e0)), max=2.0)
    down = torch.clamp(e0 - torch.clamp((1 + missing) * slope, min=0.0),
                       min=-20.0)
    keep = torch.minimum(torch.minimum(e0, l1), l2)
    dec = torch.where(e0 < torch.maximum(l1, l2), down, keep) - safety
    inside = (torch.arange(tabs.nb, device=old.device) >= tabs.start) \
        & (torch.arange(tabs.nb, device=old.device) < tabs.end_band)
    return torch.where(lost[:, None] & inside, dec.to(torch.float32), old)


def _missing_decay(state: dict, tabs: DecTabs):
    """The energies a mono frame predicts from: mono's max of old_e and its
    second copy, then the decay after a loss (applied before K1 on intra
    frames too: K1 weighs the old energy by 0 there)."""
    old = torch.maximum(state["old_e"], state["e_copy"])
    return _decay(old, state["prev1"], state["prev2"],
                  state["loss_duration"], tabs)


def kernel_celt_decode_to_pcm(buf_u8, lens, state: dict, tabs: DecTabs,
                              frame_fn=None, d0=None, channels: int = 1,
                              out_channels: int = 1,
                              disable_inv: bool = False,
                              downsample: int = 1):
    """One frame at 2.5-20 ms: the K1 symbol pass + the synthesis stage
    (IMDCT/TDAC, postfilter, de-emphasis with K2).  state: the
    fused_celt_init_state dict (with ``channels=2`` for a decoder that
    keeps both channels' memory); d0: the live range-decoder dict to
    continue from (hybrid), or None.  channels: the frame's coded
    channels C (2: K1's stereo instantiation); out_channels: the output's
    CC (a mono frame is synthesised into both, a stereo frame's spectra
    are averaged into one); disable_inv: the decoder's flag; downsample:
    48000 / the decoder's rate (the synthesis runs at 48 kHz, every
    downsample-th de-emphasised sample is kept).  Mirrors
    celt_decoder.c:1209-1614, the steps after a concealed frame included
    (the energies' decay, the fold of the extrapolated overlap, the
    background energies and the loss counters); returns (pcm [B, CC, N],
    new state, err [B]), N the frame's samples at the decoder's rate."""
    ld = state["loss_duration"]
    if channels == 1:
        frame_fn = decode_frame if frame_fn is None else frame_fn
        # mono keeps the louder of the two channels' memories (bands.c
        # anti_collapse with C = 1)
        prevmin = torch.minimum(
            torch.maximum(state["prev1"], state["prev1_1"]),
            torch.maximum(state["prev2"], state["prev2_1"]))
        out = frame_fn(buf_u8, lens, _missing_decay(state, tabs), prevmin,
                       state["seed"], tabs, d0)
        xs, es = out["X"][:, None, :], out["energies"][:, None, :]
    else:
        old = torch.stack([
            _decay(state["old_e"], state["prev1"], state["prev2"], ld, tabs),
            _decay(state["e_copy"], state["prev1_1"], state["prev2_1"], ld,
                   tabs)], dim=1)
        prevmin = torch.stack([
            torch.minimum(state["prev1"], state["prev2"]),
            torch.minimum(state["prev1_1"], state["prev2_1"])], dim=1)
        out = decode_frame2(buf_u8, lens, old, prevmin, state["seed"], tabs,
                            d0, disable_inv)
        xs, es = out["X"], out["energies"]
    err = out["error"] != 0
    silence = out["silence"] != 0
    transient = out["is_transient"] != 0
    dev = es.device

    n_full = tabs.mode.shortMdctSize << tabs.lm
    x = torch.nn.functional.pad(xs, (0, n_full - tabs.nx))
    minp = COMBFILTER_MINPERIOD
    pf_pitch, pf_gain, pf_tapset = (out["pf_pitch"], out["pf_gain"],
                                    out["pf_tapset"])
    periods = torch.stack([state["pf_period_old"].clamp_min(minp),
                           state["pf_period"].clamp_min(minp),
                           pf_pitch.clamp_min(minp)], dim=-1)
    comb = const("comb_gains",
                 lambda: np.asarray(COMB_GAINS, np.float32), dev)
    gains3 = torch.stack([state["pf_gain_old"], state["pf_gain"], pf_gain],
                         dim=-1)
    tapsets3 = torch.stack([state["pf_tapset_old"], state["pf_tapset"],
                            pf_tapset], dim=-1)
    tgains = gains3[..., None] * comb[tapsets3]

    overlap = tabs.mode.overlap
    dsps = [dict(channel_state(state, k)["dsp"],
                 tail=fold_tails(channel_state(state, k), overlap))
            for k in range(out_channels)]
    downmix = channels == 2 and out_channels == 1
    if channels == 1 and out_channels == 2:
        x, es_syn = x.expand(-1, 2, -1), es.expand(-1, 2, -1)
    else:
        es_syn = es
    pcm, dsp = decode_step(x, es_syn, transient, silence, periods, tgains,
                           dsps[0] if out_channels == 1 else to_rows(dsps),
                           fs=tabs.mode.Fs, frame_size=n_full, lm=tabs.lm,
                           channels=x.shape[1], downmix=downmix,
                           downsample=downsample)
    dsp_ch = [dsp] if out_channels == 1 else from_rows(dsp, 2)

    # ---- state carry (celt_decoder.c:1560-1614), per channel; a mono
    # frame copies its energies to the second channel
    rise = torch.clamp(ld + tabs.M, max=160).to(torch.float64) * 0.001
    tr = transient[:, None]
    inside = None
    if tabs.start > 0 or tabs.end_band < tabs.nb:
        inside = const(("k1_bands", tabs.nb, tabs.start, tabs.end_band),
                       lambda: (np.arange(tabs.nb) >= tabs.start)
                       & (np.arange(tabs.nb) < tabs.end_band), dev)

    def carry(e, p1, p2, bg):
        e_sil = torch.where(silence[:, None], -28.0, e)
        prev1 = torch.where(tr, torch.minimum(p1, e_sil), e_sil)
        prev2 = torch.where(tr, p2, p1)
        # the background creeps up by 1 dB/s (more after a loss) and never
        # passes the frame's energies (celt_decoder.c:1598-1601)
        background = torch.minimum(bg.to(torch.float64) + rise[:, None],
                                   e_sil.to(torch.float64)).to(torch.float32)
        if inside is not None:
            # bands outside [start, end) reset to 0 / -28 every frame
            # (celt_decoder.c:1604-1612)
            e_sil = torch.where(inside, e_sil, 0.0)
            prev1 = torch.where(inside, prev1, -28.0)
            prev2 = torch.where(inside, prev2, -28.0)
        return e_sil, prev1, prev2, background

    e0, prev1, prev2, background = carry(es[:, 0], state["prev1"],
                                         state["prev2"], state["background"])
    # the old postfilter phase: the new one for LM != 0 (celt_decoder.c:
    # 1592-1596), the current one (period at least the minimum) for LM 0
    if tabs.lm != 0:
        pf_old = (pf_pitch, pf_gain, pf_tapset)
    else:
        pf_old = (periods[:, 1], state["pf_gain"], state["pf_tapset"])
    zero = torch.zeros_like(ld)
    new_state = dict(
        state,
        old_e=e0, prev1=prev1, prev2=prev2,
        # the next frame's fold/noise seed is the final range, not the
        # evolved LCG state (celt_decoder.c:1602 st->rng = dec->rng)
        seed=out["rng"],
        pf_period_old=pf_old[0], pf_gain_old=pf_old[1],
        pf_tapset_old=pf_old[2],
        pf_period=pf_pitch, pf_gain=pf_gain, pf_tapset=pf_tapset,
        dsp=dsp_ch[0], background=background,
        # skip_plc clears on a good frame that follows a good frame
        # (celt_decoder.c:1237), so one frame after a noise run keeps it
        skip_plc=torch.where(ld == 0, 0, state["skip_plc"]),
        loss_duration=zero, plc_duration=zero, last_frame_type=zero,
        prefilter_and_fold=zero, rng_final=out["rng"],
        decoded_any=torch.ones_like(state["decoded_any"]))
    e1, p11, p21, bg1 = carry(es[:, channels - 1], state["prev1_1"],
                              state["prev2_1"], state["background_1"])
    new_state.update(e_copy=e1, prev1_1=p11, prev2_1=p21, background_1=bg1)
    if out_channels == 2:
        new_state["dsp_1"] = dsp_ch[1]
    return pcm, new_state, err


class KernelCeltDecoder:
    """Packets-in -> PCM-out mono CELT decoder at 2.5, 5, 10 or 20 ms:
    kernel K1 for the symbol pass and K2 for de-emphasis on the card (the
    default device), their plain torch versions when ``device="cpu"``.
    (The reference's kernel decoder refuses 2.5 and 5 ms; the port's K1
    is held to its plain version at every LM.)"""

    def __init__(self, batch: int, fs: int = 48000, frame_size: int = 960,
                 max_payload: int = 384, device="cuda"):
        self.tabs = dec_tabs(fs, frame_size)
        self.batch = batch
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("KernelCeltDecoder: no CUDA device (pass "
                               "device='cpu' for the plain versions)")
        self.P = max_payload
        self.state = fused_celt_init_state(batch, self.tabs, self.device)
        self.plc_trace = None        # the last conceal's per-lane decisions

    def pack(self, payloads):
        """list of B byte strings -> (buf [B, P] uint8, lens [B]) on the
        decoder's device; raises ValueError on a payload longer than P."""
        return pack_payloads(payloads, self.batch, self.P, self.device)

    def decode_packed(self, buf_u8, lens, active=None):
        """buf [B, P] uint8, lens [B] on the device -> (pcm [B, 1, N] f32,
        err [B] bool).  ``active`` ([B] bool, default every lane): a lane
        outside it keeps its state bit for bit, returns zeros and raises no
        error flag, as a lost packet never reaches the reference's decoder.
        K1 and the synthesis still run over every lane; the state is
        selected after them."""
        pcm, state, err = kernel_celt_decode_to_pcm(
            buf_u8, lens, self.state, self.tabs)
        if active is None:
            self.state = state
            return pcm, err
        m = lane_mask(active, self.batch, self.device)
        self.state = select_lanes(m, state, self.state)
        return torch.where(m[:, None, None], pcm, 0.0), err & m

    def conceal(self, lanes=None):
        """One lost frame on the lanes of ``lanes`` ([B] bool, default every
        lane) with the classic packet-loss concealment (``celt/plc.py``)
        -> pcm [B, 1, N] f32.  A lane outside ``lanes`` keeps its state bit
        for bit and returns zeros; so does a lane that has decoded no
        packet yet (src/opus_decoder.c:334-341).  ``plc_trace`` holds each
        lane's branch, pitch period and zeroing decision of this call."""
        m = lane_mask(lanes, self.batch, self.device)
        pcm, self.state, self.plc_trace = decode_lost(self.state, self.tabs,
                                                      m)
        return pcm

    def final_range(self):
        """[B] the final range of each lane's last decoded packet (the
        noise concealment leaves its LCG state in ``state["seed"]``, not
        this)."""
        return self.state["rng_final"]

    def reset(self, lanes=None):
        """The lanes of ``lanes`` ([B] bool, default every lane) back to the
        decoder's initial state (``fused_celt_init_state``)."""
        fresh = fused_celt_init_state(self.batch, self.tabs, self.device)
        self.state = fresh if lanes is None else select_lanes(
            lane_mask(lanes, self.batch, self.device), fresh, self.state)

    def decode(self, payloads):
        return self.decode_packed(*self.pack(payloads))
