"""The SILK API level of the Opus decoder (silk/dec_API.c; the JAX
package's ``opus_tpu/silk/api.py`` ``SilkDecoder.decode``) over B lanes:
two channel states, the stereo predictor and mid/side -> left/right, the
resamplers of both output channels to the decoder's rate (8, 12, 16, 24
or 48 kHz), and packets of 1-3 frames.

A lane's SILK side is, as the scalar's ``SilkDecoder``: the mid (or
mono) and side channel states (``fused_silk_dec.fused_init_state`` at
the widest buffers), each channel's resampler (at ``resampler.WIDE``: a
lane's internal rate changes from packet to packet), the stereo state
(``s_mid``, ``s_side``, ``pred_prev_q13``), and on the host each
channel's internal rate (0 until its first frame), the internal channel
count of the last packet and ``prev_decode_only_middle``.  The output
channel count ``channels`` (1 or 2) and rate ``fs_khz`` are the
decoder's.

A packet's frames decode group by group, a group being the lanes of one
(internal rate, subframes, frames, internal channels): the header (each
channel's VAD and LBRR flags), a normal decode's parse of every LBRR
frame, then frame by frame the stereo predictor and the mid-only flag,
the mid frame and, unless the side is left out, the side frame, all on
one range decoder per lane; then mid/side -> left/right and the
resamplers.  In-band FEC decodes the LBRR frames in place of the
regular ones (concealing a frame without one); a lost packet conceals
each channel.  Kernel K4 runs every frame's LPC synthesis and every
concealment's, on the card.

Reference: silk/dec_API.c:135 (the JAX package's api.py:37-219).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lanes import select_lanes
from ..ops.rc_kernel import rk_init
from ..silk.resampler import resample_lanes, wide_init
from ..silk.stereo import ms_to_lr, pred_q13
from .fused_silk_dec import (CODE_CONDITIONALLY, CODE_INDEPENDENTLY,
                             CODE_INDEPENDENTLY_NO_LTP_SCALING, _Ctx,
                             fused_init_state, fused_silk_conceal,
                             fused_silk_decode, silk_header, silk_tabs,
                             skip_lbrr, stereo_pred_symbols)

def take(tree, idx):
    """A state tree's rows ``idx``."""
    if isinstance(tree, dict):
        return {k: take(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx)


def put(tree, idx, sub):
    """``tree`` with rows ``idx`` replaced by ``sub``."""
    if isinstance(tree, dict):
        return {k: put(v, idx, sub[k]) for k, v in tree.items()}
    return tree.index_copy(0, idx, sub.to(tree.dtype))


def silk_fresh(n: int, fs_khz: int, device) -> dict:
    """A SILK channel as the scalar's after ``reset`` and its first
    ``set_fs(fs_khz)``, at the widest buffers (the comfort noise's
    smoothed NLSFs are those of the rate's LPC order), with the packet's
    flags and the conditional coding's memory."""
    st = fused_init_state(n, 16, device, 4)
    order = 16 if fs_khz == 16 else 10
    step = 32767 // (order + 1)
    smth = [(i + 1) * step for i in range(order)] + [0] * (16 - order)
    st["cng_smth_nlsf_q15"] = torch.tensor(
        smth, dtype=torch.int64, device=device).repeat(n, 1)
    z = torch.zeros((n, 3), dtype=torch.bool, device=device)
    st.update(vad_flags=z, lbrr_flags=z.clone(),
              ec_prev_type=torch.zeros(n, dtype=torch.int64, device=device),
              ec_prev_lag=torch.zeros(n, dtype=torch.int64, device=device))
    return st


def silk_view(st: dict, fs_khz: int) -> dict:
    """The SILK state of lanes at ``fs_khz``: the LTP memory is the first
    20 ms of the stored output buffer."""
    return dict(st, synth=dict(st["synth"], out_buf=st["synth"]["out_buf"]
                               [:, :20 * fs_khz]))


def silk_unview(new: dict, old: dict) -> dict:
    """``new`` (a ``silk_view`` state after a frame) back at the stored
    widths: buffers narrower than the store keep the store's tail."""
    out = dict(new)
    ob = new["synth"]["out_buf"]
    old_ob = old["synth"]["out_buf"]
    out["synth"] = dict(new["synth"], out_buf=torch.cat(
        [ob, old_ob[:, ob.shape[1]:]], dim=1))
    for k in ("exc_q14", "cng_exc_buf_q14"):
        v = new[k]
        out[k] = torch.cat([v, old[k][:, v.shape[1]:]], dim=1)
    return out


def side_reset(st: dict, lanes):
    """The side channel's reset when a frame codes it again after mid-only
    frames (api.py:121-131): output buffer, LPC state, lag, gain index,
    signal type, the first-frame flag."""
    if not bool(lanes.any()):
        return st
    new = dict(st, synth=dict(
        st["synth"], out_buf=torch.zeros_like(st["synth"]["out_buf"]),
        slpc=torch.zeros_like(st["synth"]["slpc"])),
        lag_prev=torch.full_like(st["lag_prev"], 100),
        last_gain_index=torch.full_like(st["last_gain_index"], 10),
        prev_signal_type=torch.zeros_like(st["prev_signal_type"]),
        first_frame=torch.ones_like(st["first_frame"]))
    return select_lanes(lanes, new, st)


def _pad3(flags):
    z = torch.zeros_like(flags[0])
    return torch.stack(list(flags) + [z] * (3 - len(flags)), dim=1)


class SilkLanes:
    """The SILK side of B Opus decoder lanes with ``channels`` output
    channels at ``fs_khz`` (see the module docstring).  ``events`` (a
    dict) counts the groups' frames for the caller's report."""

    def __init__(self, batch: int, channels: int, device, events=None,
                 fs_khz: int = 48):
        self.batch, self.cc, self.device = batch, channels, device
        self.fs_khz = fs_khz
        self.events = {} if events is None else events
        b = batch
        self.ch = [silk_fresh(b, 16, device), silk_fresh(b, 16, device)]
        self.rs = [wide_init(b, device), wide_init(b, device)]
        z2 = torch.zeros((b, 2), dtype=torch.int64, device=device)
        self.smid, self.sside, self.pred_prev = z2, z2.clone(), z2.clone()
        self.fs = np.zeros((2, b), np.int64)     # 0: none since a reset
        self.n_int = np.zeros(b, np.int64)
        self.prev_dom = np.zeros(b, bool)

    def get_state(self) -> dict:
        """The lanes' SILK state as a tree of dicts (every leaf's first
        dimension the lane): ch0/ch1, rs0/rs1, smid, sside, pred_prev, and
        under ``host`` fs0/fs1, n_int, prev_dom (numpy copies)."""
        return dict(ch0=self.ch[0], ch1=self.ch[1], rs0=self.rs[0],
                    rs1=self.rs[1], smid=self.smid, sside=self.sside,
                    pred_prev=self.pred_prev,
                    host=dict(fs0=self.fs[0].copy(), fs1=self.fs[1].copy(),
                              n_int=self.n_int.copy(),
                              prev_dom=self.prev_dom.copy()))

    def set_state(self, st: dict) -> None:
        """Takes a ``get_state`` dict (or convert.opus_decoder_state's
        ``silk``)."""
        def to(t):
            if isinstance(t, dict):
                return {k: to(v) for k, v in t.items()}
            return t.to(self.device)
        self.ch = [to(st["ch0"]), to(st["ch1"])]
        self.rs = [to(st["rs0"]), to(st["rs1"])]
        for k in ("smid", "sside", "pred_prev"):
            setattr(self, k, to(st[k]))
        h = st["host"]
        self.fs = np.stack([np.array(h["fs0"]), np.array(h["fs1"])])
        self.n_int = np.array(h["n_int"])
        self.prev_dom = np.array(h["prev_dom"], bool)

    def _idx(self, lanes) -> torch.Tensor:
        return torch.as_tensor(np.nonzero(lanes)[0], device=self.device)

    def _count(self, key: str, n: int) -> None:
        if n:
            self.events[key] = self.events.get(key, 0) + int(n)

    # ---- resets ---------------------------------------------------------

    def _reset_ch(self, k: int, lanes) -> None:
        idx = self._idx(lanes)
        n = len(idx)
        self.ch[k] = put(self.ch[k], idx, silk_fresh(n, 16, self.device))
        self.rs[k] = put(self.rs[k], idx, wide_init(n, self.device))
        self.fs[k][lanes] = 0

    def reset(self, lanes) -> None:
        """silk.reset() (opus_decoder.py:346): both channels, the stereo
        state and the resamplers."""
        if not lanes.any():
            return
        for k in range(2):
            self._reset_ch(k, lanes)
        idx = self._idx(lanes)
        for name in ("smid", "sside", "pred_prev"):
            setattr(self, name, getattr(self, name).index_fill(0, idx, 0))
        self.n_int[lanes] = 0
        self.prev_dom[lanes] = False

    def _set_fs(self, k: int, lanes, fs: int, length) -> None:
        """The resets of channel k's change of internal rate on ``lanes``
        (silk/decoder.py:390-427 set_fs, and the PLC and CNG resets their
        next use makes): LPC order, LTP memory and synthesis taps, lag,
        gain index, signal type and the first-frame flag; the PLC's pitch,
        gains and subframe shape; the comfort noise's smoothed NLSFs,
        gain and seed; a new resampler.  length [B]: each lane's frame
        length at the new rate (the PLC's reset pitch)."""
        idx = self._idx(lanes)
        n = len(idx)
        old = take(self.ch[k], idx)
        fresh = silk_fresh(n, fs, self.device)
        keep = ("prev_nlsf", "prev_gain_q16", "exc_q14", "loss_cnt",
                "plc_ltp_coef_q14", "plc_prev_lpc_q12",
                "plc_prev_ltp_scale_q14", "plc_rand_scale_q14",
                "plc_rand_seed", "plc_conc_energy", "plc_conc_energy_shift",
                "plc_last_frame_lost", "cng_exc_buf_q14", "cng_synth_state",
                "decoded_any", "ec_prev_type", "ec_prev_lag")
        new = dict(fresh, **{key: old[key] for key in keep})
        new["plc_pitch_l_q8"] = torch.as_tensor(length[lanes] << 7,
                                                device=self.device)
        self.ch[k] = put(self.ch[k], idx, new)
        self.rs[k] = put(self.rs[k], idx, wide_init(n, self.device))
        self.fs[k][lanes] = fs

    def prepare(self, lanes, nch, isr, length):
        """A packet's first steps on ``lanes`` (api.py:46-79): a new side
        channel's reset, stereo -> mono detection, each coded channel's
        rate, and, where the output turns stereo, the side's resampler
        from the mid's and a zero predictor.  nch, isr (kHz), length:
        [B] per lane.  Returns the stereo -> mono lanes [B] bool."""
        grow = lanes & (nch > self.n_int)
        if grow.any():
            self._reset_ch(1, grow)
        s2m = lanes & (nch == 1) & (self.n_int == 2) & (isr == self.fs[0])
        self._count("silk_stereo_to_mono", int(s2m.sum()))
        for k in range(2):
            on = lanes & (nch > k)
            change = on & (isr != self.fs[k])
            for fs in (8, 12, 16):
                if (change & (isr == fs)).any():
                    self._set_fs(k, change & (isr == fs), fs, length)
        if self.cc == 2:
            cp = lanes & (nch == 2) & (self.n_int == 1)
            if cp.any():
                idx = self._idx(cp)
                self.rs[1] = put(self.rs[1], idx, take(self.rs[0], idx))
                self.pred_prev = self.pred_prev.index_fill(0, idx, 0)
                self.sside = self.sside.index_fill(0, idx, 0)
        self.n_int[lanes] = nch[lanes]
        return s2m

    # ---- the output stage ------------------------------------------------

    def _resample(self, seq, rs, fs: int):
        """A channel's frame at fs kHz -> the decoder's rate."""
        return resample_lanes(seq, rs, fs, self.fs_khz)

    def _emit(self, idx, xq0, xq1, pred, fs: int, s2m=None):
        """One frame's output (api.py:170-215): mid/side -> left/right with
        two output channels (else the mid, one sample late through s_mid),
        each output channel's resampler to the decoder's rate; a mono
        frame's second output channel is the first's, or on stereo -> mono
        lanes (``s2m`` [n] bool) the side resampler's output of the mid.
        Returns [n, CC, the frame's samples at fs_khz] int64."""
        n, L = xq0.shape
        seq1 = None
        if xq1 is not None and self.cc == 2:
            z = torch.zeros((n, 2), dtype=torch.int64, device=xq0.device)
            st = dict(pred_prev_q13=take(self.pred_prev, idx),
                      s_mid=take(self.smid, idx), s_side=take(self.sside, idx))
            left, right, st = ms_to_lr(torch.cat([z, xq0], 1),
                                       torch.cat([z, xq1], 1), pred, st, fs)
            self.pred_prev = put(self.pred_prev, idx, st["pred_prev_q13"])
            self.smid = put(self.smid, idx, st["s_mid"])
            self.sside = put(self.sside, idx, st["s_side"])
            seq0, seq1 = left[:, 1:L + 1], right[:, 1:L + 1]
        else:
            sm = take(self.smid, idx)
            seq0 = torch.cat([sm[:, 1:], xq0[:, :-1]], dim=1)
            self.smid = put(self.smid, idx, xq0[:, -2:])
        out0, r0 = self._resample(seq0, take(self.rs[0], idx), fs)
        self.rs[0] = put(self.rs[0], idx, r0)
        outs = [out0]
        if self.cc == 2:
            if seq1 is not None:
                out1, r1 = self._resample(seq1, take(self.rs[1], idx), fs)
                self.rs[1] = put(self.rs[1], idx, r1)
            else:
                out1 = out0
                if s2m is not None and bool(s2m.any()):
                    old = take(self.rs[1], idx)
                    o, r1 = self._resample(seq0, old, fs)
                    out1 = torch.where(s2m[:, None], o, out0)
                    self.rs[1] = put(self.rs[1], idx,
                                     select_lanes(s2m, r1, old))
            outs.append(out1)
        return torch.stack(outs, dim=1)

    # ---- decoded packets -------------------------------------------------

    def decode_group(self, lanes, fs: int, nb: int, nfr: int, nch: int, buf,
                     lens, fec, s2m):
        """The SILK frames of one group's packets (lanes [B] bool; fs kHz,
        nb subframes, nfr frames, nch coded channels; fec [B] bool: decode
        the LBRR frames; s2m [B] bool: stereo -> mono lanes).  Returns
        (pcm [n, CC, nfr * fs_khz * 5 * nb] int64 at the decoder's rate,
        the range decoder rows of the group's lanes, error [n] bool)."""
        dev = self.device
        idx = self._idx(lanes)
        n = len(idx)
        bsub = buf.index_select(0, idx)
        lsub = lens.index_select(0, idx).to(torch.int64).clamp(
            0, buf.shape[1])
        fl = torch.as_tensor(fec[lanes], device=dev)
        any_fec = bool(fec[lanes].any())
        ctx = _Ctx(bsub, lsub, silk_tabs(fs, nb))
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        err = torch.zeros(n, dtype=torch.bool, device=dev)
        d = rk_init(bsub, lsub)
        d, vad, lbrr = silk_header(d, ctx, nfr, nch, ones)
        d, err = skip_lbrr(d, ctx, lbrr, nfr, nb, fs, ~fl, err)
        olds = [take(self.ch[k], idx) for k in range(nch)]
        st = []
        for k in range(nch):
            v = silk_view(olds[k], fs)
            v.update(vad_flags=_pad3(vad[k]), lbrr_flags=_pad3(lbrr[k]))
            st.append(v)
        prev_dom = torch.as_tensor(self.prev_dom[lanes], device=dev)
        pred_prev = take(self.pred_prev, idx)
        s2m_t = torch.as_tensor(s2m[lanes], device=dev)
        ms = 5 * nb
        pcm = []
        for i in range(nfr):
            pred = xq1 = None
            if nch == 2:
                rd = ~fl | lbrr[0][i]
                mo_rd = rd & torch.where(fl, ~lbrr[1][i], ~vad[1][i])
                d, syms, mo = stereo_pred_symbols(d, ctx, rd, mo_rd)
                pred = torch.where(rd[:, None], pred_q13(syms), pred_prev)
                dom = mo_rd & (mo != 0)
                st[1] = side_reset(st[1], ~dom & prev_dom)
                has_side = torch.where(fl, ~prev_dom | lbrr[1][i], ~dom)
            xq0, st[0], e0, d = fused_silk_decode(
                bsub, lsub, st[0], fs_khz=fs, nb_subfr=nb, return_rc=True,
                lbrr=fl if any_fec else None, d0=d, frame=i, nframes=nfr,
                header=False)
            err = err | e0
            if nch == 2:
                # the side's frame index is the mid's count after its frame
                # less one: i (api.py:156)
                if i == 0:
                    cond = torch.full_like(lsub, CODE_INDEPENDENTLY)
                else:
                    cond = torch.where(
                        fl, torch.where(lbrr[1][i - 1], CODE_CONDITIONALLY,
                                        CODE_INDEPENDENTLY),
                        torch.where(prev_dom,
                                    CODE_INDEPENDENTLY_NO_LTP_SCALING,
                                    CODE_CONDITIONALLY))
                xq1 = torch.zeros_like(xq0)
                if bool(has_side.any()):
                    x1, new1, e1, d = fused_silk_decode(
                        bsub, lsub, st[1], fs_khz=fs, nb_subfr=nb,
                        return_rc=True, lbrr=fl if any_fec else None,
                        active=has_side, d0=d, frame=i, nframes=nfr,
                        header=False, cond=cond)
                    st[1] = select_lanes(has_side, new1, st[1])
                    xq1 = torch.where(has_side[:, None], x1, 0)
                    err = err | (e1 & has_side)
                prev_dom = dom
                self._count("silk_side_frames", int(has_side.sum()))
            pcm.append(self._emit(idx, xq0, xq1, pred, fs,
                                  s2m_t if i == 0 else None))
        for k in range(nch):
            self.ch[k] = put(self.ch[k], idx, silk_unview(st[k], olds[k]))
        self.prev_dom[lanes] = prev_dom.cpu().numpy() if nch == 2 \
            else False
        self._count(f"silk_{fs}k_{ms * nfr}ms"
                    + ("_stereo" if nch == 2 else ""), n)
        return torch.cat(pcm, dim=2), d, err

    # ---- lost packets ----------------------------------------------------

    def conceal_group(self, lanes, fs: int, nb: int, nch: int):
        """One concealed SILK frame on ``lanes`` (api.py with
        FLAG_PACKET_LOST): each coded channel's concealment (the side's
        only where the last frame coded it, after the side reset), the
        last predictor, then the output stage; every channel's gain index
        back to 10.  Returns pcm [n, CC, fs_khz * 5 * nb] int64 at the
        decoder's rate."""
        idx = self._idx(lanes)
        olds = [take(self.ch[k], idx) for k in range(nch)]
        xq0, new0 = fused_silk_conceal(silk_view(olds[0], fs), fs_khz=fs,
                                       nb_subfr=nb)
        new0["last_gain_index"] = torch.full_like(new0["last_gain_index"],
                                                  10)
        news = [new0]
        xq1 = pred = None
        if nch == 2:
            prev_dom = torch.as_tensor(self.prev_dom[lanes],
                                       device=self.device)
            pred = take(self.pred_prev, idx)
            v1 = side_reset(silk_view(olds[1], fs), prev_dom)
            x1, new1 = fused_silk_conceal(v1, fs_khz=fs, nb_subfr=nb)
            has_side = ~prev_dom
            new1 = select_lanes(has_side, new1, v1)
            new1["last_gain_index"] = torch.full_like(
                new1["last_gain_index"], 10)
            xq1 = torch.where(has_side[:, None], x1, 0)
            news.append(new1)
        for k in range(nch):
            self.ch[k] = put(self.ch[k], idx, silk_unview(news[k], olds[k]))
        self._count(f"silk_conceal_{fs}k_{5 * nb}ms"
                    + ("_stereo" if nch == 2 else ""), len(idx))
        return self._emit(idx, xq0, xq1, pred, fs)
