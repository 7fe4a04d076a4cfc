"""Batched CELT synthesis in torch: normalized band shapes + energies in,
PCM out.  Port of ``opus_tpu/models/batched_decode.py`` (``init_state``,
``_band_map``, ``_tdac`` and ``decode_step``).

One step runs denormalise -> IMDCT (long and short-block paths, selected
per stream) -> TDAC overlap -> comb postfilter (recursive at the per-
stream pitch lag, evaluated in lag-safe chunks with a per-stream lag
gather) -> de-emphasis (kernel K2 on the card, ``ops/iir.py``).

Reference pipeline: celt_decode_with_ec celt/celt_decoder.c:1619,
celt_synthesis :413, comb_filter celt/celt.c:238, deemphasis :318.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..celt.modes import mode_create
from ..celt.tables import E_MEANS
from ..ops.device_cache import const
from ..ops.iir import deemphasis
from ..ops.mdct import _backward_basis, _window

HIST = 2048             # postfiltered history: the PLC's DECODE_BUFFER_SIZE
COMB_HIST = 1026        # what the comb reads of it: COMBFILTER_MAXPERIOD + 2
CHUNK = 12              # comb chunk; must be <= COMBFILTER_MINPERIOD - 2


def init_state(batch_ch: int, overlap: int = 120, device="cpu") -> dict:
    """Synthesis state: raw IMDCT tail [BC, overlap/2], postfiltered
    history [BC, HIST] (the comb reads its last COMB_HIST samples, the
    packet-loss concealment all of it), de-emphasis memory [BC]."""
    return dict(
        tail=torch.zeros((batch_ch, overlap // 2), dtype=torch.float32,
                         device=device),
        hist=torch.zeros((batch_ch, HIST), dtype=torch.float32,
                         device=device),
        deemph=torch.zeros((batch_ch,), dtype=torch.float32, device=device))


def _band_map(mode, lm: int) -> np.ndarray:
    m = 1 << lm
    n = mode.shortMdctSize << lm
    bm = np.full(n, mode.nbEBands, dtype=np.int64)
    for i in range(mode.nbEBands):
        bm[m * mode.eBands[i]:m * mode.eBands[i + 1]] = i
    return bm


def _tdac(core, tail, overlap: int):
    """core: [BC, nblocks, n2]; returns (sig [BC, nblocks*n2], new tail)."""
    n2 = core.shape[-1]
    ov2 = overlap // 2
    w = const(("window", overlap),
              lambda: _window(overlap).astype(np.float32), core.device)
    w_lo, w_hi = w[:ov2], w[ov2:].flip(0)
    tails = torch.cat([tail[:, None, :], core[:, :-1, n2 - ov2:]], dim=1)
    cur = core[:, :, :ov2].flip(-1)
    head = w_hi * tails - w_lo * cur
    mid = (w_lo * tails + w_hi * cur).flip(-1)
    sig = torch.cat([head, mid, core[:, :, ov2:n2 - ov2]], dim=-1)
    return sig.reshape(core.shape[0], -1), core[:, -1, n2 - ov2:]


@lru_cache(maxsize=None)
def _comb_plan(n: int, overlap: int, lm: int):
    """Blend profile and per-chunk (a_phase, b_phase) selectors: [0,
    overlap) fades phase0->phase1 taps, the next overlap samples fade
    phase1->phase2 (lm > 0), the rest is pure phase2."""
    w = _window(overlap).astype(np.float32)
    prof = np.ones(n, np.float32)
    prof[:overlap] = w * w
    if lm > 0:
        prof[overlap:2 * overlap] = w * w
    nch = n // CHUNK
    pa = np.zeros(nch, np.int64)
    pb = np.full(nch, 2, np.int64)
    for j in range(nch):
        s0 = j * CHUNK
        if lm > 0:
            pa[j] = 0 if s0 < overlap else (1 if s0 < 2 * overlap else 2)
            pb[j] = 1 if s0 < overlap else 2
        else:
            pa[j] = 0 if s0 < overlap else 1
            pb[j] = 1
    return prof, tuple(int(v) for v in pa), tuple(int(v) for v in pb)


def _taps_at(ybuf, s0: int, t, g):
    """5-tap comb at per-stream lag t [BC], samples [s0, s0+CHUNK)."""
    starts = COMB_HIST + s0 - t - 2
    idx = starts[:, None] + torch.arange(CHUNK + 4, device=ybuf.device)
    seg = ybuf.gather(1, idx)
    return (g[:, 0:1] * seg[:, 2:CHUNK + 2]
            + g[:, 1:2] * (seg[:, 3:CHUNK + 3] + seg[:, 1:CHUNK + 1])
            + g[:, 2:3] * (seg[:, 4:CHUNK + 4] + seg[:, 0:CHUNK]))


def decode_step(x, band_log_e, transient, silence, periods, tap_gains,
                state: dict, *, fs: int = 48000, frame_size: int = 960,
                lm: int = 3, channels: int = 1, downmix: bool = False,
                downsample: int = 1):
    """One frame of batched CELT decode DSP.

    x:          [B, C, N] normalized band shapes
    band_log_e: [B, C, nbEBands]
    transient:  [B] bool; silence: [B] bool
    periods:    [B, 3] int comb lags for phases (old, current, new)
    tap_gains:  [B, 3, 3] f32 per-phase tap gains (gain*COMB_GAINS[tapset])
    state:      init_state dict with leading dim B*C
    downmix:    C = 2 coded channels to one output channel, the average of
                the two denormalised spectra (celt_decoder.c:413
                celt_synthesis with CC = 1, C = 2); state then has B rows
    downsample: 48000 / the decoder's rate (1, 2, 3, 4 or 6): the spectrum
                above the output's band is zeroed and every downsample-th
                de-emphasised sample kept (celt_decoder.c deemphasis)
    returns (pcm [B, C, N / downsample] float in [-1, 1] ([B, 1, ...]
    with downmix), new state)
    """
    filt, dsp = synth_step(x, band_log_e, transient, silence, periods,
                           tap_gains, state, fs=fs, frame_size=frame_size,
                           lm=lm, downmix=downmix, downsample=downsample)
    pcm, deemph = deemphasize(filt, state["deemph"], fs, frame_size,
                              downsample)
    return pcm.reshape(x.shape[0], -1, pcm.shape[1]), dict(dsp,
                                                            deemph=deemph)


def deemphasize(filt, mem, fs: int = 48000, frame_size: int = 960,
                downsample: int = 1):
    """De-emphasis y[n] = x[n] + coef*y[n-1] (kernel K2 on the card) of
    the postfiltered signal [BC, N] over all N samples, then every
    ``downsample``-th sample kept (opus_tpu/celt/decoder.py:697-725) ->
    (pcm [BC, N / downsample] in [-1, 1], new memory)."""
    mode = mode_create(fs, frame_size)
    y, deemph = deemphasis(filt, mem, float(mode.preemph[0]))
    if downsample > 1:
        y = y[:, ::downsample]
    return y * (1.0 / 32768.0), deemph


def synth_step(x, band_log_e, transient, silence, periods, tap_gains,
               state: dict, *, fs: int = 48000, frame_size: int = 960,
               lm: int = 3, downmix: bool = False, downsample: int = 1):
    """``decode_step`` up to the de-emphasis: returns (the postfiltered
    signal [BC, N] f32, the new ``tail`` and ``hist``).  With downsample
    > 1 the bins from N / downsample up are zeroed (denormalise_bands'
    bound, opus_tpu/celt/bands.py:1404-1409)."""
    mode = mode_create(fs, frame_size)
    n = mode.shortMdctSize << lm
    overlap = mode.overlap
    nshort = 1 << lm
    n2s = mode.shortMdctSize
    b, c = x.shape[0], x.shape[1]
    bc = b * c
    dev = x.device

    # --- denormalise ---
    bm = const(("band_map", fs, frame_size, lm),
               lambda: _band_map(mode, lm), dev)
    e_means = const(("e_means", mode.nbEBands), lambda: np.asarray(
        E_MEANS[:mode.nbEBands], np.float32), dev)
    gains = torch.exp2(torch.clamp(band_log_e + e_means, max=32.0))
    gains = torch.cat([gains, torch.zeros_like(gains[..., :1])], dim=-1)
    freq = x * gains[..., bm]
    if downmix:
        freq = 0.5 * (freq[:, :1] + freq[:, 1:])
        c, bc = 1, b
    freq = torch.where(silence[:, None, None], 0.0, freq).reshape(bc, n)
    if downsample > 1:
        freq = torch.cat([freq[:, :n // downsample],
                          torch.zeros_like(freq[:, n // downsample:])], dim=1)

    # --- IMDCT: long and short paths, select per stream ---
    basis_l = const(("imdct", n, overlap),
                    lambda: _backward_basis(n, overlap), dev)
    core_l = torch.matmul(freq[:, None, :], basis_l)
    sig_l, tail_l = _tdac(core_l, state["tail"], overlap)
    if lm > 0:
        basis_s = const(("imdct", n2s, overlap),
                        lambda: _backward_basis(n2s, overlap), dev)
        spec_s = freq.reshape(bc, n2s, nshort).transpose(1, 2)
        core_s = torch.matmul(spec_s, basis_s)
        sig_s, tail_s = _tdac(core_s, state["tail"], overlap)
        tsel = transient.repeat_interleave(c)
        sig = torch.where(tsel[:, None], sig_s, sig_l)
        new_tail = torch.where(tsel[:, None], tail_s, tail_l)
    else:
        sig, new_tail = sig_l, tail_l

    # --- comb postfilter (recursive; lag-safe chunks of CHUNK samples) ---
    prof, pa, pb = _comb_plan(n, overlap, lm)
    fprof = const(("comb_profile", n, overlap, lm), lambda: prof, dev)
    periods_bc = periods.to(torch.int64).repeat_interleave(c, dim=0)
    tgains_bc = tap_gains.repeat_interleave(c, dim=0)
    hist = state["hist"]
    if bool((tgains_bc != 0.0).any()):
        ybuf = torch.cat([hist[:, -COMB_HIST:], torch.zeros_like(sig)],
                         dim=1)
        for j in range(n // CHUNK):
            s0 = j * CHUNK
            fc = fprof[s0:s0 + CHUNK]
            ja, jb = pa[j], pb[j]
            out = sig[:, s0:s0 + CHUNK] \
                + (1.0 - fc) * _taps_at(ybuf, s0, periods_bc[:, ja],
                                        tgains_bc[:, ja]) \
                + fc * _taps_at(ybuf, s0, periods_bc[:, jb],
                                tgains_bc[:, jb])
            ybuf[:, COMB_HIST + s0:COMB_HIST + s0 + CHUNK] = out
        filt = ybuf[:, COMB_HIST:]
    else:
        filt = sig
    return filt, dict(tail=new_tail, hist=torch.cat([hist[:, n:], filt],
                                                    dim=1))
