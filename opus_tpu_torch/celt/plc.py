"""The classic (non-neural) CELT packet-loss concealment over a batch of
lanes: port of the scalar decoder's ``_windowed_autocorr``,
``_celt_fir``, ``_celt_iir``, ``_plc_pitch_search``,
``_prefilter_and_fold`` and ``_decode_lost`` (``opus_tpu/celt/
decoder.py:131-162``, :727-918; reference: celt_decode_lost
celt/celt_decoder.c:679, prefilter_and_fold :580, celt_plc_pitch_search
:555, celt/celt_lpc.c).

Each lost frame takes one of two branches per lane:

- periodic (the first ~40 ms of a loss): a pitch search over the last
  2048 postfiltered samples (only on lanes whose last frame was not
  periodic; the others keep their period and fade by 0.8), the LPC of
  the last 1024 (recomputed on the same lanes), the excitation over twice
  the period, its periodic extrapolation over N + overlap samples with a
  decay from two half-periods, the LPC synthesis (a 24-tap IIR) and an
  energy check that zeroes or rescales it.  The ``overlap`` samples past
  the frame wait in ``fold`` until the next frame folds them into its
  MDCT overlap (``prefilter_and_fold``);
- noise (after 40 ms, after a noise frame until the second good frame,
  or from a start band above 0): band energies decayed toward the
  background, LCG noise renormalised per band, and the good frame's
  synthesis (``batched_decode.synth_step``, not a transient) with the
  lane's postfilter phases.

Both branches run over every lane where any lane takes them, and the lane
mask selects; the arithmetic is float64, rounded once into the float32
history, and the de-emphasis of the concealed frame is one call of K2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.batched_decode import deemphasize, synth_step
from ..ops.device_cache import const
from ..ops.lanes import select_lanes
from ..ops.mdct import _window
from .pitch import celt_lpc, pitch_downsample, pitch_search
from .tables import COMB_GAINS, COMBFILTER_MINPERIOD

DECODE_BUFFER_SIZE = 2048
MAX_PERIOD = 1024
CELT_LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100
FRAME_NORMAL = 0
FRAME_PLC_PERIODIC = 1
FRAME_PLC_NOISE = 2
PLC_NOISE_AFTER = 40           # plc_duration (2.5 ms units) of the switch
DURATION_CAP = 10000
EPSILON = 1e-15
LCG_A, LCG_C = 1664525, 1013904223
M32 = 0xFFFFFFFF

f64 = torch.float64


def _win(overlap: int, dev):
    return const(("plc_window", overlap), lambda: _window(overlap), dev)


def windowed_autocorr(x, window, overlap: int, lag: int):
    """(reference: _celt_autocorr celt/celt_lpc.c:284, float) x [B, n]
    f64, its first and last ``overlap`` samples windowed -> [B, lag + 1]."""
    n = x.shape[1]
    xx = torch.cat([x[:, :overlap] * window,
                    x[:, overlap:n - overlap],
                    x[:, n - overlap:] * window.flip(0)], dim=1)
    return torch.stack([(xx[:, :n - k] * xx[:, k:]).sum(1)
                        for k in range(lag + 1)], dim=1)


def celt_fir(full, num, n: int):
    """y[i] = x[i] + sum_j num[j] x[i - 1 - j] (reference: celt_fir
    celt/celt_lpc.c:92): full [B, ord + n] is x with its ``ord`` samples
    of history in front, num [B, ord]; summed tap by tap as the scalar."""
    order = num.shape[1]
    y = full[:, order:order + n]
    for j in range(order):
        y = y + num[:, j:j + 1] * full[:, order - 1 - j:order - 1 - j + n]
    return y


def celt_iir(x, den, mem):
    """y[i] = x[i] - sum_j den[j] y[i - 1 - j] (reference: celt_iir
    celt/celt_lpc.c:145): x [B, n], den [B, ord], mem [B, ord] with
    mem[:, j] = y[-1 - j].  One sample a step over every lane."""
    b, n = x.shape
    order = den.shape[1]
    y = torch.empty((b, order + n), dtype=x.dtype, device=x.device)
    y[:, :order] = mem.flip(1)
    rden = den.flip(1)          # rden[k] multiplies y[i - order + k]
    for i in range(n):
        torch.sub(x[:, i], torch.linalg.vecdot(rden, y[:, i:i + order]),
                  out=y[:, order + i])
    return y[:, order:]


def plc_pitch_search(hist, margin=None, hist2=None):
    """(reference: celt_plc_pitch_search celt_decoder.c:555) the period
    [B] int64 of the last DECODE_BUFFER_SIZE samples hist [B, 2048] f64
    (and of a second channel's, hist2: the search runs on their
    downmix); ``margin``: see ``pitch.pitch_search``."""
    lp = pitch_downsample(hist, DECODE_BUFFER_SIZE >> 1, hist2)
    idx = pitch_search(lp[:, PLC_PITCH_LAG_MAX >> 1:], lp,
                       DECODE_BUFFER_SIZE - PLC_PITCH_LAG_MAX,
                       PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN, margin)
    return PLC_PITCH_LAG_MAX - idx


def _comb_gains(dev):
    return const(("plc_comb_gains",), lambda: np.asarray(COMB_GAINS,
                                                         np.float64), dev)


def prefilter_and_fold(fold, hist, gain, period, tapset, overlap: int):
    """(reference: prefilter_and_fold celt_decoder.c:580): the inverse
    comb (gain -g of the current postfilter phase, constant over the
    overlap) over the ``overlap`` extrapolated samples ``fold`` [B, ov]
    that follow the history hist [B, H], then the windowed TDAC mirror.
    Returns the lanes' new IMDCT tail [B, ov / 2] f32."""
    dev = fold.device
    b = fold.shape[0]
    ext = torch.cat([hist, fold], dim=1).to(f64)
    h = hist.shape[1]
    t1 = period.clamp_min(COMBFILTER_MINPERIOD)
    g1 = -gain.to(f64)
    gs = _comb_gains(dev)[tapset]                           # [B, 3]
    c = [g1 * gs[:, k] for k in range(3)]
    base = h + torch.arange(overlap, device=dev)[None, :] - t1[:, None]

    def at(off):
        return ext.gather(1, (base + off).expand(b, -1))
    etmp = ext[:, h:] + c[0][:, None] * at(0) \
        + c[1][:, None] * (at(1) + at(-1)) \
        + c[2][:, None] * (at(2) + at(-2))
    half = overlap // 2
    w = _win(overlap, dev)
    tail = w[:half] * etmp[:, half:].flip(1) \
        + w[half:].flip(0) * etmp[:, :half]
    return tail.to(torch.float32)


def _lcg_table(n: int):
    """[2, n] int64: the n-step LCG maps, state_k = (A[k] seed + C[k]) mod
    2^32 after k + 1 steps."""
    a, c = 1, 0
    out = np.zeros((2, n), np.int64)
    for k in range(n):
        a, c = (LCG_A * a) & M32, (LCG_A * c + LCG_C) & M32
        out[0, k], out[1, k] = a, c
    return out


def _mul_mod32(s, a):
    """(s a) mod 2^32 for s, a in [0, 2^32) as int64 (a split in 16-bit
    halves so no product passes 2^48)."""
    return (s * (a & 0xFFFF) + (((s * (a >> 16)) & 0xFFFF) << 16)) & M32


def lcg_noise(seed, lo: int, hi: int, n: int):
    """Noise for the bins [lo, hi) of an n-bin spectrum: bin lo + k takes
    the (k + 1)-th LCG state of ``seed`` [B] (uint32 values as int64),
    as ``signed(state) >> 20``.  Returns (X [B, n] f64, the last state)."""
    dev = seed.device
    tab = const(("plc_lcg", hi - lo), lambda: _lcg_table(hi - lo), dev)
    st = (_mul_mod32(seed[:, None], tab[0]) + tab[1]) & M32
    signed = st - ((st >> 31) << 32)
    x = torch.zeros((seed.shape[0], n), dtype=f64, device=dev)
    x[:, lo:hi] = (signed >> 20).to(f64)
    return x, st[:, -1]


def renormalise(x, ebands, lm: int, lo: int, hi: int):
    """Each band of [lo, hi) of x [B, n] scaled to unit energy
    (reference: renormalise_vector bands.c, gain 1)."""
    out = x.clone()
    for i in range(lo, hi):
        a, b = int(ebands[i]) << lm, int(ebands[i + 1]) << lm
        seg = x[:, a:b]
        e = EPSILON + (seg * seg).sum(1)
        out[:, a:b] = seg * (1.0 / torch.sqrt(e))[:, None]
    return out


def _periodic(st, dsp, tabs, n: int, lanes, hist2=None, pitch_in=None):
    """The periodic branch of one channel on every lane (the pitch search
    and the LPC only where a lane of ``lanes`` [B] needs them): (signal
    [B, N + overlap] f64, pitch [B], lpc [B, 24], zeroed [B] bool, the
    relative distances of the pitch and of the zeroing decision from a tie
    [B]).  hist2: the other channel's history, which the pitch search
    reads too; pitch_in: the period another channel's call found (the
    search runs once a frame)."""
    overlap = tabs.mode.overlap
    dev = dsp["hist"].device
    hist = dsp["hist"].to(f64)
    search = st["last_frame_type"] != FRAME_PLC_PERIODIC
    fade = torch.where(search, 1.0, 0.8).to(f64)
    w = _win(overlap, dev)
    exc = hist[:, DECODE_BUFFER_SIZE - MAX_PERIOD - CELT_LPC_ORDER:]
    pitch, lpc = st["last_pitch_index"], st["plc_lpc"]
    m_pitch = torch.ones_like(fade)
    if pitch_in is not None:
        pitch = pitch_in
    if bool((search & lanes).any()):
        if pitch_in is None:
            margin = {}
            pitch = torch.where(search, plc_pitch_search(hist, margin, hist2),
                                pitch)
            m_pitch = torch.where(search, margin["pitch"], m_pitch)
        ac = windowed_autocorr(exc[:, CELT_LPC_ORDER:], w, overlap,
                               CELT_LPC_ORDER)
        ac = torch.stack([ac[:, 0] * 1.0001] + [
            ac[:, i] - ac[:, i] * (0.008 * 0.008) * i * i
            for i in range(1, CELT_LPC_ORDER + 1)], dim=1)
        lpc = torch.where(search[:, None], celt_lpc(ac, CELT_LPC_ORDER), lpc)
    # lanes outside ``lanes`` may hold no period yet: keep their gathers
    # in range (their results are not selected)
    pitch = pitch.clamp_min(PLC_PITCH_LAG_MIN)

    # the excitation over the last exc_length samples, the rest as it was
    exc_len = torch.clamp(2 * pitch, max=MAX_PERIOD)
    pos = torch.arange(MAX_PERIOD, device=dev)[None, :]
    fir = celt_fir(exc, lpc, MAX_PERIOD)
    ex = torch.where(pos >= (MAX_PERIOD - exc_len)[:, None], fir,
                     exc[:, CELT_LPC_ORDER:])
    dlen = (exc_len >> 1)[:, None]
    e2sel = (pos >= MAX_PERIOD - 2 * dlen) & (pos < MAX_PERIOD - dlen)
    ex2 = ex * ex
    e1 = 1.0 + torch.where(pos >= MAX_PERIOD - dlen, ex2, 0.0).sum(1)
    e2 = 1.0 + torch.where(e2sel, ex2, 0.0).sum(1)
    decay = torch.sqrt(torch.minimum(e1, e2) / e2)

    # periodic extrapolation: attenuation fade*decay, times decay at each
    # wrap (repeated products, as the scalar rounds them)
    ext_len = n + overlap
    i = torch.arange(ext_len, device=dev)[None, :]
    k = torch.div(i, pitch[:, None], rounding_mode="floor")
    j = i - k * pitch[:, None]
    nwrap = (ext_len - 1) // PLC_PITCH_LAG_MIN + 1
    att = [fade * decay]
    for _ in range(nwrap - 1):
        att.append(att[-1] * decay)
    att = torch.stack(att, dim=1).gather(1, k)
    src = (MAX_PERIOD - pitch)[:, None] + j
    y = att * ex.gather(1, src)
    back = hist.gather(1, DECODE_BUFFER_SIZE - pitch[:, None] + j)
    s1 = (back * back).sum(1)
    y = celt_iir(y, lpc, hist[:, DECODE_BUFFER_SIZE - CELT_LPC_ORDER:]
                 .flip(1))
    s2 = (y * y).sum(1)
    zeroed = ~(s1 > 0.2 * s2)
    ratio = torch.sqrt((s1 + 1) / (s2 + 1))
    g = torch.cat([1.0 - w[None, :] * (1.0 - ratio[:, None]),
                   ratio[:, None].expand(-1, ext_len - overlap)], dim=1)
    y = torch.where((s1 < s2)[:, None], y * g, y)
    y = torch.where(zeroed[:, None], 0.0, y)
    m_zero = (s1 - 0.2 * s2).abs() / (s1 + 0.2 * s2 + 1.0)
    return y, pitch, lpc, zeroed, m_pitch, m_zero


def channel_state(state: dict, k: int) -> dict:
    """Channel k's view of a two-channel decoder state (fused_celt_init_
    state with out_channels=2): its synthesis state, concealment LPC,
    fold, energies and background under the mono keys."""
    if k == 0:
        return state
    return dict(state, dsp=state["dsp_1"], fold=state["fold_1"],
                plc_lpc=state["plc_lpc_1"], old_e=state["e_copy"],
                background=state["background_1"])


def to_rows(dicts):
    """Per-channel dicts of [B, ...] tensors -> one of [B * C, ...] rows
    (lane-major, as the synthesis state), and back (``from_rows``)."""
    return {k: torch.stack([d[k] for d in dicts], 1).flatten(0, 1)
            for k in dicts[0]}


def from_rows(d, c: int):
    return [{k: v.unflatten(0, (-1, c))[:, i] for k, v in d.items()}
            for i in range(c)]


def _noise(st, tabs, n: int, cc: int = 1, downsample: int = 1):
    """The noise branch on every lane, over cc output channels: (the
    postfiltered signal of each channel [B, N] f32, each channel's new
    tail and hist, decayed energies [B, nb] f32, the LCG state).  The
    LCG runs on from one channel's bins to the next's."""
    mode = tabs.mode
    lm, start, end = tabs.lm, tabs.start, tabs.end_band
    overlap = mode.overlap
    chans = [channel_state(st, k) for k in range(cc)]
    dev = st["dsp"]["hist"].device
    b = st["dsp"]["hist"].shape[0]
    eff_end = max(start, min(end, mode.effEBands))
    decay = torch.where(st["loss_duration"] == 0, 1.5, 0.5).to(f64)
    inside = torch.zeros(tabs.nb, dtype=torch.bool, device=dev)
    inside[start:end] = True
    eb = mode.eBands
    lo, hi = int(eb[start]) << lm, int(eb[eff_end]) << lm
    es, xs = [], []
    seed = st["seed"]
    for ch in chans:
        old = ch["old_e"].to(f64)
        e = torch.where(inside, torch.maximum(ch["background"].to(f64),
                                              old - decay[:, None]), old)
        es.append(e.to(torch.float32))
        x, seed = lcg_noise(seed, lo, hi, n)
        xs.append(renormalise(x, eb, lm, start, eff_end).to(torch.float32))
    minp = COMBFILTER_MINPERIOD
    pp = st["pf_period"].clamp_min(minp)
    periods = torch.stack([st["pf_period_old"].clamp_min(minp), pp, pp], 1)
    comb = const("comb_gains",
                 lambda: np.asarray(COMB_GAINS, np.float32), dev)
    gains3 = torch.stack([st["pf_gain_old"], st["pf_gain"], st["pf_gain"]],
                         dim=-1)
    taps3 = torch.stack([st["pf_tapset_old"], st["pf_tapset"],
                         st["pf_tapset"]], dim=-1)
    false = torch.zeros(b, dtype=torch.bool, device=dev)
    dsps = [dict(ch["dsp"], tail=fold_tails(ch, overlap)) for ch in chans]
    filt, syn = synth_step(torch.stack(xs, 1), torch.stack(es, 1), false,
                           false, periods, gains3[..., None] * comb[taps3],
                           dsps[0] if cc == 1 else to_rows(dsps),
                           fs=mode.Fs, frame_size=n, lm=lm,
                           downsample=downsample)
    filts = list(filt.unflatten(0, (b, cc)).unbind(1))
    syns = [syn] if cc == 1 else from_rows(syn, cc)
    return filts, syns, es, seed


def decode_lost(state: dict, tabs, lanes, out_channels: int = 1,
                downsample: int = 1):
    """One concealed frame (reference: celt_decode_lost) on the lanes of
    ``lanes`` [B] bool that have decoded a packet before
    (``decoded_any``), over ``out_channels`` channels (2: the state of
    fused_celt_init_state with out_channels=2; the pitch search runs once
    on the two channels' downmix, the rest per channel): the state dict
    of ``fused_celt_init_state`` -> (pcm [B, CC, N] f32, zeros on the
    other lanes, the new state, which the other lanes keep bit for bit,
    and the trace: each lane's ``branch`` (FRAME_PLC_*, FRAME_NORMAL where
    it did not conceal), ``pitch`` and ``zeroed`` (on any channel) of a
    periodic frame, and the relative distances of the pitch search's and
    the zeroing's decisions from a tie, ``pitch_margin`` (1 where the
    period was not searched) and ``zero_margin`` (the least over the
    channels)).  downsample: 48000 / the decoder's rate; the concealment
    runs at 48 kHz and every downsample-th de-emphasised sample is output
    (pcm [B, CC, N / downsample])."""
    cc = out_channels
    mode = tabs.mode
    lm, m = tabs.lm, tabs.M
    n = mode.shortMdctSize << lm
    overlap = mode.overlap
    chans = [channel_state(state, k) for k in range(cc)]
    dsps = [ch["dsp"] for ch in chans]
    dev = dsps[0]["hist"].device
    conc = lanes & state["decoded_any"]
    noise = (state["plc_duration"] >= PLC_NOISE_AFTER) \
        | (state["skip_plc"] != 0)
    if tabs.start != 0:
        noise = torch.ones_like(noise)
    per = conc & ~noise
    noi = conc & noise
    b = conc.shape[0]
    filt = [torch.zeros((b, n), dtype=torch.float32, device=dev)] * cc
    new = dict(state)
    ndsp = [dict(d) for d in dsps]
    suffix = ("", "_1")
    pitch = torch.zeros(b, dtype=torch.int64, device=dev)
    zeroed = torch.zeros(b, dtype=torch.bool, device=dev)
    m_pitch = torch.ones(b, dtype=f64, device=dev)
    m_zero = m_pitch
    any_per, any_noi = bool(per.any()), bool(noi.any())
    if any_per:
        sel = per[:, None]
        for k, ch in enumerate(chans):
            if k == 0:
                hist2 = dsps[1]["hist"].to(f64) if cc == 2 else None
                y, pitch, lpc, z, m_pitch, mz = _periodic(
                    ch, dsps[0], tabs, n, per, hist2=hist2)
                zeroed, m_zero = z, mz
            else:
                y, _p, lpc, z, _mp, mz = _periodic(ch, dsps[k], tabs, n, per,
                                                   pitch_in=pitch)
                zeroed = zeroed | z
                m_zero = torch.minimum(m_zero, mz)
            y32 = y.to(torch.float32)
            filt[k] = torch.where(sel, y32[:, :n], filt[k])
            ndsp[k]["hist"] = torch.where(sel, torch.cat(
                [dsps[k]["hist"][:, n:], y32[:, :n]], dim=1), dsps[k]["hist"])
            new["fold" + suffix[k]] = torch.where(
                sel, y32[:, n:n + overlap], ch["fold"])
            new["plc_lpc" + suffix[k]] = torch.where(sel, lpc, ch["plc_lpc"])
        new.update(
            last_pitch_index=torch.where(per, pitch,
                                         state["last_pitch_index"]),
            prefilter_and_fold=torch.where(per, 1,
                                           state["prefilter_and_fold"]))
    if any_noi:
        f_n, syns, es, seed = _noise(state, tabs, n, cc, downsample)
        sel = noi[:, None]
        for k in range(cc):
            filt[k] = torch.where(sel, f_n[k], filt[k])
            ndsp[k].update(
                tail=torch.where(sel, syns[k]["tail"], ndsp[k]["tail"]),
                hist=torch.where(sel, syns[k]["hist"], ndsp[k]["hist"]))
        pp = state["pf_period"].clamp_min(COMBFILTER_MINPERIOD)
        new.update(
            old_e=torch.where(sel, es[0], state["old_e"]),
            seed=torch.where(noi, seed, state["seed"]),
            pf_period=torch.where(noi, pp, state["pf_period"]),
            pf_period_old=torch.where(noi, pp, state["pf_period_old"]),
            pf_gain_old=torch.where(noi, state["pf_gain"],
                                    state["pf_gain_old"]),
            pf_tapset_old=torch.where(noi, state["pf_tapset"],
                                      state["pf_tapset_old"]),
            prefilter_and_fold=torch.where(noi, 0,
                                           new["prefilter_and_fold"]),
            skip_plc=torch.where(noi, 1, state["skip_plc"]))
        if cc == 2:
            new["e_copy"] = torch.where(sel, es[1], state["e_copy"])
    pcm = torch.zeros((b, cc, n // downsample), dtype=torch.float32,
                      device=dev)
    if any_per or any_noi:
        mem = torch.stack([d["deemph"] for d in dsps], 1).flatten()
        y, deemph = deemphasize(torch.stack(filt, 1).flatten(0, 1), mem,
                                mode.Fs, n, downsample)
        y, deemph = y.unflatten(0, (b, cc)), deemph.unflatten(0, (b, cc))
        for k in range(cc):
            ndsp[k]["deemph"] = torch.where(conc, deemph[:, k],
                                            dsps[k]["deemph"])
        pcm = torch.where(conc[:, None, None], y, pcm)
    for k in range(cc):
        new["dsp" + suffix[k]] = ndsp[k]
    new.update(
        loss_duration=torch.clamp(state["loss_duration"] + m,
                                  max=DURATION_CAP),
        plc_duration=torch.clamp(state["plc_duration"] + m,
                                 max=DURATION_CAP),
        last_frame_type=torch.where(per, FRAME_PLC_PERIODIC,
                                    FRAME_PLC_NOISE))
    new = select_lanes(conc, new, state)
    trace = dict(branch=torch.where(per, FRAME_PLC_PERIODIC, torch.where(
        noi, FRAME_PLC_NOISE, FRAME_NORMAL)), pitch=torch.where(per, pitch, 0),
        zeroed=zeroed & per, pitch_margin=torch.where(per, m_pitch, 1.0),
        zero_margin=torch.where(per, m_zero, 1.0))
    return pcm, new, trace


def fold_tails(state: dict, overlap: int):
    """The IMDCT tail a good frame starts from: the folded extrapolation on
    lanes whose last frame was periodic, the stored tail elsewhere."""
    dsp = state["dsp"]
    on = state["prefilter_and_fold"] != 0
    if not bool(on.any()):
        return dsp["tail"]
    return torch.where(on[:, None], prefilter_and_fold(
        state["fold"], dsp["hist"], state["pf_gain"], state["pf_period"],
        state["pf_tapset"], overlap), dsp["tail"])
