"""LPCNet feature analysis over a leading batch of streams: port of
``opus_tpu/dnn/features.py`` (reference: dnn/freq.c, dnn/lpcnet_enc.c,
dnn/burg.c; tables from dnn/dump_lpcnet_tables.c).

Per 10 ms / 160-sample 16 kHz frame: 36 features = 18 Burg-flavoured band
cepstra + the DNN pitch + the pitch correlation + 16 LPC coefficients.
Deep PLC and DRED consume the first 20.

Every function takes [B, ...] tensors and computes, lane by lane, what the
numpy function computes for one stream, in the dtype that step computes
in there: float64 for the FFTs, Burg, Levinson, the biquad, the xcorr
energies and the pitch period; float32 where numpy stays float32 (the
preemphasis and pitch FIRs, whose Python-float coefficients are weak
under NumPy 2's promotion rules, and the cepstrum's running maxima).
Logarithms that numpy takes in float32 are taken here in float64 and
rounded once, and so are the DCT's 18-term sums (numpy's float32 BLAS
order is its own), so the card and the CPU agree bit for bit on all but
astronomically rare inputs.  Loops that break early in numpy (Burg's gain limit, Levinson's
30 dB bail-out) run every iteration here with a per-lane mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.device_cache import const
from . import pitchdnn as pdnn

LPC_ORDER = 16
PREEMPHASIS = 0.85
FRAME_SIZE = 160
OVERLAP_SIZE = 160
TRAINING_OFFSET = 80
WINDOW_SIZE = FRAME_SIZE + OVERLAP_SIZE          # 320
FREQ_SIZE = WINDOW_SIZE // 2 + 1                 # 161
NB_BANDS = 18
NB_FEATURES = 20
NB_TOTAL_FEATURES = 36
WINDOW_SIZE_5MS = 4
PITCH_MIN_PERIOD = pdnn.PITCH_MIN_PERIOD
PITCH_MAX_PERIOD = pdnn.PITCH_MAX_PERIOD
PITCH_IF_MAX_FREQ = pdnn.PITCH_IF_MAX_FREQ
PITCH_BUF = PITCH_MAX_PERIOD + FRAME_SIZE        # 416

# (reference: eband5ms dnn/freq.c:45)
EBAND5MS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20,
                     24, 28, 34, 40])
# (reference: compensation dnn/freq.c:50)
_COMPENSATION = np.array([0.8, 1, 1, 1, 1, 1, 1, 1, 0.666667, 0.5, 0.5,
                          0.5, 0.333333, 0.25, 0.25, 0.2, 0.166667,
                          0.173913], np.float32)

# tables (reference: dump_lpcnet_tables.c:84-100)
_i = np.arange(OVERLAP_SIZE)
HALF_WINDOW = np.sin(
    0.5 * np.pi * np.sin(0.5 * np.pi * (_i + 0.5) / OVERLAP_SIZE) ** 2
).astype(np.float32)
_ii, _jj = np.meshgrid(np.arange(NB_BANDS), np.arange(NB_BANDS),
                       indexing="ij")
DCT_TABLE = np.cos((_ii + 0.5) * _jj * np.pi / NB_BANDS)
DCT_TABLE[:, 0] *= np.sqrt(0.5)
DCT_TABLE = DCT_TABLE.astype(np.float32)
del _i, _ii, _jj
_DCT_SCALE = float(np.sqrt(2.0 / NB_BANDS))


def _band_matrix():
    """Triangular band interpolation matrix [FREQ_SIZE, NB_BANDS]."""
    m = np.zeros((FREQ_SIZE, NB_BANDS), np.float64)
    for b in range(NB_BANDS - 1):
        size = (EBAND5MS[b + 1] - EBAND5MS[b]) * WINDOW_SIZE_5MS
        for j in range(size):
            frac = j / size
            m[EBAND5MS[b] * WINDOW_SIZE_5MS + j, b] += 1 - frac
            m[EBAND5MS[b] * WINDOW_SIZE_5MS + j, b + 1] += frac
    m[:, 0] *= 2
    m[:, NB_BANDS - 1] *= 2
    return m


_BAND_M = _band_matrix()


def _interp_plan():
    """``_interp_band_gain``'s bins as (band index, frac) [FREQ_SIZE - 1]."""
    idx, frac = [], []
    for b in range(NB_BANDS - 1):
        size = (EBAND5MS[b + 1] - EBAND5MS[b]) * WINDOW_SIZE_5MS
        idx += [b] * size
        frac += list(np.arange(size) / size)
    return np.asarray(idx, np.int64), np.asarray(frac, np.float64)


def _c(name, fn, device):
    return const(("lpcnet_features", name), fn, device)


def _f64(x):
    return x.to(torch.float64)


def _log10_f32(x):
    """numpy's float32 log10, correctly rounded: taken in float64 and
    rounded once."""
    return torch.log10(_f64(x)).to(torch.float32)


def _matmul_f64(x, w):
    """x @ w with float64 products and sums (w a float64 constant)."""
    return torch.matmul(_f64(x), w)


def forward_transform(x):
    """320-point FFT with kiss_fft's forward 1/N scaling (reference:
    forward_transform dnn/freq.c:239).  x: [B, 320] -> complex128
    [B, FREQ_SIZE]."""
    return (torch.fft.fft(_f64(x)) / WINDOW_SIZE)[:, :FREQ_SIZE]


def compute_band_energy(X):
    """(reference: lpcn_compute_band_energy dnn/freq.c:126) -> f32 [B, 18]."""
    p = X.real ** 2 + X.imag ** 2
    return torch.matmul(p, _c("band_m", lambda: _BAND_M, X.device)) \
        .to(torch.float32)


def compute_band_energy_inverse(X):
    """(reference: compute_band_energy_inverse dnn/freq.c:54)"""
    p = 1.0 / (X.real ** 2 + X.imag ** 2 + 1e-9)
    return torch.matmul(p, _c("band_m", lambda: _BAND_M, X.device)) \
        .to(torch.float32)


def _dct_f32(x, table):
    """The float32 product ``x @ table`` of numpy (rounded once)."""
    t = _c(table, lambda: (DCT_TABLE if table == "dct" else DCT_TABLE.T)
           .astype(np.float64), x.device)
    return _matmul_f64(x, t).to(torch.float32)


def dct18(x):
    """(reference: dct dnn/freq.c:223).  float32 [B, 18] -> float64, as
    numpy's float32 product times the float64 sqrt(2/18)."""
    return _f64(_dct_f32(x, "dct")) * _DCT_SCALE


def idct18(x):
    return _f64(_dct_f32(x, "idct")) * _DCT_SCALE


def _seq_sum(start, terms):
    """start + terms[:, 0] + terms[:, 1] + ..., left to right."""
    acc = start
    for k in range(terms.shape[-1]):
        acc = acc + terms[..., k]
    return acc


def burg_analysis(x, min_inv_gain: float, subfr_length: int, nb_subfr: int,
                  order: int):
    """Burg's method with max-gain limiting, double precision (reference:
    silk_burg_analysis dnn/burg.c:97), on [B] lanes.  x: f32 [B, >=
    nb_subfr * subfr_length].  Returns (A f32 [B, order], residual energy
    f64 [B]).

    The numpy loop breaks at the first order whose inverse gain reaches
    ``min_inv_gain``; here a lane that has reached it stops updating (the
    per-lane ``done`` mask) and its A keeps zeros above that order."""
    L = subfr_length
    xs = _f64(x)
    subs = [xs[:, s * L:(s + 1) * L] for s in range(nb_subfr)]
    C0 = torch.sum(xs[:, :nb_subfr * L] ** 2, dim=1)
    C_first = torch.zeros(x.shape[0], order, dtype=torch.float64,
                          device=x.device)
    for xp in subs:
        C_first = C_first + torch.stack(
            [torch.sum(xp[:, :L - n] * xp[:, n:], dim=1)
             for n in range(1, order + 1)], dim=1)
    C_last = C_first
    c0 = C0 + 1e-5 * C0 + 1e-9
    CAf = CAb = torch.cat([c0[:, None], torch.zeros_like(C_first)], dim=1)
    Af = torch.zeros(x.shape[0], order, dtype=torch.float64, device=x.device)
    inv_gain = torch.ones_like(C0)
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for n in range(order):
        live = ~done
        cf, cl, caf, cab = C_first, C_last, CAf, CAb
        for xp in subs:
            a = Af[:, :n]
            x_rev = xp[:, :n].flip(1)                    # xp[n-k-1]
            x_tail = xp[:, L - n:L]                      # xp[L-n+k]
            cf = torch.cat([cf[:, :n] - xp[:, n:n + 1] * x_rev,
                            cf[:, n:]], dim=1)
            cl = torch.cat([cl[:, :n] - xp[:, L - n - 1:L - n] * x_tail,
                            cl[:, n:]], dim=1)
            t1 = _seq_sum(xp[:, n], x_rev * a)
            t2 = _seq_sum(xp[:, L - n - 1], x_tail * a)
            # CAf[k] -= tmp1 * xp[n-k], CAb[k] -= tmp2 * xp[L-n+k-1], k<=n
            caf = torch.cat([caf[:, :n + 1]
                             - t1[:, None] * xp[:, :n + 1].flip(1),
                             caf[:, n + 1:]], dim=1)
            cab = torch.cat([cab[:, :n + 1]
                             - t2[:, None] * xp[:, L - n - 1:L],
                             cab[:, n + 1:]], dim=1)
        a = Af[:, :n]
        t1 = _seq_sum(cf[:, n], cl[:, :n].flip(1) * a)
        t2 = _seq_sum(cl[:, n], cf[:, :n].flip(1) * a)
        caf = torch.cat([caf[:, :n + 1], t1[:, None], caf[:, n + 2:]], dim=1)
        cab = torch.cat([cab[:, :n + 1], t2[:, None], cab[:, n + 2:]], dim=1)
        num = _seq_sum(t2, cab[:, 1:n + 1].flip(1) * a)
        nrg_b = _seq_sum(cab[:, 0], cab[:, 1:n + 1] * a)
        nrg_f = _seq_sum(caf[:, 0], caf[:, 1:n + 1] * a)
        rc = -2.0 * num / (nrg_f + nrg_b)
        tmp1 = inv_gain * (1.0 - rc * rc)
        clamp = tmp1 <= min_inv_gain
        rc_max = torch.sqrt(1.0 - min_inv_gain / inv_gain)
        rc = torch.where(clamp, torch.where(num > 0, -rc_max, rc_max), rc)
        new_gain = torch.where(clamp, torch.full_like(tmp1, min_inv_gain),
                               tmp1)
        af = torch.cat([a + rc[:, None] * a.flip(1), rc[:, None],
                        Af[:, n + 1:]], dim=1)
        # CAf[k] += rc * CAb[n-k+1], CAb[n-k+1] += rc * CAf[k], k <= n+1
        ca_f, ca_b = caf[:, :n + 2], cab[:, :n + 2]
        caf2 = torch.cat([ca_f + rc[:, None] * ca_b.flip(1), caf[:, n + 2:]],
                         dim=1)
        cab2 = torch.cat([ca_b + rc[:, None] * ca_f.flip(1), cab[:, n + 2:]],
                         dim=1)
        keep = live[:, None]
        Af = torch.where(keep, af, Af)
        inv_gain = torch.where(live, new_gain, inv_gain)
        stop = live & clamp
        C_first = torch.where(keep, cf, C_first)
        C_last = torch.where(keep, cl, C_last)
        # a lane that stops here keeps its correlations unrotated, as the
        # numpy loop breaks before the rotation
        upd = (live & ~clamp)[:, None]
        CAf = torch.where(upd, caf2, torch.where(keep, caf, CAf))
        CAb = torch.where(upd, cab2, torch.where(keep, cab, CAb))
        done = done | stop
    # reached the gain limit: energy of what Burg could not predict
    c0m = C0
    for s in range(nb_subfr):
        xp = xs[:, s * L:s * L + order]
        c0m = c0m - torch.sum(xp * xp, dim=1)
    nrg_lim = c0m * inv_gain
    nrg_f = _seq_sum(CAf[:, 0], CAf[:, 1:] * Af)
    tmp1 = _seq_sum(torch.ones_like(C0), Af * Af)
    nrg_full = nrg_f - 1e-5 * C0 * tmp1
    nrg = torch.where(done, nrg_lim, nrg_full)
    return (-Af).to(torch.float32), torch.clamp_min(nrg, 0.0)


def lpcn_lpc(ac, order: int):
    """Levinson-Durbin with the 30 dB bail-out (reference: lpcn_lpc
    dnn/freq.c:81) on [B] lanes.  ac: f64 [B, order + 1].  Returns (lpc
    f32 [B, order], error f64 [B]); a lane that bails out keeps zeros
    above the order it reached, as the numpy loop leaves them."""
    b = ac.shape[0]
    lpc = torch.zeros(b, order, dtype=torch.float64, device=ac.device)
    error = ac[:, 0]
    live = ac[:, 0] != 0
    thr = 0.001 * ac[:, 0]
    for i in range(order):
        rr = _seq_sum(torch.zeros_like(error),
                      lpc[:, :i] * ac[:, 1:i + 1].flip(1))   # lpc[j] ac[i-j]
        rr = rr + ac[:, i + 1]
        r = -rr / error
        old = lpc[:, :i]
        new = torch.cat([old + r[:, None] * old.flip(1), r[:, None],
                         lpc[:, i + 1:]], dim=1)
        err = error - r * r * error
        lpc = torch.where(live[:, None], new, lpc)
        error = torch.where(live, err, error)
        live = live & ~(err < thr)
    return lpc.to(torch.float32), error


def lpc_from_bands(Ex):
    """(reference: lpc_from_bands dnn/freq.c:270).  Ex: f64 [B, 18]."""
    dev = Ex.device
    idx, frac = (_c("interp_idx", lambda: _interp_plan()[0], dev),
                 _c("interp_frac", lambda: _interp_plan()[1], dev))
    g = (1 - frac) * Ex[:, idx] + frac * Ex[:, idx + 1]      # [B, 160]
    xr = torch.cat([g, torch.zeros_like(g[:, :1])], dim=1)    # bin 160 = 0
    full = torch.cat([xr, xr[:, 1:FREQ_SIZE - 1].flip(1)], dim=1)
    # kiss's inverse transform has no 1/N; ifft's is undone
    x_auto = torch.fft.ifft(full).real * WINDOW_SIZE
    ac = x_auto[:, :LPC_ORDER + 1]
    ac0 = ac[:, :1] + (ac[:, :1] * 1e-4 + 320 / 12 / 38.0)
    lag = _c("lag_window", lambda: 1 - 6e-5 * np.arange(
        1, LPC_ORDER + 1) ** 2, dev)
    return lpcn_lpc(torch.cat([ac0, ac[:, 1:] * lag], dim=1), LPC_ORDER)


def lpc_from_cepstrum(cepstrum):
    """(reference: lpc_from_cepstrum dnn/freq.c:305).  cepstrum: f32
    [B, >= 18]."""
    tmp = cepstrum[:, :NB_BANDS].to(torch.float32)
    tmp = torch.cat([tmp[:, :1] + 4, tmp[:, 1:]], dim=1)
    comp = _c("compensation", lambda: _COMPENSATION.astype(np.float64),
              cepstrum.device)
    return lpc_from_bands(torch.pow(10.0, idct18(tmp)) * comp)


def _cepstrum_floor(E):
    """log10 of the band energies with the reference's running floors
    (log_max - 8, follow - 2.5), float32 as numpy computes it."""
    v = _log10_f32(E + 1e-2)
    log_max = torch.full_like(v[:, 0], -2.0)
    follow = log_max
    out = []
    for i in range(NB_BANDS):
        vi = torch.maximum(log_max - 8, torch.maximum(follow - 2.5, v[:, i]))
        log_max = torch.maximum(log_max, vi)
        follow = torch.maximum(follow - 2.5, vi)
        out.append(vi)
    return torch.stack(out, dim=1)


def compute_burg_cepstrum(pcm, length: int, order: int):
    """(reference: compute_burg_cepstrum dnn/freq.c:159).  pcm: f32
    [B, >= length].  Returns f64 [B, 18]."""
    pcm = pcm.to(torch.float32)
    burg_in = pcm[:, 1:length] - PREEMPHASIS * pcm[:, :length - 1]
    lpc, g = burg_analysis(burg_in, 1e-3, length - 1, 1, order)
    g = g / (length - 2 * (order - 1))
    dev = pcm.device
    pw = _c(("burg_pw", order), lambda: 0.995 ** np.arange(1, order + 1), dev)
    x = torch.zeros(pcm.shape[0], WINDOW_SIZE, dtype=torch.float32,
                    device=dev)
    x[:, 0] = 1
    x[:, 1:order + 1] = (_f64(-lpc) * pw).to(torch.float32)
    e = compute_band_energy_inverse(forward_transform(x))
    # numpy multiplies the f32 energies by the Python-float gain in f32
    e = e * (0.45 * g / float(WINDOW_SIZE) ** 3).to(torch.float32)[:, None]
    ceps = dct18(_cepstrum_floor(e))
    return torch.cat([ceps[:, :1] - 4, ceps[:, 1:]], dim=1)


def burg_cepstral_analysis(x):
    """Two half-frame cepstra -> mean/diff (reference:
    burg_cepstral_analysis dnn/freq.c:183).  x: f32 [B, 160] ->
    f64 [B, 36].  The halves run as one batch of 2B lanes."""
    half = FRAME_SIZE // 2
    b = x.shape[0]
    both = torch.cat([x[:, :half], x[:, half:FRAME_SIZE]], dim=0)
    c = compute_burg_cepstrum(both, half, LPC_ORDER)
    c0, c1 = c[:b], c[b:]
    return torch.cat([0.5 * (c0 + c1), c0 - c1], dim=1)


def celt_fir(x_hist, num, n: int, order: int):
    """y[i] = x[i] + sum_j num[j] * x[i-j-1] (reference: celt_fir_c
    celt/celt_lpc.c:146): each product in float32, the sum in float64, as
    numpy computes it.  x_hist: f32 [B, order + n] (the history first),
    num: f32 [B, order]."""
    y = _f64(x_hist[:, order:order + n])
    for j in range(order):
        y = y + _f64(num[:, j:j + 1]
                     * x_hist[:, order - 1 - j:order - 1 - j + n])
    return y.to(torch.float32)


class FeatureState(NamedTuple):
    analysis_mem: torch.Tensor     # [B, OVERLAP] f32
    mem_preemph: torch.Tensor      # [B] f32
    prev_if: torch.Tensor          # [B, PITCH_IF_MAX_FREQ] complex128
    pitch_mem: torch.Tensor        # [B, LPC_ORDER] f32
    pitch_filt: torch.Tensor       # [B] f32
    exc_buf: torch.Tensor          # [B, PITCH_MAX_PERIOD + FRAME] f32
    lp_buf: torch.Tensor           # [B, PITCH_MAX_PERIOD + FRAME] f32
    lp_mem: torch.Tensor           # [B, 2] f64
    dnn: pdnn.PitchDNNState


def init_state(batch: int, *, device) -> FeatureState:
    """The zero state of ``batch`` streams on ``device``."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)
    return FeatureState(
        analysis_mem=z(OVERLAP_SIZE), mem_preemph=z(),
        prev_if=z(PITCH_IF_MAX_FREQ, dtype=torch.complex128),
        pitch_mem=z(LPC_ORDER), pitch_filt=z(), exc_buf=z(PITCH_BUF),
        lp_buf=z(PITCH_BUF), lp_mem=z(2, dtype=torch.float64),
        dnn=pdnn.init_state(batch, device=device))


_LP_B = (-0.84946, 1.0)
_LP_A = (-1.54220, 0.70781)


def biquad(x, mem, b=_LP_B, a=_LP_A):
    """(reference: biquad dnn/lpcnet_enc.c:85) in float64 on [B] lanes,
    one step a sample as the numpy loop: x f32 [B, N], mem f64 [B, 2].
    Returns (y f32 [B, N], new mem)."""
    xd = _f64(x)
    # the input terms, vectorised: (b0 - a0) x and (b1 - a1) x + 1e-30
    p = (b[0] - a[0]) * xd
    q = (b[1] - a[1]) * xd + 1e-30
    m0, m1 = mem[:, 0], mem[:, 1]
    m0s = []
    for i in range(x.shape[1]):
        m0s.append(m0)
        m0, m1 = p[:, i] + m1 - a[0] * m0, q[:, i] - a[1] * m0
    y = (xd + torch.stack(m0s, dim=1)).to(torch.float32)
    return y, torch.stack([m0, m1], dim=1)


def pitch_period(dnn_pitch):
    """The pitch period of compute_frame_features (lpcnet_enc.c:188),
    floor(0.5 + 256 / 2**((1/60) * ((p + 1.5) * 60))) in float64 on the
    float32 pitch, as the numpy code computes it on a Python float.
    Returns int64 [B]."""
    e = (1.0 / 60) * ((_f64(dnn_pitch) + 1.5) * 60)
    return torch.floor(0.5 + 256.0 / torch.pow(2.0, e)).to(torch.int64)


_SOFTPLUS_NORM = float(np.log(1 + np.exp(5.0)))


def compute_frame_features(st: FeatureState, pcm, model: pdnn.PitchDNNModel):
    """One 160-sample frame per lane -> 36 features (reference:
    compute_frame_features dnn/lpcnet_enc.c:107 + the preemphasis of
    lpcnet_compute_single_frame_features_impl :209).  pcm: [B, 160].
    Returns (new state, features f32 [B, 36])."""
    x0 = pcm.to(torch.float32)
    dev = x0.device
    b = x0.shape[0]
    # preemphasis (lpcnet_enc.c:199): y = x + mem, mem = -0.85 x, in f32
    prev = torch.cat([st.mem_preemph[:, None],
                      -PREEMPHASIS * x0[:, :FRAME_SIZE - 1]], dim=1)
    x = x0 + prev
    mem_preemph = -PREEMPHASIS * x0[:, FRAME_SIZE - 1]
    # frame analysis: window + FFT + band energies
    hw = _c("half_window", lambda: HALF_WINDOW.astype(np.float64), dev)
    win = torch.cat([_f64(st.analysis_mem) * hw, _f64(x) * hw.flip(0)],
                    dim=1)
    X = forward_transform(win)
    Ex = compute_band_energy(X)
    analysis_mem = x[:, FRAME_SIZE - OVERLAP_SIZE:]
    # instantaneous-frequency features (lpcnet_enc.c:116)
    re, im = X.real[:, :PITCH_IF_MAX_FREQ], X.imag[:, :PITCH_IF_MAX_FREQ]
    pre, pim = st.prev_if.real[:, 1:], st.prev_if.imag[:, 1:]
    a, bb = re[:, 1:], im[:, 1:]
    prod_r = a * pre + bb * pim            # X * conj(prev), as numpy's
    prod_i = bb * pre - a * pim            # complex product
    norm = 1.0 / torch.sqrt(1e-15 + prod_r ** 2 + prod_i ** 2)

    def level(p2):
        return torch.clamp((1 / 64) * (10 * torch.log10(1e-15 + p2) - 6),
                           -1, 1)

    mag = level(torch.hypot(a, bb) ** 2)
    if_feat = torch.cat(
        [level(re[:, :1] ** 2),
         torch.stack([prod_r * norm, prod_i * norm, mag], dim=2)
         .reshape(b, 3 * (PITCH_IF_MAX_FREQ - 1))], dim=1).to(torch.float32)
    prev_if = X[:, :PITCH_IF_MAX_FREQ]
    # cepstrum and LPC
    ceps = dct18(_cepstrum_floor(Ex)).to(torch.float32)
    ceps = torch.cat([ceps[:, :1] - 4, ceps[:, 1:]], dim=1)
    lpc, _ = lpc_from_cepstrum(ceps)
    # pitch buffers (lpcnet_enc.c:135-152)
    aligned = torch.cat([st.analysis_mem[:, OVERLAP_SIZE - TRAINING_OFFSET:],
                         x[:, :FRAME_SIZE - TRAINING_OFFSET]], dim=1)
    xh = torch.cat([st.pitch_mem, aligned], dim=1)
    pitch_mem = aligned[:, FRAME_SIZE - LPC_ORDER:]
    lp = celt_fir(xh, lpc, FRAME_SIZE, LPC_ORDER)
    exc = lp + 0.7 * torch.cat([st.pitch_filt[:, None],
                                lp[:, :FRAME_SIZE - 1]], dim=1)
    pitch_filt = lp[:, FRAME_SIZE - 1]
    lp, lp_mem = biquad(lp, st.lp_mem)
    exc_buf = torch.cat([st.exc_buf[:, FRAME_SIZE:], exc], dim=1)
    lp_buf = torch.cat([st.lp_buf[:, FRAME_SIZE:], lp], dim=1)
    # normalised xcorr features (lpcnet_enc.c:154-185)
    nlag = PITCH_MAX_PERIOD - PITCH_MIN_PERIOD
    e64 = _f64(exc_buf)
    cur = e64[:, PITCH_MAX_PERIOD:]
    win_lags = e64.unfold(1, FRAME_SIZE, 1)[:, :nlag]       # [B, 224, 160]
    xcorr = torch.matmul(win_lags, cur[:, :, None])[:, :, 0]
    ener0 = torch.sum(cur * cur, dim=1)
    head = e64[:, :FRAME_SIZE]
    ener1 = torch.sum(head * head, dim=1)
    d = e64[:, FRAME_SIZE:FRAME_SIZE + nlag - 1] ** 2 \
        - e64[:, :nlag - 1] ** 2
    ener1 = torch.cumsum(torch.cat([ener1[:, None], d], dim=1), dim=1)
    xcf = (2 * xcorr / (1 + ener0[:, None] + ener1)).to(torch.float32)
    dnn_state, dnn_pitch = pdnn.compute_pitch(model, st.dnn, if_feat, xcf)
    pitch = pitch_period(dnn_pitch)
    lpb = _f64(lp_buf)
    now = lpb[:, PITCH_MAX_PERIOD:]
    lag = PITCH_MAX_PERIOD - pitch[:, None] \
        + torch.arange(FRAME_SIZE, device=dev)
    back = torch.gather(lpb, 1, lag)
    xx = torch.sum(now * now, dim=1)
    yy = torch.sum(back * back, dim=1)
    xy = torch.sum(now * back, dim=1)
    corr = xy / torch.sqrt(1 + xx * yy)
    corr = torch.log(1 + torch.exp(5 * corr)) / _SOFTPLUS_NORM
    feats = torch.cat([ceps, dnn_pitch[:, None],
                       (corr - 0.5).to(torch.float32)[:, None], lpc], dim=1)
    new_st = FeatureState(analysis_mem, mem_preemph, prev_if, pitch_mem,
                          pitch_filt, exc_buf, lp_buf, lp_mem, dnn_state)
    return new_st, feats

