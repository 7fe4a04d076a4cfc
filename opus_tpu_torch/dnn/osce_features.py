"""OSCE features from the SILK decoder's output and parameters over a
leading batch of streams: port of ``opus_tpu/dnn/osce_features.py``
(reference: dnn/osce_features.c).

Per 5 ms subframe, 93 features: the 64-band log spectrum of the LPC
synthesis filter (clean spectrum), the 18-band cepstrum of the decoded
signal (noisy cepstrum), a 5-tap normalised autocorrelation around the
pitch lag, the 5 LTP coefficients and the log subframe gain; per 20 ms
frame the raw and smoothed bit counts and the post-processed pitch lags.

Each step takes [B] lanes and computes, lane by lane, what the numpy
function computes for one stream, in the dtype numpy uses: the FFTs, the
filterbanks (a fixed [161, bands] matrix here), the logs, the DCT, the
autocorrelation and the log gain in float64, each rounded once to float32
as numpy rounds it; the smoothed bit count is a float64 per lane.  The
pitch lag of the autocorrelation is a per-lane gather.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.device_cache import const

OSCE_SPEC_WINDOW_SIZE = 320
OSCE_SPEC_NUM_FREQS = 161
OSCE_FEATURES_MAX_HISTORY = 350
OSCE_FEATURE_DIM = 93
OSCE_CLEAN_SPEC_START = 0
OSCE_CLEAN_SPEC_NUM_BANDS = 64
OSCE_NOISY_CEPSTRUM_START = 64
OSCE_NOISY_SPEC_NUM_BANDS = 18
OSCE_ACORR_START = 82
OSCE_LTP_START = 87
OSCE_LOG_GAIN_START = 92
OSCE_NO_PITCH_VALUE = 7
OSCE_PITCH_HANGOVER = 0
TYPE_VOICED = 2
SUBFRAME = 80

# (reference: center_bins_clean/noisy, band_weights_* osce_features.c:44)
CENTER_BINS_CLEAN = np.array([
    0, 2, 5, 8, 10, 12, 15, 18, 20, 22, 25, 28, 30, 33, 35, 38, 40, 42,
    45, 48, 50, 52, 55, 58, 60, 62, 65, 68, 70, 73, 75, 78, 80, 82, 85,
    88, 90, 92, 95, 98, 100, 102, 105, 108, 110, 112, 115, 118, 120,
    122, 125, 128, 130, 132, 135, 138, 140, 142, 145, 148, 150, 152,
    155, 160])
CENTER_BINS_NOISY = np.array([0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48,
                              56, 64, 80, 96, 112, 136, 160])


def _band_weights(center_bins):
    """weight_b = 2/support, with +1 at the edge bands (osce_features.c
    :72-97)."""
    n = len(center_bins)
    w = np.zeros(n)
    for b in range(n):
        lo = center_bins[b - 1] if b > 0 else center_bins[0]
        hi = center_bins[b + 1] if b < n - 1 else center_bins[-1]
        edge = 1 if b in (0, n - 1) else 0
        w[b] = 2.0 / (hi - lo + edge)
    return w


BAND_WEIGHTS_CLEAN = _band_weights(CENTER_BINS_CLEAN)
BAND_WEIGHTS_NOISY = _band_weights(CENTER_BINS_NOISY)

# analysis window sin((i+.5)*pi/320) (reference table osce_features.c:116)
OSCE_WINDOW = np.sin((np.arange(OSCE_SPEC_WINDOW_SIZE) + 0.5) * np.pi
                     / OSCE_SPEC_WINDOW_SIZE).astype(np.float32)

# orthonormal DCT-II, matches dnn/freq.c dct()
_ii, _jj = np.meshgrid(np.arange(18), np.arange(18), indexing="ij")
_DCT18 = np.cos((_ii + 0.5) * _jj * np.pi / 18)
_DCT18[:, 0] *= np.sqrt(0.5)
del _ii, _jj


def filterbank_matrix(center_bins, band_weights) -> np.ndarray:
    """apply_filterbank (osce_features.c:126) as a float64 [161, bands]
    matrix: out = x @ M."""
    n = len(center_bins)
    m = np.zeros((OSCE_SPEC_NUM_FREQS, n))
    for b in range(n - 1):
        i = np.arange(center_bins[b], center_bins[b + 1])
        frac = (center_bins[b + 1] - i) / (center_bins[b + 1]
                                           - center_bins[b])
        m[i, b] += band_weights[b] * frac
        m[i, b + 1] += band_weights[b + 1] * (1 - frac)
    m[center_bins[n - 1], n - 1] += band_weights[n - 1]
    return m


def _tab(name, device) -> torch.Tensor:
    make = {
        "fb_clean": lambda: filterbank_matrix(CENTER_BINS_CLEAN,
                                              BAND_WEIGHTS_CLEAN),
        "fb_noisy": lambda: filterbank_matrix(CENTER_BINS_NOISY,
                                              BAND_WEIGHTS_NOISY),
        "dct": lambda: _DCT18 * np.sqrt(2.0 / 18),
        "window": lambda: OSCE_WINDOW.astype(np.float64),
    }[name]
    return const(("osce_features", name), make, device)


def mag_spec_320(x) -> torch.Tensor:
    """Unnormalised one-sided magnitude spectrum of [..., <= 320] float64
    (reference: mag_spec_320_onesided osce_features.c:150)."""
    return torch.fft.rfft(x.to(torch.float64), n=OSCE_SPEC_WINDOW_SIZE).abs()


def calculate_log_spectrum_from_lpc(a_q12, lpc_order: int) -> torch.Tensor:
    """(reference: calculate_log_spectrum_from_lpc osce_features.c:229).
    a_q12 [..., >= lpc_order] int -> [..., 64] f32."""
    a = -a_q12[..., :lpc_order].to(torch.float64) / 4096.0
    buf = torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)
    inv = 1.0 / (mag_spec_320(buf) + 1e-9)
    spec = inv @ _tab("fb_clean", a.device)
    return (0.3 * torch.log(spec + 1e-9)).to(torch.float32)


def calculate_cepstrum(signal) -> torch.Tensor:
    """(reference: calculate_cepstrum osce_features.c:259).  signal
    [..., 320] f32, the samples ending at the current subframe's end ->
    [..., 18] f32."""
    win = _tab("window", signal.device) * signal.to(torch.float64)
    spec = mag_spec_320(win) @ _tab("fb_noisy", signal.device)
    return (torch.log(spec + 1e-9) @ _tab("dct", signal.device)) \
        .to(torch.float32)


def calculate_acorr(buffer, fstart, lag) -> torch.Tensor:
    """5-tap normalised autocorrelation around the pitch lag (reference:
    calculate_acorr osce_features.c:292), for the 80 samples of buffer
    [B, N] f32 at ``fstart`` (an int, or [B, n] subframe starts) against
    those ``lag`` + 2 .. lag - 2 earlier (lag [B, n] int).  Returns [B, n,
    5] f32; float64 sums."""
    b, nbuf = buffer.shape
    x = buffer.to(torch.float64)
    dev = x.device
    i = torch.arange(SUBFRAME, device=dev)
    k = torch.arange(-2, 3, device=dev)
    fstart = torch.as_tensor(fstart, device=dev).expand(lag.shape)
    cur_idx = fstart[..., None] + i                             # [B, n, 80]
    seg_idx = (fstart - lag)[..., None, None] + k[:, None] + i  # [B,n,5,80]

    def take(idx):
        flat = idx.clamp(0, nbuf - 1).reshape(b, -1)
        return torch.gather(x, 1, flat).reshape(idx.shape)

    cur = take(cur_idx)
    seg = take(seg_idx)
    xx = (cur * cur).sum(-1)[..., None]
    yy = (seg * seg).sum(-1)
    xy = (cur[:, :, None] * seg).sum(-1)
    return (xy / torch.sqrt(xx * yy + 1e-9)).to(torch.float32)


class OSCEFeatureState(NamedTuple):
    """The JAX ``OSCEFeatureState`` without its pitch-hangover fields
    (last lag, last type, hangover count): the hangover is disabled
    (OSCE_PITCH_HANGOVER = 0), so nothing reads them."""
    numbits_smooth: torch.Tensor        # [B] float64
    signal_history: torch.Tensor        # [B, 350] f32


def init_feature_state(batch: int, *, device) -> OSCEFeatureState:
    return OSCEFeatureState(
        torch.zeros((batch,), dtype=torch.float64, device=device),
        torch.zeros((batch, OSCE_FEATURES_MAX_HISTORY), device=device))


def pitch_postprocessing(lags, sig_type):
    """(reference: pitch_postprocessing osce_features.c:314; the hangover
    disabled as in the deployed training code).  lags [B, n] int,
    sig_type [B] -> periods [B, n] int64: the lag on voiced lanes,
    OSCE_NO_PITCH_VALUE elsewhere."""
    return torch.where((sig_type == TYPE_VOICED)[:, None],
                       lags.to(torch.int64), OSCE_NO_PITCH_VALUE)


def calculate_features(st: OSCEFeatureState, xq, num_bits, pred_coef_q12,
                       pitch_lags, ltp_coef_q14, gains_q16, signal_type,
                       lpc_order: int, nb_subframes: int = 4):
    """(reference: osce_calculate_features osce_features.c:368).  Per lane:
    xq [B, 80 * nb_subframes] int16 values, num_bits [B], pred_coef_q12
    [B, 2, >= lpc_order], pitch_lags [B, nb_subframes], ltp_coef_q14 [B,
    5 * nb_subframes], gains_q16 [B, nb_subframes], signal_type [B].
    Returns (state, features [B, n, 93] f32, numbits [B, 2] f32, periods
    [B, n] int64)."""
    b = xq.shape[0]
    dev = xq.device
    num_samples = nb_subframes * SUBFRAME
    hist = OSCE_FEATURES_MAX_HISTORY
    num_bits = num_bits.to(torch.float64)
    numbits_smooth = 0.9 * st.numbits_smooth + 0.1 * num_bits
    numbits = torch.stack([num_bits, numbits_smooth], dim=1) \
        .to(torch.float32)
    buffer = torch.cat([st.signal_history,
                        xq[:, :num_samples].to(torch.float32) / 32768.0],
                       dim=1)
    # the spectra of the even subframes, repeated for the odd ones
    n_even = (nb_subframes + 1) // 2
    spec = calculate_log_spectrum_from_lpc(pred_coef_q12[:, :n_even],
                                           lpc_order)
    starts = [hist + 2 * j * SUBFRAME for j in range(n_even)]
    ceps = calculate_cepstrum(torch.stack(
        [buffer[:, s - 160:s + 160] for s in starts], dim=1))
    pick = torch.arange(nb_subframes, device=dev) // 2
    periods = pitch_postprocessing(pitch_lags[:, :nb_subframes],
                                   signal_type)
    fstart = hist + SUBFRAME * torch.arange(nb_subframes, device=dev)
    acorr = calculate_acorr(buffer, fstart, periods)
    ltp = ltp_coef_q14[:, :5 * nb_subframes].to(torch.float32) \
        .reshape(b, nb_subframes, 5) / 16384.0
    log_gain = torch.log(gains_q16[:, :nb_subframes].to(torch.float64)
                         / 65536.0 + 1e-9).to(torch.float32)
    features = torch.cat([spec[:, pick], ceps[:, pick], acorr, ltp,
                          log_gain[..., None]], dim=2)
    st = OSCEFeatureState(numbits_smooth,
                          buffer[:, num_samples:num_samples + hist])
    return st, features, numbits, periods
