"""Blind bandwidth extension 16 kHz -> 48 kHz over a leading batch of
streams: port of ``opus_tpu/dnn/bbwe.py`` (reference: dnn/osce.c
ENABLE_OSCE_BWE sections, dnn/osce_features.c
osce_bwe_calculate_features; architecture from
dnn/torch/osce/models/bbwe_net.py, template bbwenet_setup).

Per 10 ms frame: 114 features (32 log band magnitudes and 2 x 41
instantaneous-frequency terms) feed a conv + GRU feature net (cond 128,
one vector per 5 ms subframe); the signal net lifts each 80-sample 16 kHz
subframe to 240 samples at 48 kHz through an adaptive conv 1 -> 3
channels, the 2x allpass upsampler, a temporal shaper and the
x sin(log|x|) activation, an adaptive conv 3 -> 3, the 3/2 interpolator,
a second shaper and activation, and an adaptive conv 3 -> 1.  The output
is delayed 21 samples at 48 kHz.

Each stage's state holds only its own inputs, so a frame runs stage-major:
every subframe of one stage in one call (``nndsp``), then the next stage,
which equals the JAX package's subframe-by-subframe loop.  The states are
NamedTuples of [B, ...] tensors, replaced, never written.

Each step follows the dtype numpy computes it in.  The upsampler is a
float64 recursion over samples, the JAX function's operations in its
order; the three allpass sections run as a pipeline, section j on sample
k - j, so that a step is 5 tensor operations on [B, 3, 2, 3] lanes.  The
interpolator's 8-tap dots are float64 sums in a fixed order (numpy's
``np.dot`` sums through BLAS, whose order is its own), rounded to float32
as numpy stores them.  The features' FFT, magnitudes and logs are float64
rounded once.  No TPU kernel lies on this path: the products are
``torch.matmul`` (TF32 off), the DSP plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.device_cache import const
from ..ops.lanes import lane_mask, select_lanes
from . import nndsp
from . import nnet as nn

FEATURE_DIM = 114
COND_DIM = 128
NUM_BANDS = 32
MAX_INSTAFREQ_BIN = 40
HALF_WINDOW = 160
WINDOW = 320
OUTPUT_DELAY = 21
FRAME16 = 80
FRAME32 = 160
FRAME48 = 240
KSIZE = 16                  # 15 padded to 16 by the quantized export
_DB = 0.11512925464970229
GAIN_A = 12 * _DB           # conv gain limits +-12 dB
GAIN_B = 0.0
TDSHAPE1_AVG_POOL = 8
TDSHAPE2_AVG_POOL = 12
TDSHAPE_INTERPOLATE = 2
CHANNELS = 3

# (reference: center_bins_bwe/band_weights_bwe osce_features.c:54-97)
CENTER_BINS_BWE = np.array([0, 5, 10, 15, 20, 25, 30, 35, 40, 45, 50,
                            55, 60, 65, 70, 75, 80, 85, 90, 95, 100,
                            105, 110, 115, 120, 125, 130, 135, 140,
                            145, 150, 160])


def _band_weights(center_bins):
    n = len(center_bins)
    w = np.zeros(n)
    for b in range(n):
        lo = center_bins[b - 1] if b > 0 else center_bins[0]
        hi = center_bins[b + 1] if b < n - 1 else center_bins[-1]
        edge = 1 if b in (0, n - 1) else 0
        w[b] = 2.0 / (hi - lo + edge)
    return w


BAND_WEIGHTS_BWE = _band_weights(CENTER_BINS_BWE)

# polyphase coefficients (reference: dnn/osce.c:956-972)
HQ_2X_EVEN = np.array([0.026641845703125, 0.228668212890625,
                       -0.4036407470703125])
HQ_2X_ODD = np.array([0.104583740234375, 0.3932037353515625,
                      -0.152496337890625])
FRAC_01_24 = np.array([0.00576782, -0.01831055, 0.01882935, 0.9328308,
                       0.09143066, -0.04196167, 0.01296997,
                       -0.00140381])
FRAC_17_24 = np.array([-3.14331055e-03, 2.73437500e-02,
                       -1.06414795e-01, 3.64685059e-01,
                       8.03863525e-01, -1.02233887e-01,
                       1.61437988e-02, -1.22070312e-04])
FRAC_09_24 = np.array([-0.00146484, 0.02313232, -0.12072754, 0.7315979,
                       0.4621277, -0.12075806, 0.0295105, -0.00326538])


def _up2_coefs() -> np.ndarray:
    """[2 phases, 3 sections] float64 multipliers; section 3's is
    1 + c[2], as the JAX function takes it."""
    c = np.stack([HQ_2X_EVEN, HQ_2X_ODD])
    c[:, 2] = 1 + c[:, 2]
    return c


# ---------------------------------------------------------------------
# resampling and activation

class ResampState(NamedTuple):
    upsamp: torch.Tensor       # [B, C, 2, 3] f64 allpass states
    interpol: torch.Tensor     # [B, C, 8] f64 interpolator history


def resamp_init(batch, channels=CHANNELS, *, device) -> ResampState:
    return ResampState(
        torch.zeros((batch, channels, 2, 3), dtype=torch.float64,
                    device=device),
        torch.zeros((batch, channels, 8), dtype=torch.float64,
                    device=device))


def upsamp_2x(state: ResampState, x):
    """SILK-style HQ 2x upsampler, three cascaded allpass sections per
    phase (reference: upsamp_2x dnn/osce.c:1042).  x [B, C, N] -> (state,
    [B, C, 2N] f32, the float64 result rounded once).

    Step k runs section j on sample k - j of both phases at once: with t
    each section's input and s its state, y = t - s, v = y c, the output
    s + v and the new state t + v, the JAX function's float64 operations
    on the same operands.  The first two and the last two steps keep the
    sections that have no sample yet (or no more) as they were."""
    b, ch, n = x.shape
    dev = x.device
    c = const(("bbwe_up2",), _up2_coefs, dev)
    xs = x.to(torch.float64)[..., None, None].expand(b, ch, n, 2, 1)
    pad = torch.zeros((b, ch, 2, 1), dtype=torch.float64, device=dev)
    s = state.upsamp
    nxt = torch.zeros_like(s)           # each section's last output
    outs = []
    for k in range(n + 2):
        t = torch.cat([xs[:, :, k] if k < n else pad, nxt[..., :2]], dim=3)
        v = (t - s) * c
        nxt = s + v
        s_new = t + v
        lo, hi = max(0, k - n + 1), min(3, k + 1)
        if lo > 0 or hi < 3:
            keep = torch.zeros(3, dtype=torch.bool, device=dev)
            keep[lo:hi] = True
            s_new = torch.where(keep, s_new, s)
        s = s_new
        if k >= 2:
            outs.append(nxt)
    out = torch.stack(outs, dim=2)[..., 2]             # [B, C, N, 2]
    return state._replace(upsamp=s), \
        out.reshape(b, ch, 2 * n).to(torch.float32)


def interpol_3_2(state: ResampState, x):
    """3/2 fractional interpolation, 8-tap FIR (reference: interpol_3_2
    dnn/osce.c:995).  x [B, C, N] (N even) -> (state, [B, C, 3N/2] f32).
    Each output is a float64 sum over its 8 taps in tap order, rounded
    once to float32."""
    b, ch, n = x.shape
    taps = const(("bbwe_interp",), lambda: np.stack(
        [FRAC_01_24, FRAC_17_24, FRAC_09_24]), x.device)
    buf = torch.cat([state.interpol, x.to(torch.float64)], dim=2)
    win = buf.unfold(2, 9, 2)[:, :, :n // 2]          # [B, C, N/2, 9]
    prod = torch.stack([win[..., :8], win[..., :8], win[..., 1:]],
                       dim=3) * taps                  # [B, C, N/2, 3, 8]
    out = prod[..., 0]
    for j in range(1, 8):
        out = out + prod[..., j]
    new = state._replace(interpol=buf[:, :, n:n + 8])
    return new, out.reshape(b, ch, 3 * n // 2).to(torch.float32)


def valin_activation(x) -> torch.Tensor:
    """x sin(log(|x| + 1e-6)) in float64, rounded to float32
    ("ImPowI"; reference: apply_valin_activation dnn/osce.c:974)."""
    x = x.to(torch.float64)
    return (x * torch.sin(torch.log(x.abs() + 1e-6))).to(torch.float32)


# ---------------------------------------------------------------------
# features

class BBWEFeatureState(NamedTuple):
    signal_history: torch.Tensor   # [B, 160] f32
    last_spec: torch.Tensor        # [B, 82] f64, (re + 1e-9, im) pairs


def bwe_feature_init(batch, *, device) -> BBWEFeatureState:
    return BBWEFeatureState(
        torch.zeros((batch, HALF_WINDOW), device=device),
        torch.zeros((batch, 2 * MAX_INSTAFREQ_BIN + 2), dtype=torch.float64,
                    device=device))


# half-sine analysis window in float64, as the JAX module keeps it
# (osce_features.c:116)
_WINDOW64 = np.sin((np.arange(WINDOW) + 0.5) * np.pi / WINDOW)


def _band_fracs() -> np.ndarray:
    """[2, 31, 10] the JAX function's frac and 1 - frac per band and bin
    (bands 0-29 span 5 bins, band 30 spans 10; zero padded)."""
    out = np.zeros((2, NUM_BANDS - 1, 10))
    for b in range(NUM_BANDS - 1):
        i = np.arange(CENTER_BINS_BWE[b], CENTER_BINS_BWE[b + 1])
        frac = (CENTER_BINS_BWE[b + 1] - i) \
            / (CENTER_BINS_BWE[b + 1] - CENTER_BINS_BWE[b])
        out[0, b, :len(i)] = frac
        out[1, b, :len(i)] = 1 - frac
    return out


def _band_energies(mag) -> torch.Tensor:
    """The 32 weighted band magnitudes of mag [B, 161] float64, each sum
    in numpy's order: a band's 5 terms in a row, band 30's 10 through
    numpy's pairwise block; band b adds band b-1's upper share first."""
    dev = mag.device
    fr = const(("bbwe_fracs",), _band_fracs, dev)
    w = const(("bbwe_band_w",), lambda: BAND_WEIGHTS_BWE.copy(), dev)
    m5 = mag[:, :150].reshape(-1, 30, 5)
    lo5 = nndsp.np_sum(fr[0, :30, :5] * m5)
    hi5 = nndsp.np_sum(fr[1, :30, :5] * m5)
    lo10 = nndsp.np_sum(fr[0, 30] * mag[:, 150:160])
    hi10 = nndsp.np_sum(fr[1, 30] * mag[:, 150:160])
    lo = torch.cat([lo5, lo10[:, None]], dim=1)         # [B, 31]
    hi = torch.cat([hi5, hi10[:, None]], dim=1)
    # bands[b] = w[b] hi[b-1] + w[b] lo[b] (0 + x is x); band 31 ends on
    # mag[160]
    first = torch.cat([torch.zeros_like(mag[:, :1]), w[1:] * hi], dim=1)
    second = torch.cat([w[:-1] * lo, w[-1:] * mag[:, 160:161]], dim=1)
    return first + second


def bwe_calculate_features(st: BBWEFeatureState, xq):
    """(reference: osce_bwe_calculate_features osce_features.c:462).
    xq [B, k * 160] int16 values -> (state, features [B, k, 114] f32)."""
    b = xq.shape[0]
    n_frames = xq.shape[1] // HALF_WINDOW
    dev = xq.device
    win = const(("bbwe_window",), lambda: _WINDOW64, dev)
    x_all = xq.to(torch.float32) / 32768.0
    hist, last = st.signal_history, st.last_spec
    nb = MAX_INSTAFREQ_BIN + 1
    feats = []
    for f in range(n_frames):
        x = x_all[:, f * HALF_WINDOW:(f + 1) * HALF_WINDOW]
        buf = torch.cat([hist, x], dim=1).to(torch.float64)
        hist = x
        spec_c = torch.fft.fft(buf * win)[:, :WINDOW // 2 + 1]
        re1 = spec_c.real[:, :nb] + 1e-9
        im1 = spec_c.imag[:, :nb]
        re2, im2 = last[:, 0::2], last[:, 1::2]
        aux_r = re1 * re2 + im1 * im2
        aux_i = im1 * re2 - re1 * im2
        aux_abs = torch.sqrt(aux_r * aux_r + aux_i * aux_i)
        bands = _band_energies(spec_c.abs())
        feats.append(torch.cat([torch.log(bands + 1e-9),
                                aux_r / (aux_abs + 1e-9),
                                aux_i / (aux_abs + 1e-9)], dim=1)
                     .to(torch.float32))
        last = torch.stack([re1, im1], dim=2).reshape(b, 2 * nb)
    return BBWEFeatureState(hist, last), torch.stack(feats, dim=1)


# ---------------------------------------------------------------------
# model, state and feature net

class BBWEModel(NamedTuple):
    fnet_conv1: nn.Linear          # 342 -> 128 (k=3), tanh
    fnet_conv2: nn.Linear          # 384 -> 128 (k=3), tanh
    fnet_tconv: nn.Linear          # 128 -> 256 (2x upsample), tanh
    fnet_gru_input: nn.Linear      # 128 -> 384
    fnet_gru_recurrent: nn.Linear  # 128 -> 384
    af1: tuple                     # (kernel 128->48, gain 128->3)
    af2: tuple                     # (kernel 128->144, gain 128->3)
    af3: tuple                     # (kernel 128->48, gain 128->1)
    tdshape1: tuple                # alpha1f 256->80, alpha1t 42->80,
    tdshape2: tuple                # alpha2 160->80 (frame 240: ->120)


class BBWEState(NamedTuple):
    fnet_conv1_mem: torch.Tensor   # [B, 2 * 114]
    fnet_conv2_mem: torch.Tensor   # [B, 2 * 128]
    fnet_gru: torch.Tensor         # [B, 128]
    af1: nndsp.AdaConvState
    af2: nndsp.AdaConvState
    af3: nndsp.AdaConvState
    tdshape1: nndsp.AdaShapeState
    tdshape2: nndsp.AdaShapeState
    resamp: ResampState            # [B, 3, ...]
    out_buffer: torch.Tensor       # [B, 21] int64, int16 values


def init_state(batch, *, device) -> BBWEState:
    return BBWEState(
        torch.zeros((batch, 2 * FEATURE_DIM), device=device),
        torch.zeros((batch, 2 * COND_DIM), device=device),
        torch.zeros((batch, COND_DIM), device=device),
        nndsp.adaconv_init(batch, 1, 3, KSIZE, device=device),
        nndsp.adaconv_init(batch, 3, 3, KSIZE, device=device),
        nndsp.adaconv_init(batch, 3, 1, KSIZE, device=device),
        nndsp.adashape_init(batch, COND_DIM, FRAME32, TDSHAPE1_AVG_POOL,
                            TDSHAPE_INTERPOLATE, device=device),
        nndsp.adashape_init(batch, COND_DIM, FRAME48, TDSHAPE2_AVG_POOL,
                            TDSHAPE_INTERPOLATE, device=device),
        resamp_init(batch, device=device),
        torch.zeros((batch, OUTPUT_DELAY), dtype=torch.int64, device=device))


def feature_net(model: BBWEModel, state: BBWEState, features):
    """(reference: bbwe_feature_net dnn/osce.c:855).  features [B, n, 114]
    -> (state, cond [B, 2n, 128]).  The two k=3 convs take all n frames in
    one product each; the GRU steps twice a frame, in order."""
    b, n = features.shape[:2]
    c1, c1_mem = nndsp.conv1d_seq(model.fnet_conv1, state.fnet_conv1_mem,
                                  features, nn.ACTIVATION_TANH)
    c2, c2_mem = nndsp.conv1d_seq(model.fnet_conv2, state.fnet_conv2_mem,
                                  c1, nn.ACTIVATION_TANH)
    up = nn.dense(model.fnet_tconv, c2, nn.ACTIVATION_TANH) \
        .reshape(b, 2 * n, COND_DIM)
    gru = state.fnet_gru
    cond = []
    for k in range(2 * n):
        gru = nn.gru(model.fnet_gru_input, model.fnet_gru_recurrent, gru,
                     up[:, k])
        cond.append(gru)
    return state._replace(fnet_conv1_mem=c1_mem, fnet_conv2_mem=c2_mem,
                          fnet_gru=gru), torch.stack(cond, dim=1)


def _adaconv(state, layer, x, cond, frame, in_ch, out_ch):
    return nndsp.adaconv_process_frame(
        state, x, cond, layer[0], layer[1], frame, frame // 2, in_ch,
        out_ch, KSIZE, KSIZE - 1, GAIN_A, GAIN_B)


def _shape_valin(state, layer, x, cond, frame, pool):
    """Channel 2 through the shaper, channel 3 through the activation."""
    state, shaped = nndsp.adashape_process_frame(
        state, x[:, 1], cond, layer[0], layer[1], layer[2], frame, pool,
        TDSHAPE_INTERPOLATE)
    return state, torch.stack([x[:, 0], shaped, valin_activation(x[:, 2])],
                              dim=1)


def signal_net(model: BBWEModel, state: BBWEState, x_in, cond):
    """The signal path of BBWE.process, stage-major: x_in [B, n * 80] f32
    at 16 kHz, cond [B, n, 128] -> (state, [B, n * 240] f32 at 48 kHz)."""
    s = state
    af1, y = _adaconv(s.af1, model.af1, x_in[:, None], cond, FRAME16, 1, 3)
    rs, y = upsamp_2x(s.resamp, y)
    td1, y = _shape_valin(s.tdshape1, model.tdshape1, y, cond, FRAME32,
                          TDSHAPE1_AVG_POOL)
    af2, y = _adaconv(s.af2, model.af2, y, cond, FRAME32, 3, 3)
    rs, y = interpol_3_2(rs, y)
    td2, y = _shape_valin(s.tdshape2, model.tdshape2, y, cond, FRAME48,
                          TDSHAPE2_AVG_POOL)
    af3, y = _adaconv(s.af3, model.af3, y, cond, FRAME48, 3, 1)
    return s._replace(af1=af1, af2=af2, af3=af3, tdshape1=td1,
                      tdshape2=td2, resamp=rs), y[:, 0]


class BBWE:
    """The bandwidth extender of ``batch`` streams (reference: osce_bwe in
    dnn/osce.c, hooked in silk/dec_API.c:267): features, nets and the
    output delay.  ``process`` takes [B] lanes of 160 or 320 int16
    samples at 16 kHz and gives 3x as many at 48 kHz; ``peak`` keeps each
    lane's largest |float output| of the last frame (before clipping).
    All lanes advance together; a lane's state is its own, and ``reset``
    takes a lane mask."""

    def __init__(self, model: BBWEModel, batch: int, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BBWE: no CUDA device (pass device='cpu' "
                               "for the CPU)")
        self.model = model
        self.batch = batch
        self.peak = None
        self.reset()

    def reset(self, lanes=None):
        """The lanes of ``lanes`` ([B] bool, default every lane) back to the
        initial state: features, feature net, filter and resampler
        histories and the output delay line; the other lanes keep theirs
        bit for bit."""
        fresh = (init_state(self.batch, device=self.device),
                 bwe_feature_init(self.batch, device=self.device))
        if lanes is not None:
            fresh = select_lanes(lane_mask(lanes, self.batch, self.device),
                                 fresh, (self.state, self.feat_state))
        self.state, self.feat_state = fresh

    def process(self, xq16):
        """xq16 [B, 160 or 320] int16 values -> [B, 480 or 960] int64,
        int16 values."""
        n16 = xq16.shape[1]
        if n16 not in (160, 320):
            raise ValueError(f"BBWE: {n16} samples a frame (160 or 320)")
        self.feat_state, feats = bwe_calculate_features(self.feat_state,
                                                        xq16)
        self.state, cond = feature_net(self.model, self.state, feats)
        x_in = xq16.to(torch.float32) / 32768.0
        self.state, out48 = signal_net(self.model, self.state, x_in, cond)
        self.peak = out48.abs().amax(dim=1)
        q = torch.floor(0.5 + torch.clamp(32768.0 * out48, -32767.0,
                                          32767.0)).to(torch.int64)
        out = torch.cat([self.state.out_buffer, q[:, :-OUTPUT_DELAY]], dim=1)
        self.state = self.state._replace(out_buffer=q[:, -OUTPUT_DELAY:])
        return out


def random_model(seed=0, *, device="cuda") -> BBWEModel:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_model(seed)``, on ``device``."""
    rng = np.random.default_rng(seed)

    def rl(m, n, bias=True):
        w = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias \
            else None
        return nn.np_linear(w, b, device=device)

    def shape(frame, pool):
        hidden = frame // TDSHAPE_INTERPOLATE
        tenv = frame // pool
        return (rl(2 * COND_DIM, hidden, bias=False),
                rl(2 * (tenv + 1), hidden, bias=False),
                rl(2 * hidden, hidden, bias=False))

    return BBWEModel(
        fnet_conv1=rl(3 * FEATURE_DIM, COND_DIM),
        fnet_conv2=rl(3 * COND_DIM, COND_DIM),
        fnet_tconv=rl(COND_DIM, 2 * COND_DIM),
        fnet_gru_input=rl(COND_DIM, 3 * COND_DIM),
        fnet_gru_recurrent=rl(COND_DIM, 3 * COND_DIM),
        af1=(rl(COND_DIM, 3 * KSIZE), rl(COND_DIM, 3)),
        af2=(rl(COND_DIM, 9 * KSIZE), rl(COND_DIM, 3)),
        af3=(rl(COND_DIM, 3 * KSIZE), rl(COND_DIM, 1)),
        tdshape1=shape(FRAME32, TDSHAPE1_AVG_POOL),
        tdshape2=shape(FRAME48, TDSHAPE2_AVG_POOL))
