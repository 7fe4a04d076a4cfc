"""OSCE speech enhancement, LACE and NoLACE, over a leading batch of
streams: port of ``opus_tpu/dnn/osce.py`` (reference: dnn/osce.c;
architecture from dnn/torch/osce/models/lace.py and no_lace.py).

Both enhance the 16 kHz SILK decoder's output per 20 ms frame (4 x 80
subframes), conditioned on the 93 OSCE features per subframe, a pitch
embedding and a bit-count embedding.  LACE: the feature net, 2 adaptive
comb stages, an adaptive conv.  NoLACE adds feature transforms between
the stages and a 2-channel pipeline of 3 temporal shapers and 4 adaptive
convs.

The models are NamedTuples of the port's ``nnet.Linear`` layers; the
states NamedTuples of [B, ...] tensors, replaced, never written.  Each
filter stage runs its 4 subframes as one batched call (``nndsp``): its
history holds the stage's own inputs, known for the whole frame.  The
feature net's GRU, the ``post_*`` convs and the stage order stay
sequential.  The products are ``torch.matmul`` (TF32 off), as the JAX
package leaves its ``x @ w`` to XLA; the de-emphasis is kernel K2 on the
card (``ops/iir.deemphasis``) and its plain Toeplitz version on the CPU.
Python floats stay weak as under NumPy 2: the preemphasis is float32,
the numbits embedding's log float64 and its sine float32 (taken in
float64 and rounded once).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.device_cache import const
from ..ops.iir import deemphasis
from ..ops.lanes import lane_mask, select_lanes
from . import nndsp
from . import nnet as nn
from . import osce_features as OF
from .weights import WEIGHT_TYPE_FLOAT, WeightArray, linear_to_arrays

# Deployed model hyperparameters (dnn/torch/osce/utils/templates.py
# lace_setup / nolace_setup).
NUM_FEATURES = 93
PITCH_MAX = 300
PITCH_EMBEDDING_DIM = 64
NUMBITS_EMBEDDING_DIM = 8
LACE_COND_DIM = 128
NOLACE_COND_DIM = 256
HIDDEN_FEATURE_DIM = 96
FRAME_SIZE = 80          # 5 ms subframe at 16 kHz
NB_SUBFRAMES = 4
OVERLAP_SIZE = 40
KERNEL_SIZE = 16         # 15 padded to 16 by the quantized export
COMB_LEFT_PADDING = 8
CONV_LEFT_PADDING = KERNEL_SIZE - 1
PREEMPH = 0.85
_DB = 0.11512925464970229
COMB_GAIN_A = 6 * _DB            # global comb gain +-6 dB
COMB_GAIN_B = 0.0
CONV_GAIN_A = 12 * _DB           # adaptive conv gains +-12 dB
CONV_GAIN_B = 0.0
LOG_GAIN_LIMIT = 10 * _DB        # comb per-tap gain limit +10 dB
NUMBITS_RANGE = (50.0, 650.0)
TDSHAPE_AVG_POOL_K = 4
_FNET_IN = NUM_FEATURES + PITCH_EMBEDDING_DIM \
    + 2 * NUMBITS_EMBEDDING_DIM                       # 173

OSCE_METHOD_NONE = 0
OSCE_METHOD_LACE = 1
OSCE_METHOD_NOLACE = 2


def numbits_embedding(numbits, scales) -> torch.Tensor:
    """ScaleEmbedding (reference: compute_lace_numbits_embedding
    dnn/osce.c:122).  numbits [...] f32 -> [..., 8] f32."""
    lo, hi = math.log(NUMBITS_RANGE[0]), math.log(NUMBITS_RANGE[1])
    x = torch.log(numbits.to(torch.float64).clamp_min(1e-9)) \
        .clamp(lo, hi) - (hi + lo) / 2
    arg = x.to(torch.float32)[..., None] * scales - 0.5
    return torch.sin(arg.to(torch.float64)).to(torch.float32)


def default_numbits_scales() -> np.ndarray:
    """Init values of the trainable scales
    (dnn/torch/osce/models/scale_embedding.py:61)."""
    lo, hi = math.log(NUMBITS_RANGE[0]), math.log(NUMBITS_RANGE[1])
    return (np.arange(1, NUMBITS_EMBEDDING_DIM + 1) * np.pi
            / (hi - lo)).astype(np.float32)


class FeatureNet(NamedTuple):
    """SilkFeatureNetPL (dnn/torch/osce/models/silk_feature_net_pl.py)"""
    conv1: nn.Linear           # 173 -> 96, tanh (k=1)
    conv2: nn.Linear           # 768 -> cond, tanh (k=2)
    tconv: nn.Linear           # cond -> 4 * cond, tanh (4x upsample)
    gru_input: nn.Linear       # cond -> 3 * cond
    gru_recurrent: nn.Linear   # cond -> 3 * cond


class AdaConvLayer(NamedTuple):
    kernel: nn.Linear
    gain: nn.Linear


class AdaCombLayer(NamedTuple):
    kernel: nn.Linear
    gain: nn.Linear
    global_gain: nn.Linear


class AdaShapeLayer(NamedTuple):
    alpha1f: nn.Linear
    alpha1t: nn.Linear
    alpha2: nn.Linear


class LACEModel(NamedTuple):
    pitch_embedding: torch.Tensor  # [301, 64]
    numbits_scales: torch.Tensor   # [8]
    fnet: FeatureNet
    cf1: AdaCombLayer
    cf2: AdaCombLayer
    af1: AdaConvLayer


class NoLACEModel(NamedTuple):
    pitch_embedding: torch.Tensor
    numbits_scales: torch.Tensor
    fnet: FeatureNet
    cf1: AdaCombLayer
    cf2: AdaCombLayer
    af1: AdaConvLayer              # 1 -> 2 channels
    af2: AdaConvLayer              # 2 -> 2
    af3: AdaConvLayer              # 2 -> 2
    af4: AdaConvLayer              # 2 -> 1
    tdshape1: AdaShapeLayer
    tdshape2: AdaShapeLayer
    tdshape3: AdaShapeLayer
    post_cf1: nn.Linear            # 2 * cond -> cond (k=2 conv), tanh
    post_cf2: nn.Linear
    post_af1: nn.Linear
    post_af2: nn.Linear
    post_af3: nn.Linear


class FeatureNetState(NamedTuple):
    conv2_mem: torch.Tensor        # [B, 4 * hidden]
    gru: torch.Tensor              # [B, cond]


class LACEState(NamedTuple):
    fnet: FeatureNetState
    cf1: nndsp.AdaCombState
    cf2: nndsp.AdaCombState
    af1: nndsp.AdaConvState
    preemph_mem: torch.Tensor      # [B] f32
    deemph_mem: torch.Tensor       # [B] f32


class NoLACEState(NamedTuple):
    fnet: FeatureNetState
    cf1: nndsp.AdaCombState
    cf2: nndsp.AdaCombState
    af1: nndsp.AdaConvState
    af2: nndsp.AdaConvState
    af3: nndsp.AdaConvState
    af4: nndsp.AdaConvState
    tdshape1: nndsp.AdaShapeState
    tdshape2: nndsp.AdaShapeState
    tdshape3: nndsp.AdaShapeState
    post_cf1_mem: torch.Tensor
    post_cf2_mem: torch.Tensor
    post_af1_mem: torch.Tensor
    post_af2_mem: torch.Tensor
    post_af3_mem: torch.Tensor
    preemph_mem: torch.Tensor
    deemph_mem: torch.Tensor


def _zeros(batch, *shape, device):
    return torch.zeros((batch,) + shape, device=device)


def _fnet_init(batch, cond, device) -> FeatureNetState:
    return FeatureNetState(_zeros(batch, 4 * HIDDEN_FEATURE_DIM,
                                  device=device),
                           _zeros(batch, cond, device=device))


def lace_init_state(batch: int, *, device) -> LACEState:
    return LACEState(
        _fnet_init(batch, LACE_COND_DIM, device),
        nndsp.adacomb_init(batch, KERNEL_SIZE, device=device),
        nndsp.adacomb_init(batch, KERNEL_SIZE, device=device),
        nndsp.adaconv_init(batch, 1, 1, KERNEL_SIZE, device=device),
        _zeros(batch, device=device), _zeros(batch, device=device))


def nolace_init_state(batch: int, *, device) -> NoLACEState:
    def shape():
        return nndsp.adashape_init(batch, NOLACE_COND_DIM, FRAME_SIZE,
                                   TDSHAPE_AVG_POOL_K, device=device)

    def conv(i, o):
        return nndsp.adaconv_init(batch, i, o, KERNEL_SIZE, device=device)

    def z():
        return _zeros(batch, NOLACE_COND_DIM, device=device)
    return NoLACEState(
        _fnet_init(batch, NOLACE_COND_DIM, device),
        nndsp.adacomb_init(batch, KERNEL_SIZE, device=device),
        nndsp.adacomb_init(batch, KERNEL_SIZE, device=device),
        conv(1, 2), conv(2, 2), conv(2, 2), conv(2, 1),
        shape(), shape(), shape(), z(), z(), z(), z(), z(),
        _zeros(batch, device=device), _zeros(batch, device=device))


def feature_net(model, state: FeatureNetState, features, numbits, periods):
    """Conditioning vectors, one per 5 ms subframe (reference:
    lace_feature_net dnn/osce.c:163).  features [B, 4, 93] f32, numbits
    [B, 2] f32 (current, smoothed), periods [B, 4] int.  Returns (state,
    cond [B, 4, cond_dim])."""
    fn: FeatureNet = model.fnet
    b = features.shape[0]
    nb_emb = numbits_embedding(numbits, model.numbits_scales).reshape(b, -1)
    emb = model.pitch_embedding[periods.to(torch.int64).clamp(0, PITCH_MAX)]
    rows = torch.cat([features.to(torch.float32), emb,
                      nb_emb[:, None].expand(b, NB_SUBFRAMES, -1)], dim=2)
    hidden = nn.dense(fn.conv1, rows, nn.ACTIVATION_TANH)
    c2, conv2_mem = nn.conv1d(fn.conv2, state.conv2_mem,
                              hidden.reshape(b, -1), nn.ACTIVATION_TANH)
    cond_dim = state.gru.shape[-1]
    up = nn.dense(fn.tconv, c2, nn.ACTIVATION_TANH)
    gru = state.gru
    cond = []
    for sf in range(NB_SUBFRAMES):
        gru = nn.gru(fn.gru_input, fn.gru_recurrent, gru,
                     up[:, sf * cond_dim:(sf + 1) * cond_dim])
        cond.append(gru)
    return FeatureNetState(conv2_mem, gru), torch.stack(cond, dim=1)


def _preemphasis(x_in, mem):
    """x[i] = x_in[i] - 0.85 * x_in[i-1] in float32; x_in[-1] is the
    carried mem (a Python float in numpy: its product is float64)."""
    prev = torch.cat([(PREEMPH * mem.to(torch.float64))
                      .to(torch.float32)[:, None],
                      PREEMPH * x_in[:, :-1]], dim=1)
    return x_in - prev, x_in[:, -1]


def _comb(state, layer: AdaCombLayer, x, cond, periods):
    return nndsp.adacomb_process_frame(
        state, x, cond, layer.kernel, layer.gain, layer.global_gain,
        periods, FRAME_SIZE, OVERLAP_SIZE, KERNEL_SIZE, COMB_LEFT_PADDING,
        COMB_GAIN_A, COMB_GAIN_B, LOG_GAIN_LIMIT)


def _conv(state, layer: AdaConvLayer, x, cond, in_ch, out_ch):
    return nndsp.adaconv_process_frame(
        state, x, cond, layer.kernel, layer.gain, FRAME_SIZE, OVERLAP_SIZE,
        in_ch, out_ch, KERNEL_SIZE, CONV_LEFT_PADDING, CONV_GAIN_A,
        CONV_GAIN_B)


def lace_process_frame(model: LACEModel, state: LACEState, x_in, features,
                       numbits, periods):
    """One 20 ms frame (reference: lace_process_20ms_frame dnn/osce.c:238).
    x_in [B, 320] f32.  Returns (state, x_out [B, 320] f32)."""
    x, pre = _preemphasis(x_in.to(torch.float32), state.preemph_mem)
    fnet, cond = feature_net(model, state.fnet, features, numbits, periods)
    cf1, x = _comb(state.cf1, model.cf1, x, cond, periods)
    cf2, x = _comb(state.cf2, model.cf2, x, cond, periods)
    af1, x = _conv(state.af1, model.af1, x, cond, 1, 1)
    out, de = deemphasis(x[:, 0].contiguous(), state.deemph_mem, PREEMPH)
    return LACEState(fnet, cf1, cf2, af1, pre, de), out


def nolace_process_frame(model: NoLACEModel, state: NoLACEState, x_in,
                         features, numbits, periods):
    """One 20 ms frame (reference: nolace_process_20ms_frame
    dnn/osce.c:509).  x_in [B, 320] f32.  Returns (state, x_out [B, 320])."""
    s = state
    x1, pre = _preemphasis(x_in.to(torch.float32), s.preemph_mem)
    fnet, cond = feature_net(model, s.fnet, features, numbits, periods)

    def post(layer, mem, c):
        return nndsp.conv1d_seq(layer, mem, c, nn.ACTIVATION_TANH)

    cf1, x1 = _comb(s.cf1, model.cf1, x1, cond, periods)
    cond, post_cf1_mem = post(model.post_cf1, s.post_cf1_mem, cond)
    cf2, x1 = _comb(s.cf2, model.cf2, x1, cond, periods)
    cond, post_cf2_mem = post(model.post_cf2, s.post_cf2_mem, cond)
    af1, x2 = _conv(s.af1, model.af1, x1, cond, 1, 2)
    cond, post_af1_mem = post(model.post_af1, s.post_af1_mem, cond)

    def shape_mix(shape_state, shape_layer: AdaShapeLayer, af_state,
                  af_layer, x_src, out_ch):
        """Shape channel 2 of x_src [B, 2, 320], then mix 2 -> out_ch."""
        shape_state, shaped = nndsp.adashape_process_frame(
            shape_state, x_src[:, 1], cond, shape_layer.alpha1f,
            shape_layer.alpha1t, shape_layer.alpha2, FRAME_SIZE,
            TDSHAPE_AVG_POOL_K)
        x_src = torch.stack([x_src[:, 0], shaped], dim=1)
        af_state, x_dst = _conv(af_state, af_layer, x_src, cond, 2, out_ch)
        return shape_state, af_state, x_dst

    td1, af2, x2 = shape_mix(s.tdshape1, model.tdshape1, s.af2, model.af2,
                             x2, 2)
    cond, post_af2_mem = post(model.post_af2, s.post_af2_mem, cond)
    td2, af3, x2 = shape_mix(s.tdshape2, model.tdshape2, s.af3, model.af3,
                             x2, 2)
    cond, post_af3_mem = post(model.post_af3, s.post_af3_mem, cond)
    td3, af4, x_final = shape_mix(s.tdshape3, model.tdshape3, s.af4,
                                  model.af4, x2, 1)
    out, de = deemphasis(x_final[:, 0].contiguous(), s.deemph_mem, PREEMPH)
    return NoLACEState(fnet, cf1, cf2, af1, af2, af3, af4, td1, td2, td3,
                       post_cf1_mem, post_cf2_mem, post_af1_mem,
                       post_af2_mem, post_af3_mem, pre, de), out


# ---------------------------------------------------------------------
# model construction

class _Rng:
    """The JAX package's random layer builder (osce._rl), its arrays on
    ``device``."""

    def __init__(self, seed, device):
        self.rng = np.random.default_rng(seed)
        self.device = device

    def lin(self, m, n):
        w = (self.rng.standard_normal((m, n)) / np.sqrt(m)) \
            .astype(np.float32)
        b = (self.rng.standard_normal(n) * 0.1).astype(np.float32)
        return nn.np_linear(w, b, device=self.device)

    def emb(self):
        return torch.as_tensor(
            (self.rng.standard_normal((PITCH_MAX + 1, PITCH_EMBEDDING_DIM))
             / 8).astype(np.float32), device=self.device)

    def fnet(self, cond) -> FeatureNet:
        return FeatureNet(self.lin(_FNET_IN, HIDDEN_FEATURE_DIM),
                          self.lin(2 * 4 * HIDDEN_FEATURE_DIM, cond),
                          self.lin(cond, 4 * cond),
                          self.lin(cond, 3 * cond),
                          self.lin(cond, 3 * cond))

    def comb(self, cond) -> AdaCombLayer:
        return AdaCombLayer(self.lin(cond, KERNEL_SIZE), self.lin(cond, 1),
                            self.lin(cond, 1))

    def conv(self, cond, in_ch, out_ch) -> AdaConvLayer:
        return AdaConvLayer(self.lin(cond, in_ch * out_ch * KERNEL_SIZE),
                            self.lin(cond, out_ch))

    def shape(self, cond) -> AdaShapeLayer:
        tenv = FRAME_SIZE // TDSHAPE_AVG_POOL_K
        return AdaShapeLayer(self.lin(2 * cond, FRAME_SIZE),
                             self.lin(2 * (tenv + 1), FRAME_SIZE),
                             self.lin(2 * FRAME_SIZE, FRAME_SIZE))


def _scales(device):
    return torch.as_tensor(default_numbits_scales(), device=device)


def random_lace_model(seed=0, *, device) -> LACEModel:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_lace_model(seed)``."""
    r = _Rng(seed, device)
    c = LACE_COND_DIM
    return LACEModel(r.emb(), _scales(device), r.fnet(c), r.comb(c),
                     r.comb(c), r.conv(c, 1, 1))


def random_nolace_model(seed=0, *, device) -> NoLACEModel:
    """As ``random_lace_model``, for the JAX ``random_nolace_model(seed)``."""
    r = _Rng(seed, device)
    c = NOLACE_COND_DIM
    return NoLACEModel(
        r.emb(), _scales(device), r.fnet(c), r.comb(c), r.comb(c),
        r.conv(c, 1, 2), r.conv(c, 2, 2), r.conv(c, 2, 2), r.conv(c, 2, 1),
        r.shape(c), r.shape(c), r.shape(c),
        r.lin(2 * c, c), r.lin(2 * c, c), r.lin(2 * c, c), r.lin(2 * c, c),
        r.lin(2 * c, c))


def _emb_array(name, t):
    return WeightArray(name, WEIGHT_TYPE_FLOAT,
                       t.detach().cpu().numpy().astype(np.float32)
                       .reshape(-1))


def _common_arrays(model, prefix):
    out = [_emb_array(f"{prefix}_pitch_embedding_weights_float",
                      model.pitch_embedding)]
    for nm in FeatureNet._fields:
        out += linear_to_arrays(f"{prefix}_fnet_{nm}",
                                getattr(model.fnet, nm))
    for nm in ("cf1", "cf2"):
        lay = getattr(model, nm)
        for f in AdaCombLayer._fields:
            out += linear_to_arrays(f"{prefix}_{nm}_{f}", getattr(lay, f))
    return out


def lace_model_to_arrays(model: LACEModel, prefix="lace"):
    """Blob arrays, names per the osce export script
    (dnn/torch/osce/export_model_weights.py)."""
    out = _common_arrays(model, prefix)
    out += linear_to_arrays(f"{prefix}_af1_kernel", model.af1.kernel)
    out += linear_to_arrays(f"{prefix}_af1_gain", model.af1.gain)
    return out


def nolace_model_to_arrays(model: NoLACEModel):
    out = _common_arrays(model, "nolace")
    for nm in ("af1", "af2", "af3", "af4"):
        lay = getattr(model, nm)
        out += linear_to_arrays(f"nolace_{nm}_kernel", lay.kernel)
        out += linear_to_arrays(f"nolace_{nm}_gain", lay.gain)
    for nm in ("tdshape1", "tdshape2", "tdshape3"):
        lay = getattr(model, nm)
        out += linear_to_arrays(f"nolace_{nm}_alpha1_f", lay.alpha1f)
        out += linear_to_arrays(f"nolace_{nm}_alpha1_t", lay.alpha1t)
        out += linear_to_arrays(f"nolace_{nm}_alpha2", lay.alpha2)
    for nm in ("post_cf1", "post_cf2", "post_af1", "post_af2", "post_af3"):
        out += linear_to_arrays(f"nolace_{nm}", getattr(model, nm))
    return out


# ---------------------------------------------------------------------
# decoder-side enhancer

class OSCEEnhancer:
    """The SILK output enhancer of ``batch`` streams (reference:
    osce_enhance_frame dnn/osce.c:1546 + osce_reset :1381).  Enhancement
    applies only to 16 kHz / 4-subframe (20 ms WB) frames: any other frame
    passes through and resets every lane.  After a reset a lane's first
    frame passes through (its state still advances) and its second
    cross-fades over 10 ms; ``reset_count`` is per lane, and ``reset``
    takes a lane mask."""

    def __init__(self, method: int, model, batch: int, *, device):
        if method not in (OSCE_METHOD_LACE, OSCE_METHOD_NOLACE):
            raise ValueError(f"OSCEEnhancer: unknown method {method}")
        self.method = method
        self.model = model
        self.batch = batch
        self.device = torch.device(device)
        # the last enhanced frame's features, numbits and periods
        self.frame_features = None
        self.reset()

    def reset(self, lanes=None):
        """The lanes of ``lanes`` ([B] bool, default every lane) back to the
        initial features, filter and GRU state with ``reset_count`` 2
        (osce_reset dnn/osce.c:1381); the other lanes keep theirs bit for
        bit."""
        b, dev = self.batch, self.device
        fresh = (OF.init_feature_state(b, device=dev),
                 lace_init_state(b, device=dev)
                 if self.method == OSCE_METHOD_LACE
                 else nolace_init_state(b, device=dev),
                 torch.full((b,), 2, dtype=torch.int64, device=dev))
        if lanes is not None:
            fresh = select_lanes(lane_mask(lanes, b, dev), fresh,
                                 (self.features, self.state,
                                  self.reset_count))
        self.features, self.state, self.reset_count = fresh

    def enhance_frame(self, xq, num_bits, pred_coef_q12, pitch_lags,
                      ltp_coef_q14, gains_q16, signal_type, lpc_order: int,
                      fs_khz: int, nb_subfr: int):
        """xq [B, 320] int16 values and the frame's SILK parameters per
        lane (``silk_symbols``'s OSCE inputs) -> the enhanced [B, 320]
        int64."""
        if fs_khz != 16 or nb_subfr != 4:
            self.reset()
            return xq
        self.features, feats, numbits, periods = OF.calculate_features(
            self.features, xq, num_bits, pred_coef_q12, pitch_lags,
            ltp_coef_q14, gains_q16, signal_type, lpc_order)
        self.frame_features = (feats, numbits, periods)
        x_in = xq[:, :320].to(torch.float32) / 32768.0
        process = lace_process_frame if self.method == OSCE_METHOD_LACE \
            else nolace_process_frame
        self.state, out = process(self.model, self.state, x_in, feats,
                                  numbits, periods)
        # 10 ms cross-fade on a lane's second frame after a reset
        # (osce_cross_fade_10ms osce_features.c:545)
        w = const(("osce_fade",), lambda: OF.OSCE_WINDOW[:160].copy(),
                  x_in.device)
        faded = torch.cat([w * out[:, :160] + (1.0 - w) * x_in[:, :160],
                           out[:, 160:]], dim=1)
        rc = self.reset_count[:, None]
        out = torch.where(rc > 1, x_in, torch.where(rc == 1, faded, out))
        self.reset_count = (self.reset_count - 1).clamp_min(0)
        tmp = torch.clamp(32768.0 * out, -32767.0, 32767.0)
        return torch.floor(0.5 + tmp).to(torch.int64)
