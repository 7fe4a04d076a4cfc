"""Deep packet-loss concealment over a leading batch of streams: port of
``opus_tpu/dnn/plc.py`` (reference: dnn/lpcnet_plc.c).

A small feature-prediction GRU (the PLC model, dnn/torch/plc/plc.py:
57 -> 128 -> 2x GRU128 -> 20) runs on [burg cepstra | features | lost
flag] and predicts the next feature frame; FARGAN synthesizes the
concealed waveform.  FEC features (from DRED) enter through a queue and
take precedence over prediction.

``LPCNetPLC`` holds B streams.  ``update`` and ``conceal`` act on all
lanes at once (a server conceals the streams of one lost tick together),
so the counters that follow from that call sequence alone stay host ints,
as in the JAX class: ``analysis_pos``, ``predict_pos``, ``blend`` and
``analysis_gap``.  The FEC queue is per lane (``feed_dred_fec`` adds a row
or a skip per stream): ``fec_read_pos``, ``fec_fill_pos``, ``fec_skip`` and
``loss_count`` are [B] int64 tensors, and the choice between a FEC row and
the prediction is a per-lane selection around one run of the PLC network.
Every tensor of the state is replaced, never written in place, so the two
GRU backups never alias the live state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.device_cache import const
from . import fargan as fg
from . import features as feat
from . import nnet as nn
from . import pitchdnn as pdnn
from .weights import WeightArray, linear_params, linear_to_arrays

NB_FEATURES = 20
NB_BANDS = 18
FRAME_SIZE = 160
CONT_VECTORS = 5
PLC_MAX_FEC = 104
PLC_BUF_SIZE = (CONT_VECTORS + 10) * FRAME_SIZE
PLC_INPUT = 2 * NB_BANDS + NB_FEATURES + 1          # 57
# (reference: att_table dnn/lpcnet_plc.c:134)
_ATT_TABLE = (0, 0, -.2, -.2, -.4, -.4, -.8, -.8, -1.6, -1.6)


class PLCModel(NamedTuple):
    dense_in: nn.Linear            # 57 -> 128, tanh
    gru1_input: nn.Linear          # 128 -> 384
    gru1_recurrent: nn.Linear      # 128 -> 384
    gru2_input: nn.Linear          # 128 -> 384
    gru2_recurrent: nn.Linear      # 128 -> 384
    dense_out: nn.Linear           # 128 -> 20, linear


_NAMES = ("plc_dense_in", "plc_gru1_input", "plc_gru1_recurrent",
          "plc_gru2_input", "plc_gru2_recurrent", "plc_dense_out")
_SHAPES = ((57, 128), (128, 384), (128, 384), (128, 384), (128, 384),
           (128, 20))


def compute_plc_pred(model: PLCModel, net, features):
    """(reference: compute_plc_pred dnn/lpcnet_plc.c:106).  net is
    (gru1_state [B, 128], gru2_state [B, 128]), features [B, 57]; returns
    (new net, prediction [B, 20])."""
    g1, g2 = net
    tmp = nn.dense(model.dense_in, features, nn.ACTIVATION_TANH)
    g1 = nn.gru(model.gru1_input, model.gru1_recurrent, g1, tmp)
    g2 = nn.gru(model.gru2_input, model.gru2_recurrent, g2, g1)
    return (g1, g2), nn.dense(model.dense_out, g2, nn.ACTIVATION_LINEAR)


def random_model(seed=0, *, device) -> PLCModel:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_model(seed)``."""
    r = np.random.default_rng(seed)

    def rl(m, n):
        w = (r.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        b = (r.standard_normal(n) * 0.1).astype(np.float32)
        return nn.np_linear(w, b, device=device)

    return PLCModel(*(rl(m, n) for m, n in _SHAPES))


def model_from_arrays(arrays, *, device) -> PLCModel:
    """From a parsed weight blob (names per dnn/torch/plc/export_plc_weights.py)."""
    return PLCModel(*(linear_params(arrays,
                                    float_weights=f"{name}_weights_float",
                                    bias=f"{name}_bias", nb_inputs=m,
                                    nb_outputs=n, device=device)
                      for name, (m, n) in zip(_NAMES, _SHAPES)))


def model_to_arrays(model: PLCModel) -> list[WeightArray]:
    """The model as blob arrays (the inverse of ``model_from_arrays``)."""
    out = []
    for name, lin in zip(_NAMES, model):
        out.extend(linear_to_arrays(name, lin))
    return out


class LPCNetPLC:
    """Deep-PLC state of B streams on one device (reference: LPCNetPLCState
    dnn/lpcnet_private.h:50, logic dnn/lpcnet_plc.c:72-210).  Each lane
    computes what one JAX ``LPCNetPLC`` computes given the same calls."""

    def __init__(self, plc_model: PLCModel, pitch_model: pdnn.PitchDNNModel,
                 fargan_model: fg.FARGANModel, batch: int, *, device):
        self.device = torch.device(device)
        self.batch = batch
        self.model = nn.to_device(plc_model, self.device)
        self.pitch_model = nn.to_device(pitch_model, self.device)
        self.fargan_model = nn.to_device(fargan_model, self.device)
        self.reset()

    def _zeros(self, *shape, dtype=torch.float32):
        return torch.zeros((self.batch,) + shape, dtype=dtype,
                           device=self.device)

    def _zero_net(self):
        return (self._zeros(128), self._zeros(128))

    def reset(self):
        self.enc = feat.init_state(self.batch, device=self.device)
        self.fargan = fg.init_state(self.batch, device=self.device)
        self.fec = self._zeros(PLC_MAX_FEC, NB_FEATURES)
        self.fec_read_pos = self._zeros(dtype=torch.int64)
        self.fec_fill_pos = self._zeros(dtype=torch.int64)
        self.fec_skip = self._zeros(dtype=torch.int64)
        self.analysis_gap = 1
        self.analysis_pos = PLC_BUF_SIZE
        self.predict_pos = PLC_BUF_SIZE
        self.pcm = self._zeros(PLC_BUF_SIZE)
        self.blend = 0
        self.features = self._zeros(feat.NB_TOTAL_FEATURES)
        self.cont_features = self._zeros(CONT_VECTORS * NB_FEATURES)
        self.loss_count = self._zeros(dtype=torch.int64)
        self.plc_net = self._zero_net()
        self.plc_bak = [self._zero_net(), self._zero_net()]

    # --- FEC queue (lpcnet_plc.c:92-104) ---
    def fec_add(self, features: Optional[torch.Tensor], present=None,
                lanes=None):
        """Queues one FEC row per lane: lanes where ``present`` holds get
        ``features`` [B, >= 20], the others a skip (the reference's
        fec_add(NULL)); ``lanes`` (default all) limits the call to some
        lanes.  ``features=None`` is a skip on every lane it reaches."""
        b = self.batch
        if lanes is None:
            lanes = torch.ones(b, dtype=torch.bool, device=self.device)
        if features is None:
            present = torch.zeros_like(lanes)
        elif present is None:
            present = torch.ones_like(lanes)
        add = lanes & present
        if bool((add & (self.fec_fill_pos >= PLC_MAX_FEC)).any()):
            raise ValueError(f"FEC queue full ({PLC_MAX_FEC} rows)")
        if features is not None:
            slot = torch.arange(PLC_MAX_FEC, device=self.device)[None, :] \
                == self.fec_fill_pos[:, None]
            put = (slot & add[:, None])[:, :, None]
            row = features[:, :NB_FEATURES].to(torch.float32)[:, None, :]
            self.fec = torch.where(put, row, self.fec)
            self.fec_fill_pos = self.fec_fill_pos + add.to(torch.int64)
        self.fec_skip = self.fec_skip + (lanes & ~present).to(torch.int64)

    def fec_clear(self):
        z = self._zeros(dtype=torch.int64)
        self.fec_read_pos = self.fec_fill_pos = self.fec_skip = z

    def _queue_features(self, features):
        self.cont_features = torch.cat(
            [self.cont_features[:, NB_FEATURES:], features[:, :NB_FEATURES]],
            dim=1)

    def _get_fec_or_pred(self):
        """(reference: get_fec_or_pred lpcnet_plc.c:119) for every lane:
        a queued FEC row where there is one and no skip is pending, else
        the network's prediction.  The network runs once either way, on
        [0 | row | -1] or on zeros.  Updates ``self.features[:, :20]``;
        returns the [B] bool of lanes that took a FEC row."""
        use = (self.fec_read_pos != self.fec_fill_pos) & (self.fec_skip == 0)
        pos = torch.clamp(self.fec_read_pos, 0, PLC_MAX_FEC - 1)
        row = torch.gather(self.fec, 1, pos[:, None, None].expand(
            -1, 1, NB_FEATURES))[:, 0]
        plc_in = torch.cat([self._zeros(2 * NB_BANDS), row,
                            torch.full_like(row[:, :1], -1.0)], dim=1)
        plc_in = torch.where(use[:, None], plc_in, torch.zeros_like(plc_in))
        self.plc_net, pred = compute_plc_pred(self.model, self.plc_net,
                                              plc_in)
        self.features = torch.cat(
            [torch.where(use[:, None], row, pred),
             self.features[:, NB_FEATURES:]], dim=1)
        self.fec_read_pos = self.fec_read_pos + use.to(torch.int64)
        self.fec_skip = torch.where(~use & (self.fec_skip > 0),
                                    self.fec_skip - 1, self.fec_skip)
        return use

    def _rotate_bak(self):
        self.plc_bak = [self.plc_bak[1], self.plc_net]

    def update(self, pcm):
        """Good frame received on every lane (reference: lpcnet_plc_update
        lpcnet_plc.c:144).  pcm: int16 [B, 160]."""
        if self.analysis_pos - FRAME_SIZE >= 0:
            self.analysis_pos -= FRAME_SIZE
        else:
            self.analysis_gap = 1
        if self.predict_pos - FRAME_SIZE >= 0:
            self.predict_pos -= FRAME_SIZE
        pcm = torch.as_tensor(pcm, device=self.device).to(torch.float32)
        self.pcm = torch.cat([self.pcm[:, FRAME_SIZE:], pcm / 32768.0],
                             dim=1)
        self.loss_count = self._zeros(dtype=torch.int64)
        self.blend = 0

    def _catch_up(self):
        """The analysis of the good frames not yet analysed, and the two
        extra predictions that prime FARGAN (lpcnet_plc.c:166-199)."""
        self.plc_net = self.plc_bak[0]
        starts, pred = [], []
        pos, count = self.analysis_pos, 0
        while pos + FRAME_SIZE <= PLC_BUF_SIZE:
            starts.append(pos)
            pred.append((not self.analysis_gap or count > 0)
                        and pos >= self.predict_pos)
            pos += FRAME_SIZE
            count += 1
        # the Burg cepstra depend on the PCM buffer alone: one batch for
        # every frame that feeds the network
        frames = [32768.0 * self.pcm[:, p:p + FRAME_SIZE] for p in starts]
        used = [f for f, p in zip(frames, pred) if p]
        burg = feat.burg_cepstral_analysis(torch.cat(used, dim=0)) \
            .to(torch.float32).split(self.batch) if used else []
        k = 0
        for x, p in zip(frames, pred):
            self.enc, self.features = feat.compute_frame_features(
                self.enc, x, self.pitch_model)
            if p:
                self._queue_features(self.features)
                plc_in = torch.cat([burg[k], self.features[:, :NB_FEATURES],
                                    torch.ones_like(burg[k][:, :1])], dim=1)
                k += 1
                self._rotate_bak()
                self.plc_net, out = compute_plc_pred(self.model,
                                                     self.plc_net, plc_in)
                self.features = torch.cat(
                    [out, self.features[:, NB_FEATURES:]], dim=1)
        self.analysis_pos = pos
        for _ in range(2):
            self._rotate_bak()
            self._get_fec_or_pred()
            self._queue_features(self.features)
        self.fargan = fg.cont(
            self.fargan_model, self.fargan,
            self.pcm[:, PLC_BUF_SIZE - fg.FARGAN_CONT_SAMPLES:],
            self.cont_features.reshape(self.batch, CONT_VECTORS,
                                       NB_FEATURES))
        self.analysis_gap = 0

    def conceal(self) -> torch.Tensor:
        """One lost 10 ms frame on every lane (reference:
        lpcnet_plc_conceal lpcnet_plc.c:157).  Returns int16 [B, 160]."""
        if self.blend == 0:
            self._catch_up()
        self._rotate_bak()
        used = self._get_fec_or_pred()
        lc = torch.where(used, torch.zeros_like(self.loss_count),
                         self.loss_count + 1)
        self.loss_count = lc
        att = const("plc_att_table",
                    lambda: np.asarray(_ATT_TABLE, np.float32), self.device)
        f0 = self.features[:, 0]
        long_loss = (f0 + att[9]) - (2 * (lc - 9)).to(torch.float32)
        short_loss = f0 + att[torch.clamp(lc, max=9)]
        f0 = torch.clamp_min(torch.where(lc >= 10, long_loss, short_loss),
                             -15.0)
        self.features = torch.cat([f0[:, None], self.features[:, 1:]], dim=1)
        self.fargan, out = fg.synthesize_frame(
            self.fargan_model, self.fargan, self.features[:, :NB_FEATURES])
        pcm_out = torch.floor(0.5 + torch.clamp(
            32768.0 * out.to(torch.float64), -32767, 32767)) \
            .to(torch.int16)
        self._queue_features(self.features)
        if self.analysis_pos - FRAME_SIZE >= 0:
            self.analysis_pos -= FRAME_SIZE
        else:
            self.analysis_gap = 1
        self.predict_pos = PLC_BUF_SIZE
        self.pcm = torch.cat([self.pcm[:, FRAME_SIZE:],
                              pcm_out.to(torch.float32) / 32768.0], dim=1)
        self.blend = 1
        return pcm_out
