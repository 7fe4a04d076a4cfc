"""Deep packet-loss concealment over a leading batch of streams: port of
``opus_tpu/dnn/plc.py`` (reference: dnn/lpcnet_plc.c).

A small feature-prediction GRU (the PLC model, dnn/torch/plc/plc.py:
57 -> 128 -> 2x GRU128 -> 20) runs on [burg cepstra | features | lost
flag] and predicts the next feature frame; FARGAN synthesizes the
concealed waveform.  FEC features (from DRED) enter through a queue and
take precedence over prediction.

``LPCNetPLC`` holds B streams, each with its own loss pattern: ``update``,
``conceal`` and ``reset`` take a [B] bool mask of the lanes they act on,
and every counter of the state is a [B] int64 tensor (``analysis_pos``,
``predict_pos``, ``blend``, ``analysis_gap``, the FEC queue's positions and
``loss_count``).  The catch-up before a lane's first concealed frame
analyses that lane's own good frames from its own ``analysis_pos``, under
per-lane masks; the choice between a FEC row and the prediction is a
per-lane selection around one run of the PLC network.  Every tensor of the
state is replaced, never written in place, so the two GRU backups never
alias the live state and a shallow copy is a snapshot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.device_cache import const
from ..ops.lanes import lane_mask, select_lanes
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
    computes what one JAX ``LPCNetPLC`` computes given the same calls:
    ``update``, ``conceal``, ``reset``, ``fec_add`` and ``fec_clear`` take a
    [B] bool mask of the lanes they act on (default every lane), and a lane
    outside it keeps every tensor of its state bit for bit.  The network,
    the feature analysis and FARGAN run over all B lanes; their results are
    selected per lane."""

    def __init__(self, plc_model: PLCModel, pitch_model: pdnn.PitchDNNModel,
                 fargan_model: fg.FARGANModel, batch: int, *, device):
        self.device = torch.device(device)
        self.batch = batch
        self.model = nn.to_device(plc_model, self.device)
        self.pitch_model = nn.to_device(pitch_model, self.device)
        self.fargan_model = nn.to_device(fargan_model, self.device)
        self._set(self._fresh())
        # the last conceal's lanes that took a FEC row instead of the
        # prediction
        self.fec_used = None

    def _zeros(self, *shape, dtype=torch.float32):
        return torch.zeros((self.batch,) + shape, dtype=dtype,
                           device=self.device)

    def _zero_net(self):
        return (self._zeros(128), self._zeros(128))

    def _full(self, value):
        return torch.full((self.batch,), value, dtype=torch.int64,
                          device=self.device)

    def _fresh(self) -> dict:
        """The reset state of every lane (lpcnet_plc_reset)."""
        i64 = torch.int64
        return dict(
            enc=feat.init_state(self.batch, device=self.device),
            fargan=fg.init_state(self.batch, device=self.device),
            fec=self._zeros(PLC_MAX_FEC, NB_FEATURES),
            fec_read_pos=self._zeros(dtype=i64),
            fec_fill_pos=self._zeros(dtype=i64),
            fec_skip=self._zeros(dtype=i64),
            analysis_gap=self._full(1),
            analysis_pos=self._full(PLC_BUF_SIZE),
            predict_pos=self._full(PLC_BUF_SIZE),
            pcm=self._zeros(PLC_BUF_SIZE),
            blend=self._zeros(dtype=i64),
            features=self._zeros(feat.NB_TOTAL_FEATURES),
            cont_features=self._zeros(CONT_VECTORS * NB_FEATURES),
            loss_count=self._zeros(dtype=i64),
            plc_net=self._zero_net(),
            plc_bak=[self._zero_net(), self._zero_net()])

    def _state(self) -> dict:
        return {k: getattr(self, k) for k in _STATE}

    def _set(self, st: dict):
        for k in _STATE:
            setattr(self, k, st[k])

    def _mask(self, lanes) -> torch.Tensor:
        return lane_mask(lanes, self.batch, self.device)

    def reset(self, lanes=None):
        """The masked lanes (default every lane) back to the reset state."""
        if lanes is None:
            self._set(self._fresh())
            return
        self._set(select_lanes(self._mask(lanes), self._fresh(),
                               self._state()))

    # --- FEC queue (lpcnet_plc.c:92-104) ---
    def fec_add(self, features: Optional[torch.Tensor], present=None,
                lanes=None):
        """Queues one FEC row per lane: lanes where ``present`` holds get
        ``features`` [B, >= 20], the others a skip (the reference's
        fec_add(NULL)); ``lanes`` (default all) limits the call to some
        lanes.  ``features=None`` is a skip on every lane it reaches."""
        lanes = self._mask(lanes)
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

    def fec_clear(self, lanes=None):
        m = self._mask(lanes)
        z = torch.zeros_like(self.fec_read_pos)
        self.fec_read_pos = torch.where(m, z, self.fec_read_pos)
        self.fec_fill_pos = torch.where(m, z, self.fec_fill_pos)
        self.fec_skip = torch.where(m, z, self.fec_skip)

    def _queue_features(self, features, m):
        q = torch.cat([self.cont_features[:, NB_FEATURES:],
                       features[:, :NB_FEATURES]], dim=1)
        self.cont_features = torch.where(m[:, None], q, self.cont_features)

    def _get_fec_or_pred(self, m):
        """(reference: get_fec_or_pred lpcnet_plc.c:119) on the lanes of m:
        a queued FEC row where there is one and no skip is pending, else
        the network's prediction.  The network runs once on every lane, on
        [0 | row | -1] or on zeros.  Updates ``self.features[:, :20]``;
        returns the [B] bool of lanes that took a FEC row."""
        use = m & (self.fec_read_pos != self.fec_fill_pos) \
            & (self.fec_skip == 0)
        pos = torch.clamp(self.fec_read_pos, 0, PLC_MAX_FEC - 1)
        row = torch.gather(self.fec, 1, pos[:, None, None].expand(
            -1, 1, NB_FEATURES))[:, 0]
        plc_in = torch.cat([self._zeros(2 * NB_BANDS), row,
                            torch.full_like(row[:, :1], -1.0)], dim=1)
        plc_in = torch.where(use[:, None], plc_in, torch.zeros_like(plc_in))
        net, pred = compute_plc_pred(self.model, self.plc_net, plc_in)
        self.plc_net = select_lanes(m, net, self.plc_net)
        f20 = torch.where(use[:, None], row, torch.where(
            m[:, None], pred, self.features[:, :NB_FEATURES]))
        self.features = torch.cat([f20, self.features[:, NB_FEATURES:]],
                                  dim=1)
        self.fec_read_pos = self.fec_read_pos + use.to(torch.int64)
        self.fec_skip = torch.where(m & ~use & (self.fec_skip > 0),
                                    self.fec_skip - 1, self.fec_skip)
        return use

    def _rotate_bak(self, m):
        self.plc_bak = select_lanes(m, [self.plc_bak[1], self.plc_net],
                                    self.plc_bak)

    def _advance(self, m):
        """The end of update and conceal: analysis_pos back a frame (or the
        gap flag), on the lanes of m."""
        back = self.analysis_pos - FRAME_SIZE >= 0
        self.analysis_pos = torch.where(m & back,
                                        self.analysis_pos - FRAME_SIZE,
                                        self.analysis_pos)
        self.analysis_gap = torch.where(m & ~back,
                                        torch.ones_like(self.analysis_gap),
                                        self.analysis_gap)

    def _push_pcm(self, pcm_f32, m):
        shifted = torch.cat([self.pcm[:, FRAME_SIZE:], pcm_f32], dim=1)
        self.pcm = torch.where(m[:, None], shifted, self.pcm)

    def update(self, pcm, lanes=None):
        """Good frame received on the masked lanes (reference:
        lpcnet_plc_update lpcnet_plc.c:144).  pcm: int16 [B, 160] (the
        other lanes' rows are not read)."""
        m = self._mask(lanes)
        self._advance(m)
        pp = self.predict_pos
        self.predict_pos = torch.where(m & (pp - FRAME_SIZE >= 0),
                                       pp - FRAME_SIZE, pp)
        pcm = torch.as_tensor(pcm, device=self.device).to(torch.float32)
        self._push_pcm(pcm / 32768.0, m)
        zero = torch.zeros_like(self.loss_count)
        self.loss_count = torch.where(m, zero, self.loss_count)
        self.blend = torch.where(m, zero, self.blend)

    def _catch_up(self, c):
        """On the lanes of c (blend == 0): the analysis of the good frames
        not yet analysed, each lane from its own analysis_pos, and the two
        extra predictions that prime FARGAN (lpcnet_plc.c:166-199).  Slot k
        is the k-th frame of every lane; lane i runs (2400 - pos_i) / 160
        of them."""
        self.plc_net = select_lanes(c, self.plc_bak[0], self.plc_net)
        pos0 = self.analysis_pos
        n = torch.where(c, torch.div(PLC_BUF_SIZE - pos0, FRAME_SIZE,
                                     rounding_mode="floor"),
                        torch.zeros_like(pos0))
        slots = int(n.max()) if self.batch else 0
        ar = torch.arange(FRAME_SIZE, device=self.device)
        frames, active, pred = [], [], []
        for k in range(slots):
            start = pos0 + k * FRAME_SIZE
            idx = torch.clamp(start[:, None] + ar, max=PLC_BUF_SIZE - 1)
            frames.append(32768.0 * torch.gather(self.pcm, 1, idx))
            active.append(k < n)
            pred.append(active[-1] & ((self.analysis_gap == 0) | (k > 0))
                        & (start >= self.predict_pos))
        # the Burg cepstra depend on the PCM buffer alone: one batch for
        # every slot that feeds the network on some lane
        fed = [k for k in range(slots) if bool(pred[k].any())]
        burg = dict(zip(fed, feat.burg_cepstral_analysis(
            torch.cat([frames[k] for k in fed], dim=0)).to(torch.float32)
            .split(self.batch))) if fed else {}
        for k in range(slots):
            a, p = active[k], pred[k]
            enc, f = feat.compute_frame_features(self.enc, frames[k],
                                                 self.pitch_model)
            self.enc = select_lanes(a, enc, self.enc)
            self.features = torch.where(a[:, None], f, self.features)
            if k not in burg:
                continue
            self._queue_features(self.features, p)
            plc_in = torch.cat([burg[k], self.features[:, :NB_FEATURES],
                                torch.ones_like(burg[k][:, :1])], dim=1)
            self._rotate_bak(p)
            net, out = compute_plc_pred(self.model, self.plc_net, plc_in)
            self.plc_net = select_lanes(p, net, self.plc_net)
            self.features = torch.cat(
                [torch.where(p[:, None], out,
                             self.features[:, :NB_FEATURES]),
                 self.features[:, NB_FEATURES:]], dim=1)
        self.analysis_pos = pos0 + n * FRAME_SIZE
        for _ in range(2):
            self._rotate_bak(c)
            self._get_fec_or_pred(c)
            self._queue_features(self.features, c)
        fargan = fg.cont(
            self.fargan_model, self.fargan,
            self.pcm[:, PLC_BUF_SIZE - fg.FARGAN_CONT_SAMPLES:],
            self.cont_features.reshape(self.batch, CONT_VECTORS,
                                       NB_FEATURES))
        self.fargan = select_lanes(c, fargan, self.fargan)
        self.analysis_gap = torch.where(c, torch.zeros_like(
            self.analysis_gap), self.analysis_gap)

    def conceal(self, lanes=None) -> torch.Tensor:
        """One lost 10 ms frame on the masked lanes (reference:
        lpcnet_plc_conceal lpcnet_plc.c:157).  Returns int16 [B, 160],
        zeros on the other lanes."""
        m = self._mask(lanes)
        c = m & (self.blend == 0)
        if bool(c.any()):
            self._catch_up(c)
        self._rotate_bak(m)
        used = self._get_fec_or_pred(m)
        self.fec_used = used
        lc = torch.where(used, torch.zeros_like(self.loss_count),
                         self.loss_count + 1)
        lc = torch.where(m, lc, self.loss_count)
        self.loss_count = lc
        att = const("plc_att_table",
                    lambda: np.asarray(_ATT_TABLE, np.float32), self.device)
        f0 = self.features[:, 0]
        long_loss = (f0 + att[9]) - (2 * (lc - 9)).to(torch.float32)
        short_loss = f0 + att[torch.clamp(lc, 0, 9)]
        f0 = torch.where(m, torch.clamp_min(
            torch.where(lc >= 10, long_loss, short_loss), -15.0), f0)
        self.features = torch.cat([f0[:, None], self.features[:, 1:]], dim=1)
        fargan, out = fg.synthesize_frame(
            self.fargan_model, self.fargan, self.features[:, :NB_FEATURES])
        self.fargan = select_lanes(m, fargan, self.fargan)
        pcm_out = torch.floor(0.5 + torch.clamp(
            32768.0 * out.to(torch.float64), -32767, 32767)) \
            .to(torch.int16)
        pcm_out = torch.where(m[:, None], pcm_out, torch.zeros_like(pcm_out))
        self._queue_features(self.features, m)
        self._advance(m)
        self.predict_pos = torch.where(m, self._full(PLC_BUF_SIZE),
                                       self.predict_pos)
        self._push_pcm(pcm_out.to(torch.float32) / 32768.0, m)
        self.blend = torch.where(m, torch.ones_like(self.blend), self.blend)
        return pcm_out


# the per-lane state, in the order of lpcnet_plc_reset
_STATE = ("enc", "fargan", "fec", "fec_read_pos", "fec_fill_pos", "fec_skip",
          "analysis_gap", "analysis_pos", "predict_pos", "pcm", "blend",
          "features", "cont_features", "loss_count", "plc_net", "plc_bak")
