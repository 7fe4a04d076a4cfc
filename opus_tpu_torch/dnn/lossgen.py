"""Generative packet-loss simulator over a batch of streams: port of
``opus_tpu/dnn/lossgen.py`` (reference: dnn/lossgen.c; architecture from
dnn/torch/lossgen/lossgen.py: 2 -> 8 -> GRU16 -> GRU16 -> 1).

A tiny GRU models bursty network loss: its input is (last_loss,
percent_loss), its output the probability that the next packet is lost.
``BatchedLossGen`` holds one model for B streams, as a server loads one
``lossgen`` blob, and each stream's own GRU states, last loss and random
draws: lane i gives the flags of a JAX ``LossGen(model, seeds[i])``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import nnet as nn
from .weights import WeightArray, linear_params, linear_to_arrays

BURN_IN = 1000        # (reference: sample_loss dnn/lossgen.c:148)
DRAW_BLOCK = 1024     # host draws moved to the device at a time


class LossGenModel(NamedTuple):
    dense_in: nn.Linear        # 2 -> 8, tanh
    gru1_input: nn.Linear      # 8 -> 48
    gru1_recurrent: nn.Linear  # 16 -> 48
    gru2_input: nn.Linear      # 16 -> 48
    gru2_recurrent: nn.Linear  # 16 -> 48
    dense_out: nn.Linear       # 16 -> 1, sigmoid


_NAMES = ("lossgen_dense_in", "lossgen_gru1_input", "lossgen_gru1_recurrent",
          "lossgen_gru2_input", "lossgen_gru2_recurrent", "lossgen_dense_out")
_SHAPES = ((2, 8), (8, 48), (16, 48), (16, 48), (16, 48), (16, 1))


def random_model(seed=0, *, device) -> LossGenModel:
    """Random weights at the published widths, array for array those of
    the JAX package's ``random_model(seed)``."""
    r = np.random.default_rng(seed)

    def rl(m, n):
        w = (r.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
        b = (r.standard_normal(n) * 0.1).astype(np.float32)
        return nn.np_linear(w, b, device=device)

    return LossGenModel(*(rl(m, n) for m, n in _SHAPES))


def model_from_arrays(arrays, *, device) -> LossGenModel:
    """From a parsed weight blob (names per dnn/torch/lossgen's export)."""
    return LossGenModel(*(linear_params(arrays,
                                        float_weights=f"{name}_weights_float",
                                        bias=f"{name}_bias", nb_inputs=m,
                                        nb_outputs=n, device=device)
                          for name, (m, n) in zip(_NAMES, _SHAPES)))


def model_to_arrays(model: LossGenModel) -> list[WeightArray]:
    """The model as blob arrays (the inverse of ``model_from_arrays``)."""
    out = []
    for name, lin in zip(_NAMES, model):
        out.extend(linear_to_arrays(name, lin))
    return out


class BatchedLossGen:
    """Loss flags of B streams (reference: LossGenState dnn/lossgen.h;
    sampling dnn/lossgen.c:116-154) on one device, the card by default.
    Each lane draws from its own ``np.random.default_rng(seeds[i])`` on the
    host (the C uses rand()), in blocks of ``DRAW_BLOCK`` moved to the
    device, and compares the float64 draw with the network's float32
    probability, as the JAX class's ``self.rng.random() < out``."""

    def __init__(self, model: LossGenModel, seeds, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedLossGen: no CUDA device (pass "
                               "device='cpu' for the CPU)")
        self.model = nn.to_device(model, self.device)
        self.seeds = [int(s) for s in seeds]
        self.batch = len(self.seeds)
        self.rngs = [np.random.default_rng(s) for s in self.seeds]
        z = torch.zeros((self.batch, 16), dtype=torch.float32,
                        device=self.device)
        self.g1, self.g2 = z, z.clone()
        self.last_loss = torch.zeros(self.batch, dtype=torch.float32,
                                     device=self.device)
        self.used = False
        self._draws = None
        self._next = 0

    def _draw(self) -> torch.Tensor:
        if self._draws is None or self._next == self._draws.shape[1]:
            block = np.stack([r.random(DRAW_BLOCK) for r in self.rngs])
            self._draws = torch.as_tensor(block, device=self.device)
            self._next = 0
        u = self._draws[:, self._next]
        self._next += 1
        return u

    def _impl(self, percent_loss: float) -> torch.Tensor:
        m = self.model
        x = torch.stack([self.last_loss,
                         torch.full_like(self.last_loss, percent_loss)],
                        dim=1)
        tmp = nn.dense(m.dense_in, x, nn.ACTIVATION_TANH)
        self.g1 = nn.gru(m.gru1_input, m.gru1_recurrent, self.g1, tmp)
        self.g2 = nn.gru(m.gru2_input, m.gru2_recurrent, self.g2, self.g1)
        out = nn.dense(m.dense_out, self.g2, nn.ACTIVATION_SIGMOID)[:, 0]
        loss = self._draw() < out.to(torch.float64)
        self.last_loss = loss.to(torch.float32)
        return loss

    def sample(self, percent_loss: float) -> torch.Tensor:
        """The next flag of every lane: [B] bool on the device (True: the
        packet is lost).  The first call runs the 1000-step burn-in."""
        if not self.used:
            for _ in range(BURN_IN):
                self._impl(percent_loss)
            self.used = True
        return self._impl(percent_loss)
