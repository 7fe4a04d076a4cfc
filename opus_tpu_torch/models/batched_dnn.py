"""Batched execution of the neural stacks: port of
``opus_tpu/models/batched_dnn.py``.  The batch axis (streams) leads every
DNN state, so thousands of FARGAN vocoders (deep-PLC / DRED synthesis) or
RDOVAE decoders run as one batch of matrix products on one device; the
frame loop is a Python loop (the JAX package's ``lax.scan``)."""

from __future__ import annotations

import torch

from ..dnn import fargan as fg
from ..dnn import rdovae


def fargan_batch_step(model: fg.FARGANModel):
    """A (state, features [B, 20]) -> (state, pcm [B, 160]) step over a
    stream batch."""

    def step(state, features):
        return fg.synthesize_frame(model, state, features)

    return step


def fargan_synthesize_frames(model: fg.FARGANModel, state: fg.FARGANState,
                             features):
    """T feature frames for a whole batch: features [T, B, 20] -> (state,
    pcm [T, B, 160])."""
    pcm = []
    for f in features:
        state, p = fg.synthesize_frame(model, state, f)
        pcm.append(p)
    return state, torch.stack(pcm)


def rdovae_decode_frames(model: rdovae.RDOVAEDec, initial_state, latents):
    """Batched DRED feature decode: initial_state [B, 24], latents
    [T, B, 81] -> (state, qframes [T, B, 80], 4 x 20 features each)."""
    state = rdovae.dec_init_state(model, initial_state)
    qframes = []
    for z in latents:
        state, q = rdovae.decode_qframe(model, state, z)
        qframes.append(q)
    return state, torch.stack(qframes)
