"""Carries decoder state and tables across from the JAX package.

A codec has no weights: what both sides must share to compute the same
thing are the static mode tables and the per-stream decoder state.

- ``state_from_jax``: the JAX decoder state (``fused_celt_init_state`` /
  ``kernel_celt_decode_to_pcm`` dict, numpy leaves, per-band lists of [B]
  lanes, ``dsp`` a ``DecState``) -> the port's state dict of tensors.
- ``state_to_numpy``: the port's state -> the JAX layout with numpy
  leaves (``dsp`` as a dict; ``DecState(**dsp)`` rebuilds the JAX tuple).
- ``tabs_from_jax``: builds the port's ``DecTabs`` and checks every table
  against the JAX package's ``DecTabs``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.celt_dec_fused import DecTabs

_BAND_KEYS = ("old_e", "prev1", "prev2")
_INT_KEYS = ("pf_period", "pf_period_old", "pf_tapset", "pf_tapset_old")
_F32_KEYS = ("pf_gain", "pf_gain_old")
_DSP_KEYS = ("tail", "hist", "deemph")


def state_from_jax(np_state: dict, device="cpu") -> dict:
    """JAX decoder state (numpy leaves) -> the port's state dict."""
    def t(v, dtype):
        return torch.as_tensor(np.array(v), device=device).to(dtype)

    out = {k: t(np.stack([np.asarray(e) for e in np_state[k]], axis=1),
                torch.float32) for k in _BAND_KEYS}
    out["seed"] = t(np.asarray(np_state["seed"]).astype(np.int64),
                    torch.int64)
    out.update({k: t(np_state[k], torch.int64) for k in _INT_KEYS})
    out.update({k: t(np_state[k], torch.float32) for k in _F32_KEYS})
    dsp = np_state["dsp"]
    dsp = dsp._asdict() if hasattr(dsp, "_asdict") else dict(dsp)
    out["dsp"] = {k: t(dsp[k], torch.float32) for k in _DSP_KEYS}
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's state -> the JAX package's layout, numpy leaves."""
    def n(v):
        return v.detach().cpu().numpy()

    out = {k: [n(state[k][:, i]) for i in range(state[k].shape[1])]
           for k in _BAND_KEYS}
    out["seed"] = n(state["seed"]).astype(np.uint32)
    out.update({k: n(state[k]).astype(np.int32) for k in _INT_KEYS})
    out.update({k: n(state[k]).astype(np.float32) for k in _F32_KEYS})
    out["dsp"] = {k: n(state["dsp"][k]) for k in _DSP_KEYS}
    return out


def tabs_from_jax(jax_tabs) -> DecTabs:
    """The port's DecTabs for the same (fs, frame size, band range), with
    every table checked equal to the JAX package's twin."""
    mode = jax_tabs.mode
    tabs = DecTabs(int(mode.Fs), mode.shortMdctSize << jax_tabs.lm,
                   jax_tabs.start, jax_tabs.end_band)
    for name in ("lm", "M", "nb", "start", "end_band", "logN", "caps",
                 "cache_rows", "e_prob"):
        if getattr(tabs, name) != getattr(jax_tabs, name):
            raise ValueError(f"DecTabs.{name} differs from the JAX twin")
    for name in ("eBands", "width", "allocV"):
        if not np.array_equal(getattr(tabs, name), getattr(jax_tabs, name)):
            raise ValueError(f"DecTabs.{name} differs from the JAX twin")
    return tabs
