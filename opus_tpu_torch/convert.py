"""Carries codec state and tables across from the JAX package.

A codec has no weights: what both sides must share to compute the same
thing are the static mode tables and the per-stream encoder and decoder
state.

- ``state_from_jax``: the JAX decoder state (``fused_celt_init_state`` /
  ``kernel_celt_decode_to_pcm`` dict, numpy leaves, per-band lists of [B]
  lanes, ``dsp`` a ``DecState``) -> the port's state dict of tensors.
- ``state_to_numpy``: the port's state -> the JAX layout with numpy
  leaves (``dsp`` as a dict; ``DecState(**dsp)`` rebuilds the JAX tuple).
  The JAX tiers keep 1026 samples of history and no loss state: coming
  from JAX the history is padded with zeros in front and nothing is
  lost (a lane with energies off their reset values has decoded a
  packet).
- ``celt_state_from_scalar`` / ``celt_state_to_numpy``: the scalar tier's
  ``CeltDecoder`` states (numpy fields, one a lane: the decode memory,
  energies, background, loss counters, postfilter phases, ``rng``, the
  PLC's LPC and period, the de-emphasis memory) to and from the port's
  per-lane state, so that a port lane can start from any scalar state.
- ``tabs_from_jax``: builds the port's ``DecTabs`` and checks every table
  against the JAX package's ``DecTabs``.
- ``enc_state_from_jax`` / ``enc_state_to_numpy``: the same for the
  encoder state (``fused_celt_enc_init`` layout).
- ``enc_tabs_from_jax``: builds the port's encoder ``ETabs`` and checks the
  encoder tables and wrap matrices against the JAX package's ``ETabs``.
- ``silk_state_from_jax`` / ``silk_state_to_numpy``: the SILK decoder
  state (``FusedSilkState`` / ``SilkState`` with numpy leaves) to and from
  the port's dict.
- ``silk_state_from_scalar`` / ``silk_state_to_scalar``: the scalar
  tier's SILK ``ChannelState`` (its fields as numpy arrays and numbers,
  ``SILK_SCALAR_KEYS``, one a lane) to and from the port's per-lane SILK
  state with its loss fields, so that a port lane can start from any
  scalar state and be held to the next one.
- ``silk_tabs_from_jax``: builds the port's SILK ``_SilkTabs`` and checks
  every table against the JAX package's.
- ``hybrid_state_from_jax`` / ``hybrid_state_to_numpy``: the hybrid
  decoder's state (the JAX ``hybrid_init_state`` dict: ``silk``, ``celt``
  and the upsampler's ``rs``) to and from the port's dict, which also
  holds ``smid``, SILK's mono 2-sample output buffer that the JAX layout
  lacks (zeros when coming from JAX, an extra key going back).
- ``fargan_from_jax``, ``rdovae_enc_from_jax``, ``rdovae_dec_from_jax``:
  a JAX DNN model (its NamedTuple, leaves as numpy arrays or anything
  ``np.asarray`` reads) -> the port's model of float32 tensors on a
  device, field for field; ``dred_stats_from_jax``: the DRED coding
  statistics, which stay numpy (the payload parse runs on the host).
- ``pitchdnn_from_jax``, ``plc_from_jax``: the pitch DNN (its Conv2d layers
  included) and the PLC network, the same way.
- ``lace_from_jax``, ``nolace_from_jax``: the OSCE models (nested
  NamedTuples of layers: the feature net, the comb, conv and shape
  layers), the same way.
- ``bbwe_from_jax``: the BBWE model (its feature net, and the tuples of
  the adaptive conv and shape layers), the same way.
- ``lossgen_from_jax``: the generative loss model, the same way.
- ``lpcnet_state_from_jax``: B JAX ``LPCNetPLC`` instances (one stream
  each, each at its own point of its own call sequence) -> one B-lane
  ``LPCNetPLC`` of the port holding their stacked state (feature analysis,
  pitch DNN, FARGAN, PLC GRU and its backups, FEC queue, PCM buffer and
  every counter, per lane), so that both can start mid-stream.
- ``dred_enc_state_from_jax``: B JAX ``DREDEnc`` instances (in lockstep)
  -> one B-lane ``BatchedDREDEnc`` holding their stacked feature, pitch
  DNN, RDOVAE and resampler state, latent ring and pending 16 kHz input,
  with their shared fills and offsets, so that both can start mid-stream.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .dnn import (bbwe, dred, dred_enc, fargan, features, lossgen, nnet,
                  osce, pitchdnn, plc, rdovae)
from .models import batched_decode
from .models.celt_dec_fused import DecTabs, fused_celt_init_state
from .models.celt_dec_kernel import dec_tabs
from .ops.lanes import select_lanes

_BAND_KEYS = ("old_e", "prev1", "prev2")
_INT_KEYS = ("pf_period", "pf_period_old", "pf_tapset", "pf_tapset_old")
_F32_KEYS = ("pf_gain", "pf_gain_old")
_DSP_KEYS = ("tail", "hist", "deemph")


def _loss_defaults(out: dict, device) -> dict:
    """The loss state of ``fused_celt_init_state`` for a decoder state
    without one (the JAX tiers keep none: they never conceal): nothing
    lost, ``e_copy`` equal to old_e, the final range the seed; a lane
    whose energies are not the reset values has decoded a packet
    (``decoded_any``, ``skip_plc`` clear), the others are fresh."""
    b = out["old_e"].shape[0]
    fresh = fused_celt_init_state(b, dec_tabs(), device)
    decoded = (out["old_e"] != 0).any(1) | (out["prev1"] != -28.0).any(1) \
        | (out["prev2"] != -28.0).any(1)
    fresh.update(out)
    fresh.update(e_copy=out["old_e"].clone(), prev1_1=out["prev1"].clone(),
                 prev2_1=out["prev2"].clone(), rng_final=out["seed"].clone(),
                 decoded_any=decoded,
                 skip_plc=torch.where(decoded, 0, fresh["skip_plc"]))
    return fresh


def state_from_jax(np_state: dict, device="cpu") -> dict:
    """JAX decoder state (numpy leaves) -> the port's state dict; the
    JAX tier's 1026-sample history is padded with zeros in front to the
    port's HIST, and nothing is lost (``_loss_defaults``)."""
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
    h = out["dsp"]["hist"]
    out["dsp"]["hist"] = torch.nn.functional.pad(
        h, (batched_decode.HIST - h.shape[1], 0))
    return _loss_defaults(out, device)


def state_to_numpy(state: dict) -> dict:
    """The port's state -> the JAX package's layout, numpy leaves (the
    last 1026 samples of the history, no loss state)."""
    def n(v):
        return v.detach().cpu().numpy()

    out = {k: [n(state[k][:, i]) for i in range(state[k].shape[1])]
           for k in _BAND_KEYS}
    out["seed"] = n(state["seed"]).astype(np.uint32)
    out.update({k: n(state[k]).astype(np.int32) for k in _INT_KEYS})
    out.update({k: n(state[k]).astype(np.float32) for k in _F32_KEYS})
    out["dsp"] = {k: n(state["dsp"][k]) for k in _DSP_KEYS}
    out["dsp"]["hist"] = out["dsp"]["hist"][:, -batched_decode.COMB_HIST:]
    return out


# ---- the scalar CELT decoder's state (opus_tpu/celt/decoder.py) ----
_SCALAR_INT = dict(loss_duration="loss_duration",
                   plc_duration="plc_duration", skip_plc="skip_plc",
                   last_frame_type="last_frame_type",
                   prefilter_and_fold="prefilter_and_fold",
                   last_pitch_index="last_pitch_index",
                   pf_period="postfilter_period",
                   pf_period_old="postfilter_period_old",
                   pf_tapset="postfilter_tapset",
                   pf_tapset_old="postfilter_tapset_old")
_SCALAR_F32 = dict(pf_gain="postfilter_gain",
                   pf_gain_old="postfilter_gain_old")
SCALAR_KEYS = tuple(_SCALAR_INT.values()) + tuple(_SCALAR_F32.values()) + (
    "decode_mem", "oldEBands", "oldLogE", "oldLogE2", "backgroundLogE",
    "rng", "plc_lpc", "preemph_memD")


def _preemph() -> float:
    """The de-emphasis coefficient: the scalar keeps coef * y[-1] as its
    memory, the port y[-1]."""
    from .celt.modes import mode_create
    return float(mode_create(48000, 960).preemph[0])


def _scalar_get(d, k):
    return d[k] if isinstance(d, dict) else getattr(d, k)


def celt_state_from_scalar(decoders, device="cpu", decoded_any=True,
                           out_channels: int = 1) -> dict:
    """Mono 48 kHz states of the scalar tier's ``CeltDecoder`` (objects, or
    dicts of their fields as numpy arrays and numbers; ``SCALAR_KEYS``),
    one a lane -> the port's per-lane state (``fused_celt_init_state``'s
    layout): decode_mem[0, :2048] is the history, [2048:2108] the IMDCT
    tail and [2048:2168] the extrapolated overlap a fold reads; the
    energies' first nb entries are old_e / prev1 / prev2 / background
    and [nb:2nb] the second channel's (e_copy, prev1_1, prev2_1,
    background_1); ``rng`` is both the next frame's seed and the final
    range.  out_channels=2: the second output channel's synthesis state
    from decode_mem[1], as ``fused_celt_init_state`` with that flag."""
    def col(k, dtype):
        return torch.as_tensor(np.array([np.asarray(_scalar_get(d, k))
                                         for d in decoders]),
                               device=device).to(dtype)

    mem = col("decode_mem", torch.float64)[:, 0]
    nb = col("oldEBands", torch.float64).shape[1] // 2
    e = {k: col(k, torch.float64) for k in ("oldEBands", "oldLogE",
                                            "oldLogE2", "backgroundLogE")}
    h = batched_decode.HIST
    f32 = torch.float32
    out = dict(
        old_e=e["oldEBands"][:, :nb].to(f32),
        e_copy=e["oldEBands"][:, nb:2 * nb].to(f32),
        prev1=e["oldLogE"][:, :nb].to(f32), prev2=e["oldLogE2"][:, :nb]
        .to(f32), background=e["backgroundLogE"][:, :nb].to(f32),
        seed=col("rng", torch.int64),
        plc_lpc=col("plc_lpc", torch.float64)[:, 0],
        fold=mem[:, h:].to(f32),
        dsp=dict(hist=mem[:, :h].to(f32),
                 tail=mem[:, h:h + (mem.shape[1] - h) // 2].to(f32),
                 deemph=(col("preemph_memD", torch.float64)[:, 0]
                         / _preemph()).to(f32)))
    out.update({p: col(k, torch.int64) for p, k in _SCALAR_INT.items()})
    out.update({p: col(k, f32) for p, k in _SCALAR_F32.items()})
    out["rng_final"] = out["seed"].clone()
    out["decoded_any"] = torch.full((len(decoders),), bool(decoded_any),
                                    device=device)
    out.update(prev1_1=e["oldLogE"][:, nb:2 * nb].to(f32),
               prev2_1=e["oldLogE2"][:, nb:2 * nb].to(f32),
               background_1=e["backgroundLogE"][:, nb:2 * nb].to(f32))
    if out_channels == 2:
        mem1 = col("decode_mem", torch.float64)[:, 1]
        out.update(
            plc_lpc_1=col("plc_lpc", torch.float64)[:, 1],
            fold_1=mem1[:, h:].to(f32),
            dsp_1=dict(hist=mem1[:, :h].to(f32),
                       tail=mem1[:, h:h + (mem1.shape[1] - h) // 2].to(f32),
                       deemph=(col("preemph_memD", torch.float64)[:, 1]
                               / _preemph()).to(f32)))
    return out


def celt_state_to_numpy(state: dict) -> list:
    """The port's per-lane state -> one dict a lane in the scalar
    ``CeltDecoder``'s field names (``SCALAR_KEYS``), numpy leaves;
    decode_mem [1, 2048 + overlap] holds the fold buffer past the history
    on a lane that will fold, the IMDCT tail elsewhere."""
    def n(v):
        return v.detach().cpu().numpy()

    dsp = state["dsp"]
    fold = n(state["fold"]).astype(np.float64)
    tail = n(dsp["tail"]).astype(np.float64)
    on = n(state["prefilter_and_fold"]) != 0
    out = []
    for i in range(fold.shape[0]):
        after = fold[i].copy()
        if not on[i]:
            after[:] = 0.0
            after[:tail.shape[1]] = tail[i]
        lane = dict(decode_mem=np.concatenate(
            [n(dsp["hist"][i]).astype(np.float64), after])[None, :])
        for k, name in (("old_e", "oldEBands"), ("prev1", "oldLogE"),
                        ("prev2", "oldLogE2"),
                        ("background", "backgroundLogE")):
            second = state["e_copy" if k == "old_e" else k + "_1"][i]
            lane[name] = np.concatenate([n(state[k][i]), n(second)]
                                        ).astype(np.float64)
        lane.update({name: int(state[p][i]) for p, name in
                     _SCALAR_INT.items()})
        lane.update({name: float(state[p][i]) for p, name in
                     _SCALAR_F32.items()})
        lane.update(rng=int(state["seed"][i]),
                    plc_lpc=n(state["plc_lpc"][i])[None, :],
                    preemph_memD=np.array(
                        [_preemph() * float(dsp["deemph"][i]), 0.0]))
        out.append(lane)
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


# ---- encoder ----
_ENC_BAND_KEYS = ("old_band_e", "old_log_e", "old_log_e2", "energy_error")
_ENC_INT_KEYS = ("consec_transient", "last_coded_bands", "tonal_average",
                 "hf_average", "tapset_decision", "spread_decision")
_ENC_F32_KEYS = ("mem", "hist", "overlap_max", "spec_avg", "delayed_intra")


def enc_state_from_jax(np_state: dict, device="cpu") -> dict:
    """JAX encoder state (``fused_celt_enc_init`` layout, numpy leaves,
    per-band lists of [B] lanes) -> the port's state dict ([B, nb]
    tensors for the per-band entries)."""
    def t(v, dtype):
        return torch.as_tensor(np.array(v), device=device).to(dtype)

    out = {k: t(np.stack([np.asarray(e) for e in np_state[k]], axis=1),
                torch.float32) for k in _ENC_BAND_KEYS}
    out.update({k: t(np_state[k], torch.int64) for k in _ENC_INT_KEYS})
    out.update({k: t(np_state[k], torch.float32) for k in _ENC_F32_KEYS})
    return out


def enc_state_to_numpy(state: dict) -> dict:
    """The port's encoder state -> the JAX layout, numpy leaves."""
    def n(v):
        return v.detach().cpu().numpy()

    out = {k: [n(state[k][:, i]) for i in range(state[k].shape[1])]
           for k in _ENC_BAND_KEYS}
    out.update({k: n(state[k]).astype(np.int32) for k in _ENC_INT_KEYS})
    out.update({k: n(state[k]).astype(np.float32) for k in _ENC_F32_KEYS})
    return out


def enc_tabs_from_jax(jax_tabs):
    """The port's ETabs for the JAX package's ``celt_enc_kernel.ETabs``,
    with the encoder tables (``jax_tabs.enc``: the MDCT bases, band map
    and mask, noise floor) and the input-side wrap matrices checked equal
    to the JAX twin's."""
    from .models.celt_enc_kernel import ETabs

    mode = jax_tabs.mode
    tabs = ETabs(int(mode.Fs), mode.shortMdctSize << jax_tabs.lm)
    enc = jax_tabs.enc
    for name in ("basis_l", "basis_s", "band_map", "band_mask"):
        if not np.array_equal(getattr(tabs, name), getattr(enc, name)):
            raise ValueError(f"EncTabs.{name} differs from the JAX twin")
    if list(tabs.noise_floor) != list(enc.noise_floor):
        raise ValueError("EncTabs.noise_floor differs from the JAX twin")
    if tabs.ewmat_off != jax_tabs.ewmat_off:
        raise ValueError("ETabs.ewmat_off differs from the JAX twin")
    if not np.array_equal(tabs.ewmats, jax_tabs.ewmats):
        raise ValueError("ETabs.ewmats differs from the JAX twin")
    for name in ("band_n", "band_base", "nx_rows"):
        if getattr(tabs, name) != getattr(jax_tabs, name):
            raise ValueError(f"ETabs.{name} differs from the JAX twin")
    return tabs


# ---- SILK decoder ----
_SILK_KEYS = ("prev_nlsf", "last_gain_index", "prev_gain_q16",
              "first_frame")
_SYNTH_KEYS = ("slpc", "out_buf")


def _leaves(st, keys):
    return {k: np.asarray(st[k] if isinstance(st, dict) else getattr(st, k))
            for k in keys}


def silk_state_from_jax(np_state, device="cpu") -> dict:
    """A JAX ``FusedSilkState`` (or its synthesis part, a ``SilkState``)
    with numpy leaves -> the port's state dict (int64 tensors, first_frame
    bool; the synthesis fields under ``synth``, or the ``SilkState``'s own
    two fields)."""
    def t(v):
        v = np.array(v, np.bool_ if v.dtype == np.bool_ else np.int64)
        return torch.from_numpy(v).to(device)

    synth = np_state.get("synth") if isinstance(np_state, dict) \
        else getattr(np_state, "synth", None)
    if synth is None:                                   # a SilkState
        return {k: t(v) for k, v in _leaves(np_state, _SYNTH_KEYS).items()}
    out = {k: t(v) for k, v in _leaves(np_state, _SILK_KEYS).items()}
    out["synth"] = {k: t(v) for k, v in _leaves(synth,
                                                _SYNTH_KEYS).items()}
    return out


def silk_state_to_numpy(state: dict) -> dict:
    """The port's SILK state (fused or synthesis-only) -> the JAX layout
    with numpy leaves: int32, first_frame bool; ``FusedSilkState(**d)``
    and ``SilkState(**d["synth"])`` rebuild the JAX tuples."""
    def n(v):
        v = v.detach().cpu().numpy()
        return v if v.dtype == np.bool_ else v.astype(np.int32)

    if "synth" not in state:
        return {k: n(state[k]) for k in _SYNTH_KEYS}
    out = {k: n(state[k]) for k in _SILK_KEYS}
    out["synth"] = {k: n(state["synth"][k]) for k in _SYNTH_KEYS}
    return out


# the scalar ChannelState's fields -> the port's SILK state keys
# (``synth.<k>`` under the synthesis dict)
SILK_SCALAR_KEYS = dict(
    exc_Q14="exc_q14", sLPC_Q14_buf="synth.slpc", outBuf="synth.out_buf",
    lagPrev="lag_prev", lossCnt="loss_cnt", prevSignalType="prev_signal_type",
    first_frame_after_reset="first_frame", prev_gain_Q16="prev_gain_q16",
    LastGainIndex="last_gain_index", prevNLSF_Q15="prev_nlsf",
    plc_pitchL_Q8="plc_pitch_l_q8", plc_LTPCoef_Q14="plc_ltp_coef_q14",
    plc_prevLPC_Q12="plc_prev_lpc_q12",
    plc_prevLTP_scale_Q14="plc_prev_ltp_scale_q14",
    plc_prevGain_Q16="plc_prev_gain_q16",
    plc_randScale_Q14="plc_rand_scale_q14", plc_rand_seed="plc_rand_seed",
    plc_conc_energy="plc_conc_energy",
    plc_conc_energy_shift="plc_conc_energy_shift",
    plc_last_frame_lost="plc_last_frame_lost", plc_nb_subfr="plc_nb_subfr",
    plc_subfr_length="plc_subfr_length", cng_exc_buf_Q14="cng_exc_buf_q14",
    cng_smth_NLSF_Q15="cng_smth_nlsf_q15", cng_synth_state="cng_synth_state",
    cng_smth_Gain_Q16="cng_smth_gain_q16", cng_rand_seed="cng_rand_seed")


def silk_state_from_scalar(fields: dict, device="cpu") -> dict:
    """The scalar ``ChannelState``'s fields (``SILK_SCALAR_KEYS``; each a
    numpy array with the lane first, outBuf its first ltp_mem samples) of
    16 kHz 20 ms lanes -> the port's SILK state dict.  A channel that has
    not run a frame yet (its CNG NLSFs all zero) gets the PLC and CNG
    reset values its first frame would set, which the port's initial
    state holds."""
    from .models.silk_plc import loss_init_state

    fields = dict(fields)
    fresh = ~np.asarray(fields["cng_smth_NLSF_Q15"]).any(axis=1)
    if fresh.any():
        init = loss_init_state(1, 16, 4, "cpu")
        for k, p in (("cng_smth_NLSF_Q15", "cng_smth_nlsf_q15"),
                     ("plc_pitchL_Q8", "plc_pitch_l_q8")):
            v = np.array(fields[k], np.int64)
            v[fresh] = init[p][0].numpy()
            fields[k] = v
    out = dict(synth={})
    for k, p in SILK_SCALAR_KEYS.items():
        v = torch.as_tensor(np.asarray(fields[k], np.int64), device=device)
        if p == "first_frame":
            v = v != 0
        if p.startswith("synth."):
            out["synth"][p[6:]] = v
        else:
            out[p] = v
    out["decoded_any"] = torch.ones_like(out["first_frame"])
    return out


def silk_state_to_scalar(state: dict) -> dict:
    """The port's SILK state -> the scalar ``ChannelState``'s fields
    (``SILK_SCALAR_KEYS``) as int64 numpy arrays, the lane first."""
    out = {}
    for k, p in SILK_SCALAR_KEYS.items():
        v = state["synth"][p[6:]] if p.startswith("synth.") else state[p]
        out[k] = v.detach().cpu().numpy().astype(np.int64)
    return out


def silk_tabs_from_jax(jax_tabs):
    """The port's ``_SilkTabs`` for the JAX package's
    ``fused_silk_dec._SilkTabs`` (same fs_khz and nb_subfr), with every
    table array and scalar checked equal to the JAX twin's."""
    from .models.fused_silk_dec import _SilkTabs

    tabs = _SilkTabs(jax_tabs.fs_khz, jax_tabs.nb_subfr)
    for name, ref in vars(jax_tabs).items():
        got = getattr(tabs, name)
        if name == "cb":                              # NLSFCodebook fields
            same = vars(got) == vars(ref)
        elif name == "shell":
            same = len(got) == len(ref) and all(
                np.array_equal(g, r) for g, r in zip(got, ref))
        elif isinstance(ref, np.ndarray):
            same = np.array_equal(got, ref) and got.dtype == ref.dtype
        else:
            same = got == ref
        if not same:
            raise ValueError(f"_SilkTabs.{name} differs from the JAX twin")
    return tabs


# ---- hybrid decoder ----
_RS_KEYS = ("s_iir", "s_fir", "delay")


def hybrid_state_from_jax(np_state: dict, device="cpu") -> dict:
    """The JAX hybrid state (numpy leaves; ``rs`` an ``UpsamplerState`` or
    dict) -> the port's dict; ``smid`` starts at zeros unless given."""
    rs = _leaves(np_state["rs"], _RS_KEYS)
    b = rs["s_iir"].shape[0]
    smid = np.asarray(np_state.get("smid", np.zeros((b, 2))), np.int64)
    return dict(
        silk=silk_state_from_jax(np_state["silk"], device),
        celt=state_from_jax(np_state["celt"], device),
        rs={k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in rs.items()},
        smid=torch.from_numpy(smid).to(device))


def hybrid_state_to_numpy(state: dict) -> dict:
    """The port's hybrid state -> the JAX layout with numpy leaves
    (``UpsamplerState(**d["rs"])`` rebuilds the JAX tuple) plus
    ``smid`` as int32, which the JAX decoder does not read."""
    def n(v):
        return v.detach().cpu().numpy().astype(np.int32)

    return dict(silk=silk_state_to_numpy(state["silk"]),
                celt=state_to_numpy(state["celt"]),
                rs={k: n(state["rs"][k]) for k in _RS_KEYS},
                smid=n(state["smid"]))


# ---- DNN models ----
def _dnn_tree(jax_tree, port_cls, device):
    """A JAX model NamedTuple -> ``port_cls`` with the same fields: Linear
    and Conv2d layers (NamedTuples of arrays, None leaves kept), tuples of
    layers and bare arrays become float32 tensors on ``device``; any other
    NamedTuple becomes the class of its name in ``port_cls``'s module."""
    def leaf(v):
        return None if v is None else torch.as_tensor(
            np.array(v, np.float32), device=device)

    def layer(v):
        cls = nnet.Conv2d if type(v).__name__ == "Conv2d" else nnet.Linear
        return cls(*(leaf(a) for a in v))

    def field(v):
        name = type(v).__name__
        if hasattr(v, "_fields") and name not in ("Linear", "Conv2d"):
            return _dnn_tree(v, getattr(sys.modules[port_cls.__module__],
                                        name), device)
        if hasattr(v, "_fields"):
            return layer(v)
        if isinstance(v, tuple):
            return tuple(layer(x) for x in v)
        return leaf(v)

    return port_cls(*(field(getattr(jax_tree, f)) for f in port_cls._fields))


def fargan_from_jax(model, device="cpu"):
    """A JAX ``FARGANModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, fargan.FARGANModel, device)


def rdovae_enc_from_jax(model, device="cpu"):
    """A JAX ``RDOVAEEnc`` -> the port's, on ``device``."""
    return _dnn_tree(model, rdovae.RDOVAEEnc, device)


def rdovae_dec_from_jax(model, device="cpu"):
    """A JAX ``RDOVAEDec`` -> the port's, on ``device``."""
    return _dnn_tree(model, rdovae.RDOVAEDec, device)


def dred_stats_from_jax(stats):
    """The JAX ``DREDStats`` -> the port's (uint8 numpy tables)."""
    return dred.DREDStats(*(np.asarray(getattr(stats, f), np.uint8)
                            for f in dred.DREDStats._fields))


def pitchdnn_from_jax(model, device="cpu"):
    """A JAX ``PitchDNNModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, pitchdnn.PitchDNNModel, device)


def plc_from_jax(model, device="cpu"):
    """A JAX ``PLCModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, plc.PLCModel, device)


def lace_from_jax(model, device="cpu"):
    """A JAX ``LACEModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, osce.LACEModel, device)


def nolace_from_jax(model, device="cpu"):
    """A JAX ``NoLACEModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, osce.NoLACEModel, device)


def bbwe_from_jax(model, device="cpu"):
    """A JAX ``BBWEModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, bbwe.BBWEModel, device)


def lossgen_from_jax(model, device="cpu"):
    """A JAX ``LossGenModel`` -> the port's, on ``device``."""
    return _dnn_tree(model, lossgen.LossGenModel, device)


def _stack(leaves, device, dtype=torch.float32):
    return torch.as_tensor(np.stack([np.asarray(v) for v in leaves]),
                           device=device).to(dtype)


def _stack_tuple(cls, items, device, dtypes=None):
    """B NamedTuples of arrays (or tuples of arrays) -> one ``cls`` of [B]
    tensors."""
    out = []
    for k, f in enumerate(cls._fields):
        vals = [getattr(it, f) for it in items]
        dt = (dtypes or {}).get(f, torch.float32)
        if isinstance(vals[0], tuple):
            out.append(tuple(_stack([v[j] for v in vals], device, dt)
                             for j in range(len(vals[0]))))
        else:
            out.append(_stack(vals, device, dt))
    return cls(*out)


def _feature_state(states, device) -> features.FeatureState:
    """B JAX ``FeatureState``s -> one of [B] tensors (the pitch DNN's
    included)."""
    dnn = _stack_tuple(pitchdnn.PitchDNNState, [e.dnn for e in states],
                       device)
    return features.FeatureState(
        *(_stack([getattr(e, f) for e in states], device,
                 {"prev_if": torch.complex128,
                  "lp_mem": torch.float64}.get(f, torch.float32))
          for f in features.FeatureState._fields[:-1]), dnn)


_LANE_COUNTERS = ("fec_read_pos", "fec_fill_pos", "fec_skip", "loss_count",
                  "analysis_gap", "analysis_pos", "predict_pos", "blend")


def lpcnet_state_from_jax(jax_plcs, device="cpu"):
    """B JAX ``LPCNetPLC`` -> a B-lane ``plc.LPCNetPLC`` on ``device`` with
    the first instance's models and every lane's state, its counters
    included: the instances may stand at different points of their own
    call sequences."""
    first = jax_plcs[0]
    out = plc.LPCNetPLC(plc_from_jax(first.model, device),
                        pitchdnn_from_jax(first.pitch_model, device),
                        fargan_from_jax(first.fargan_model, device),
                        len(jax_plcs), device=device)
    out.enc = _feature_state([j.enc for j in jax_plcs], device)
    out.fargan = _stack_tuple(fargan.FARGANState,
                              [j.fargan for j in jax_plcs], device,
                              {"last_period": torch.int32})
    for name in ("fec", "pcm", "features", "cont_features"):
        setattr(out, name, _stack([getattr(j, name) for j in jax_plcs],
                                  device))
    for name in _LANE_COUNTERS:
        setattr(out, name, _stack([getattr(j, name) for j in jax_plcs],
                                  device, torch.int64))

    def net(nets):
        return tuple(_stack([n[k] for n in nets], device) for k in range(2))

    out.plc_net = net([j.plc_net for j in jax_plcs])
    out.plc_bak = [net([j.plc_bak[k] for j in jax_plcs]) for k in range(2)]
    return out


_DRED_HOST_INTS = ("fs", "channels", "input_buffer_fill",
                   "latents_buffer_fill", "dred_offset", "latent_offset")


def dred_enc_state_from_jax(jax_encs, device="cpu"):
    """B JAX ``DREDEnc`` -> a B-lane ``dred_enc.BatchedDREDEnc`` on
    ``device`` with the first instance's models and every lane's state.
    The host ints (rate, channels, fills, offsets) must agree across the
    instances (the port keeps one of each)."""
    first = jax_encs[0]
    for name in _DRED_HOST_INTS:
        if len({int(getattr(j, name)) for j in jax_encs}) != 1:
            raise ValueError(f"dred_enc_state_from_jax: {name} differs "
                             f"between the instances")
    out = dred_enc.BatchedDREDEnc(
        first.fs, first.channels, rdovae_enc_from_jax(first.model, device),
        pitchdnn_from_jax(first.pitch_model, device),
        dred_stats_from_jax(first.stats), len(jax_encs), device=device)
    out.feat_state = _feature_state([j.feat_state for j in jax_encs],
                                    device)
    out.rdovae_state = _stack_tuple(rdovae.RDOVAEEncState,
                                    [j.rdovae_state for j in jax_encs],
                                    device)
    fill = int(first.input_buffer_fill)
    out.input_buffer = _stack([j.input_buffer[:fill] for j in jax_encs],
                              device)
    out.resample_mem = _stack([j.resample_mem for j in jax_encs], device,
                              torch.float64)
    out.latents = _stack([j.latents for j in jax_encs], device)
    out.states = _stack([j.states for j in jax_encs], device)
    for name in ("latents_buffer_fill", "dred_offset", "latent_offset"):
        setattr(out, name, int(getattr(first, name)))
    return out


# ---- the top-level Opus decoder ----


def opus_decoder_state(jax_decoders, device="cpu") -> dict:
    """B scalar ``OpusDecoder``s of the JAX package (all at one rate below
    96 kHz and one output channel count), taken mid-stream -> the port's
    per-lane
    ``BatchedOpusDecoder`` state (``BatchedOpusDecoder.set_state``): the
    CELT decoder (``celt_state_from_scalar`` with both channels' energy
    memory, and the second output channel's synthesis state on a
    two-channel decoder; the Opus level gates its concealment, so every
    lane counts as having decoded), the SILK side (``silk_api.SilkLanes``:
    both channel states at their rates at the port's widest buffers, the
    first 320 samples of the scalar's outBuf, exc_Q14 and CNG buffer,
    their packet flags and conditional-coding memory; both resamplers to
    the decoder's rate, each field padded to ``resampler.WIDE``: the IIR
    or AR2 state, the FIR history, the delay line; the stereo state: the 2-sample mid and side buffers and the
    last predictor; on the host each channel's rate (0 before its first
    frame or after a reset), the internal channel count and
    prev_decode_only_middle), the soft clip memories, the final range and
    the host fields: prev_mode, prev_redundancy, mode, bandwidth, coded
    channels, frame size, last packet duration, the CELT decoder's start
    and end, the gain."""
    from .models.opus_decoder import BatchedOpusDecoder
    from .models.silk_api import silk_fresh
    from .silk.resampler import WIDE
    decs = list(jax_decoders)
    b = len(decs)
    cc = decs[0].channels
    celt = celt_state_from_scalar([d.celt for d in decs], device,
                                  out_channels=cc)
    # the port's widths: a scalar field as long as the LPC order (10 at NB
    # and MB) or the frame is zero-padded to them, outBuf cut to them
    widths = {}
    for key, name in SILK_SCALAR_KEYS.items():
        v = silk_fresh(1, 16, "cpu")
        for part in name.split("."):
            v = v[part]
        widths[key] = v.shape[1] if v.dim() > 1 else None
    chans, rss = [], []
    for k in range(2):
        fields = {}
        for key in SILK_SCALAR_KEYS:
            rows = []
            for d in decs:
                v = np.asarray(getattr(d.silk.channel_state[k], key),
                               np.int64)
                w = widths[key]
                rows.append(v if w is None else np.pad(
                    v.reshape(-1)[:w], (0, max(0, w - v.size))))
            fields[key] = np.stack(rows)
        st = silk_state_from_scalar(fields, device)
        cs = [d.silk.channel_state[k] for d in decs]
        st.update(
            vad_flags=torch.as_tensor(np.array([c.VAD_flags for c in cs],
                                               bool), device=device),
            lbrr_flags=torch.as_tensor(np.array([c.LBRR_flags for c in cs],
                                                bool), device=device),
            ec_prev_type=torch.as_tensor(np.array(
                [c.ec_prevSignalType for c in cs], np.int64), device=device),
            ec_prev_lag=torch.as_tensor(np.array(
                [c.ec_prevLagIndex for c in cs], np.int64), device=device))
        fresh = [c.fs_kHz == 0 for c in cs]
        if any(fresh):
            m = torch.as_tensor(fresh, device=device)
            st = select_lanes(m, silk_fresh(b, 16, device), st)
        chans.append(st)
        rs = {k: np.zeros((b, w), np.int64) for k, w in WIDE.items()}
        for i, c in enumerate(cs):
            r = c.resampler
            if r is not None:
                rs["s_iir"][i] = r.s_iir[:WIDE["s_iir"]]
                rs["s_fir"][i] = r.s_fir[:WIDE["s_fir"]]
                rs["delay"][i, :r.input_delay] = r.delay_buf[:r.input_delay]
        rss.append({key: torch.from_numpy(v).to(device)
                    for key, v in rs.items()})

    def stereo(key):
        return torch.as_tensor(np.array([getattr(d.silk.sStereo, key)
                                         for d in decs], np.int64),
                               device=device)
    silk = dict(
        ch0=chans[0], ch1=chans[1], rs0=rss[0], rs1=rss[1],
        smid=stereo("sMid"), sside=stereo("sSide"),
        pred_prev=stereo("pred_prev_Q13"),
        host=dict(fs0=np.array([d.silk.channel_state[0].fs_kHz
                                for d in decs], np.int64),
                  fs1=np.array([d.silk.channel_state[1].fs_kHz
                                for d in decs], np.int64),
                  n_int=np.array([d.silk.nChannelsInternal for d in decs],
                                 np.int64),
                  prev_dom=np.array([bool(d.silk.prev_decode_only_middle)
                                     for d in decs])))
    scalar = dict(
        prev_mode=lambda d: d.prev_mode,
        prev_redundancy=lambda d: bool(d.prev_redundancy),
        mode=lambda d: int(d.mode), bandwidth=lambda d: int(d.bandwidth),
        stream_channels=lambda d: d.stream_channels,
        frame_size=lambda d: d.frame_size,
        last_packet_duration=lambda d: d.last_packet_duration,
        celt_start=lambda d: d.celt.start, celt_end=lambda d: d.celt.end,
        decode_gain=lambda d: d.decode_gain)
    host = {k: [scalar[k](d) for d in decs]
            for k in BatchedOpusDecoder.HOST_KEYS}
    return dict(
        celt=celt, silk=silk,
        softclip_mem=torch.as_tensor(np.array(
            [np.asarray(d.softclip_mem[:cc]) for d in decs], np.float32),
            device=device).reshape((b, cc)[:cc]),
        rng=torch.as_tensor(np.array([d.rangeFinal for d in decs],
                                     np.int64), device=device),
        host={k: np.asarray(v, bool if k == "prev_redundancy" else np.int64)
              for k, v in host.items()})

def opus_ms_decoder_state(jax_decoders, device="cpu") -> dict:
    """B multistream decoders of the JAX package (``OpusMSDecoder``, or a
    projection decoder's ``.ms``; one layout, one rate), taken mid-stream
    -> the port's ``BatchedOpusMSDecoder.set_state`` dict: each elementary
    decoder's state (``opus_decoder_state``) on its row of the inner
    batched decoders, lane i's stream s at i * coupled + s (stereo) or
    i * uncoupled + s - coupled (mono)."""
    decs = list(jax_decoders)
    cp, n = decs[0].coupled_streams, decs[0].streams
    return dict(
        coupled=opus_decoder_state([d.decoders[s] for d in decs
                                    for s in range(cp)], device)
        if cp else None,
        mono=opus_decoder_state([d.decoders[s] for d in decs
                                 for s in range(cp, n)], device)
        if n > cp else None)
