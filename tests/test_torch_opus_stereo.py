"""Stereo packets and 40/60 ms SILK in the port's top-level decoder
(opus_tpu_torch/models/opus_decoder.py ``BatchedOpusDecoder(channels=1|2)``)
on the CPU, against the JAX package's scalar ``OpusDecoder(48000, 1|2)``:

- over the whole fixture tests/data/torch_opus_stereo.npz (8 streams:
  mono SILK NB/MB/WB at 40 and 60 ms with LBRR frames, stereo CELT at
  2.5-20 ms in dual and intensity stereo, stereo SILK-WB at 20/40/60 ms
  with mid-only frames, stereo SWB/FB hybrid, a stream switching between
  stereo and mono packets; losses covered by in-band FEC or concealed;
  written by tools/make_torch_opus_stereo_fixture.py), all 8 on 8 lanes
  at once, at one and at two output channels: final range equal on every
  step, int16 equal on every step the scalar CELT decoder took no part in
  (SILK alone, both channels), float PCM within 1e-4 on the others, and
  FEC and concealed steps with a CELT part within CLASSIC_LSB (4) LSB;
- the lane-batched SILK stereo pieces (``opus_tpu_torch/silk/stereo.py``)
  against ``opus_tpu/silk/stereo.py`` on seeded inputs, bit for bit: the
  predictors from every joint, 3- and 5-level index, and mid/side ->
  left/right over frames with the state carried, at 8, 12 and 16 kHz.
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.models.opus_decoder import BatchedOpusDecoder
from opus_tpu_torch.silk import stereo as ST
from opus_tpu_torch.utils.soft_clip import (float2int16_lanes,
                                            soft_clip_lanes)

FIXTURE = "tests/data/torch_opus_stereo.npz"
PCM_TOL = 1e-4
CLASSIC_LSB = int(32768 * PCM_TOL) + 1


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _steps(fx, s):
    """Stream s's steps: (packet or None, fec, frame_size)."""
    plen, buf = fx["plen"], fx["packets"]
    return [(None if plen[s, t] == -1 else bytes(buf[s, t, :plen[s, t]]),
             bool(fx["fec"][s, t]), int(fx["fsize"][s, t]))
            for t in range(plen.shape[1]) if plen[s, t] != -2]


def _jax_int16(x, mem, c):
    from opus_tpu.utils.soft_clip import float2int16, pcm_soft_clip
    x = np.asarray(x, np.float32).copy()
    pcm_soft_clip(x, c, mem)
    return float2int16(x)


@pytest.mark.parametrize("channels", [1, 2])
def test_torch_opus_stereo_fixture_matches_scalar(fx, channels):
    """The whole fixture, 8 lanes at once, at ``channels`` output
    channels: ranges, PCM, int16 (soft clip per channel)."""
    c = channels
    s_n = fx["plen"].shape[0]
    streams = [_steps(fx, s) for s in range(s_n)]
    ticks = max(len(r) for r in streams)
    dec = BatchedOpusDecoder(s_n, channels=c, device="cpu")
    mem = np.zeros((s_n, c), np.float32)
    seen = dict(pcm=0.0, conceal=0, silk_exact=0, celt=0, fec=0)
    for t in range(ticks):
        row = [r[t] if t < len(r) else (None, False, 0) for r in streams]
        pcm, n = dec.decode([p for p, _f, _s in row],
                            decode_fec=[f for _p, f, _s in row],
                            frame_size=[sz for _p, _f, sz in row])
        x = pcm if c == 2 else pcm[:, :, None]
        b, w, _c = x.shape
        rows = x.permute(0, 2, 1).reshape(b * c, w)
        clipped, smem = soft_clip_lanes(rows, dec.softclip_mem.reshape(-1),
                                        n=np.repeat(n, c))
        dec.softclip_mem = smem.reshape(dec.softclip_mem.shape)
        pcm16 = float2int16_lanes(clipped).reshape(b, c, w).permute(
            0, 2, 1).numpy()
        xs = x.numpy()
        rng = dec.final_range.numpy()
        assert not dec.flagged.any() and not dec.status.any()
        for s in range(s_n):
            if t >= len(streams[s]):
                continue
            p, fec, _sz = streams[s][t]
            ns = int(fx[f"nsamp{c}"][s, t])
            o = int(fx[f"off{c}"][s, t])
            ref = fx[f"pcm{c}"][o:o + ns * c]
            assert n[s] == ns, (s, t)
            assert rng[s] == fx[f"rng{c}"][s, t], (s, t)
            want16 = _jax_int16(ref, mem[s], c).reshape(-1, c)
            got16 = pcm16[s, :n[s]].astype(np.int64)
            celt = fx[f"celt{c}"][s, t]
            if celt == 0:
                assert np.array_equal(got16, want16), (s, t)
                seen["silk_exact"] += 1
            elif p is None or fec:
                d = int(np.abs(got16 - want16).max(initial=0))
                assert d <= CLASSIC_LSB, (s, t, d)
                seen["conceal"] = max(seen["conceal"], d)
            else:
                e = float(np.abs(xs[s, :n[s]].reshape(-1) - ref).max(
                    initial=0))
                assert e <= PCM_TOL, (s, t, e)
                seen["pcm"] = max(seen["pcm"], e)
                seen["celt"] += 1
            seen["fec"] += fec
    ev = dec.events
    for k in ("celt_lm0_start0_stereo", "celt_lm1_start0_stereo",
              "celt_lm2_start0_stereo", "celt_lm3_start0_stereo",
              "celt_lm3_start17_stereo", "silk_16k_60ms_stereo",
              "silk_16k_40ms_stereo", "silk_8k_40ms", "silk_8k_60ms",
              "silk_12k_60ms", "silk_16k_60ms", "celt_lm3_start0",
              "silk_stereo_to_mono", "fec_frames"):
        assert ev.get(k, 0) > 0, (k, ev)
    print(f"\nchannels {c}: {seen}; events {ev}")


def _scalar_pred(n, ix):
    """opus_tpu/silk/stereo.stereo_decode_pred on given symbols."""
    from opus_tpu.silk import stereo

    class Dec:
        def __init__(self, syms):
            self.syms = list(syms)

        def dec_icdf(self, _tab, _ftb):
            return self.syms.pop(0)
    return stereo.stereo_decode_pred(Dec([n, ix[0][0], ix[0][1], ix[1][0],
                                          ix[1][1]]))


def test_torch_silk_stereo_pred_matches_scalar():
    """Every (joint, 3-level, 5-level) index combination's predictors."""
    rng = np.random.default_rng(5)
    n = np.repeat(np.arange(25), 12)
    a = rng.integers(0, 3, (n.size, 2))
    c = rng.integers(0, 5, (n.size, 2))
    t = torch.as_tensor
    got = ST.pred_q13((t(n), [(t(a[:, 0]), t(c[:, 0])),
                              (t(a[:, 1]), t(c[:, 1]))])).numpy()
    for k in range(n.size):
        want = _scalar_pred(int(n[k]), [(int(a[k, 0]), int(c[k, 0])),
                                        (int(a[k, 1]), int(c[k, 1]))])
        assert got[k].tolist() == want, k


@pytest.mark.parametrize("fs_khz", [8, 12, 16])
def test_torch_silk_ms_to_lr_matches_scalar(fs_khz):
    """Mid/side -> left/right on 6 lanes over 4 frames of 20 ms, the
    predictors changing each frame (including jumps that saturate) and the
    state carried, against ``StereoDecState.ms_to_lr``: every sample and
    every state field equal."""
    from opus_tpu.silk.stereo import StereoDecState

    rng = np.random.default_rng(fs_khz)
    b, L = 6, 20 * fs_khz
    ref = [StereoDecState() for _ in range(b)]
    st = dict(pred_prev_q13=torch.zeros((b, 2), dtype=torch.int64),
              s_mid=torch.zeros((b, 2), dtype=torch.int64),
              s_side=torch.zeros((b, 2), dtype=torch.int64))
    for _f in range(4):
        mid = rng.integers(-32768, 32768, (b, L)) // rng.integers(
            1, 40, (b, 1))
        side = rng.integers(-32768, 32768, (b, L)) // rng.integers(
            1, 200, (b, 1))
        pred = rng.integers(-13732, 13733, (b, 2))
        z = np.zeros((b, 2), np.int64)
        x1 = np.concatenate([z, mid], 1)
        x2 = np.concatenate([z, side], 1)
        left, right, st = ST.ms_to_lr(torch.as_tensor(x1),
                                      torch.as_tensor(x2),
                                      torch.as_tensor(pred), st, fs_khz)
        for i in range(b):
            a, c = list(x1[i]), list(x2[i])
            ref[i].ms_to_lr(a, c, list(pred[i]), fs_khz, L)
            assert left[i].tolist() == a and right[i].tolist() == c, i
            assert st["s_mid"][i].tolist() == ref[i].sMid
            assert st["s_side"][i].tolist() == ref[i].sSide
            assert st["pred_prev_q13"][i].tolist() == ref[i].pred_prev_Q13


def test_torch_opus_stereo_continues_from_jax_state(fx, channels=2):
    """Three two-channel JAX decoders (the stereo CELT, the stereo SILK with 40/60 ms
    and mid-only frames, the stereo <-> mono stream) run to step 5, their
    state converted (``convert.opus_decoder_state``: both SILK channels,
    the stereo state, both channels' CELT memory): the port goes on for
    4 steps as the scalar decoders do (ranges equal, SILK int16 exact,
    PCM within 1e-4, concealed within CLASSIC_LSB), and its own
    ``get_state`` copy goes on bit for bit."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu_torch.convert import opus_decoder_state

    c = channels
    streams = (3, 5, 7)
    steps = [_steps(fx, s) for s in streams]
    refs = [OpusDecoder(48000, c) for _ in streams]
    for ref, st in zip(refs, steps):
        for p, fec, sz in st[:5]:
            ref.decode(p, sz or None, decode_fec=fec)
    dec = BatchedOpusDecoder(len(streams), channels=c, device="cpu")
    dec.set_state(opus_decoder_state(refs))
    twin = BatchedOpusDecoder(len(streams), channels=c, device="cpu")
    twin.set_state(dec.get_state())
    for t in range(5, 9):
        row = [st[t] for st in steps]
        args = ([p for p, _f, _z in row], [f for _p, f, _z in row],
                [z for _p, _f, z in row])
        pcm, n = dec.decode(*args)
        pcm2, _n2 = twin.decode(*args)
        assert torch.equal(pcm, pcm2)
        x = (pcm if c == 2 else pcm[:, :, None]).numpy()
        for i, ref in enumerate(refs):
            p, fec, sz = row[i]
            want = np.asarray(ref.decode(p, sz or None, decode_fec=fec))
            assert n[i] * c == len(want), (i, t)
            assert int(dec.final_range[i]) == ref.rangeFinal, (i, t)
            d = np.abs(x[i, :n[i]].reshape(-1) - want).max(initial=0)
            lim = CLASSIC_LSB / 32768 if p is None or fec else PCM_TOL
            assert d <= lim, (i, t, d)
