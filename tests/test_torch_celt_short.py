"""2.5 and 5 ms CELT frames (LM 0/1) in the port:

- the plain K1 twin and the synthesis (``kernel_celt_decode_to_pcm`` on
  CPU tensors) on one lane whose frame size switches 20 -> 10 -> 5 -> 2.5
  -> 20 ms on one state, against the JAX package's scalar decoder
  (``OpusDecoder``, bit-exact with libopus): final ranges equal, PCM
  within 1e-4;
- kernel K1's CUDA source compiled as host C++ (the shim of
  tests/test_torch_k1_host.py), one lane a warp and 4 host threads a
  warp, against the plain twin at LM 0 and 1: the API fixture's 2.5 and 5
  ms CELT frames at start 0, the same bytes at start 17, the 2.5 ms
  silence frame b"\\xff\\xff" the hybrid -> SILK fade decodes, truncated
  and random-byte lanes; integers identical, X and energies within
  tests/test_torch_k1_host.py's bounds.
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.models.celt_dec_fused import fused_celt_init_state
from opus_tpu_torch.models.celt_dec_kernel import (dec_tabs,
                                                   decode_frame_plain,
                                                   kernel_celt_decode_to_pcm)
from tests import test_torch_k1_host as H

SIZES = (960, 960, 480, 480, 240, 240, 240, 120, 120, 120, 120, 960, 960)


def _switching_stream():
    """One CELT-only fullband stream whose frame size follows SIZES
    (packets with TOC), from the JAX encoder."""
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_encoder import OpusEncoder

    enc = OpusEncoder(48000, 1, application="restricted-lowdelay")
    enc.set_bitrate(64000)
    rng = np.random.default_rng(12)
    t = np.arange(sum(SIZES)) / 48000
    sig = 0.3 * np.sin(2 * np.pi * 330 * t) \
        + 0.05 * rng.standard_normal(len(t))
    out, pos = [], 0
    for n in SIZES:
        p = enc.encode(sig[pos:pos + n], n)
        assert pkt.packet_get_mode(p) == pkt.Mode.CELT_ONLY
        out.append(p)
        pos += n
    return out


def test_torch_celt_short_frames_switching_sizes_match_scalar():
    from opus_tpu.models.opus_decoder import OpusDecoder

    packets = _switching_stream()
    ref = OpusDecoder(48000, 1)
    state = fused_celt_init_state(2, dec_tabs(48000, 960))
    worst = 0.0
    for n, p in zip(SIZES, packets):
        want = np.asarray(ref.decode(p)).reshape(-1)
        f = p[1:]
        buf = torch.from_numpy(np.frombuffer(f * 2, np.uint8).reshape(2, -1)
                               .copy())
        lens = torch.tensor([len(f)] * 2)
        pcm, state, err = kernel_celt_decode_to_pcm(
            buf, lens, state, dec_tabs(48000, n))
        assert not err.any()
        assert state["rng_final"].tolist() == [ref.rangeFinal] * 2
        e = float(np.abs(pcm[:, 0].numpy() - want).max())
        assert e <= 1e-4, (n, e)
        worst = max(worst, e)
    print(f"\nPCM within {worst:.3g} of the scalar decoder")


def _short_lanes(frame_size: int, rng):
    """The API fixture's CELT frames of ``frame_size`` (their TOC byte
    stripped; packets of several frames split), then 2 silence frames,
    8 truncated and 8 random-byte lanes."""
    from opus_tpu_torch.bitstream.packet import (packet_get_mode,
                                                 packet_get_samples_per_frame,
                                                 packet_parse)
    fx = np.load("tests/data/torch_opus_api.npz")
    frames = []
    for s in range(fx["plen"].shape[0]):
        for t in range(fx["plen"].shape[1]):
            n = fx["plen"][s, t]
            if n <= 2:
                continue
            p = bytes(fx["packets"][s, t, :n])
            if packet_get_mode(p) == 1002 \
                    and packet_get_samples_per_frame(p, 48000) == frame_size:
                frames += [f for f in packet_parse(p).frames if len(f) > 1]
    assert len(frames) >= 8
    frames += [b"\xff\xff"] * 2
    p = max(len(f) for f in frames)
    for j in range(16):
        src = frames[j % len(frames)]
        if j < 8:
            frames.append(src[:int(rng.integers(0, len(src) + 1))])
        else:
            frames.append(bytes(rng.integers(0, 256, int(
                rng.integers(0, p + 1))).astype(np.uint8)))
    buf = np.zeros((len(frames), p), np.uint8)
    ln = np.zeros(len(frames), np.int64)
    for i, f in enumerate(frames):
        buf[i, :len(f)] = np.frombuffer(f, np.uint8)
        ln[i] = len(f)
    return buf, ln


@pytest.fixture(scope="module")
def k1_libs(tmp_path_factory):
    return {lanes: H._build(str(tmp_path_factory.mktemp(f"k1s{lanes}")),
                            lanes) for lanes in (1, 4)}


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("frame_size", [120, 240])
def test_torch_k1_source_on_host_at_lm_0_1(k1_libs, frame_size, lanes):
    rng = np.random.default_rng(frame_size + lanes)
    buf, ln = _short_lanes(frame_size, rng)
    b = buf.shape[0]
    for start, end in ((0, 21), (0, 17), (17, 21)):
        tabs = dec_tabs(48000, frame_size, start, end)
        assert tabs.lm == {120: 0, 240: 1}[frame_size]
        old_e = rng.normal(0, 4, (b, tabs.nb)).astype(np.float32)
        prevmin = rng.normal(0, 4, (b, tabs.nb)).astype(np.float32)
        seed = rng.integers(0, 2 ** 32, b).astype(np.int64)
        ref = decode_frame_plain(*(torch.from_numpy(a) for a in
                                   (buf, ln, old_e, prevmin, seed)), tabs)
        got = H._run_host(k1_libs[lanes], tabs, buf, ln, old_e, prevmin,
                          seed)
        H._check(tabs, got, ref)
        if start == 0:
            sil = ref["silence"][-18:-16]
            assert sil.tolist() == [1, 1]          # the fade's frame
