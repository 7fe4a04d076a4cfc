"""The slice end to end on the CPU: the port's KernelCeltDecoder (plain
versions of kernels K1 and K2) over chained 20 ms frames, against

- the JAX package's fused_celt_decode_to_pcm, its symbol pass run under
  tests/np_shim as the JAX package's own tests run it: final ranges and
  error lanes exact, PCM within 1e-5;
- the scalar OpusDecoder (bit-exact with libopus; float64): PCM within
  1e-4 absolute on PCM in [-1, 1] (an 800-term f32 IMDCT dot product
  is ~800 u = 5e-5 of its term sum at worst; the comb filter and
  de-emphasis add a few u);
- a state handoff mid-stream (convert.state_from_jax / state_to_numpy);

and decoding 2.5/5 ms frames, which the reference's kernel decoder refuses.
"""

import numpy as np
import pytest
import torch

from tests import np_shim
from tests.test_celt_dec_fused import _encode_frames
from opus_tpu_torch.convert import state_from_jax, state_to_numpy
from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder

NFRAMES = 6
HANDOFF = 3


def _chain():
    from opus_tpu.models.opus_decoder import OpusDecoder

    frames = _encode_frames(960, nframes=NFRAMES, bitrate=64000)
    dec = OpusDecoder(48000, 1)
    ref_pcm, ref_rng = [], []
    for f in frames:
        ref_pcm.append(np.asarray(dec.decode(bytes([0xF8]) + f)).reshape(-1))
        ref_rng.append(dec.celt.rng)

    saved = np_shim.install()
    try:
        from opus_tpu.models.celt_dec_fused import (
            DecTabs, fused_celt_decode_to_pcm, fused_celt_init_state)
        from opus_tpu.ops import rc_kernel as K
        jtabs = DecTabs(48000, 960)
        state = fused_celt_init_state(2, jtabs)
        jax_pcm, jax_rng, jax_err = [], [], []
        cap = (max(len(f) for f in frames) + 3) // 4 * 4
        for i, f in enumerate(frames):
            if i == HANDOFF:
                jax_state_mid = {k: (v if k == "dsp" else
                                     ([np.asarray(e) for e in v]
                                      if isinstance(v, list)
                                      else np.asarray(v)))
                                 for k, v in state.items()}
                jax_state_mid["dsp"] = {k: np.asarray(v) for k, v in
                                        state["dsp"]._asdict().items()}
            a = np.frombuffer(f, np.uint8)
            bufb = np.zeros((2, cap), np.uint32)
            bufb[:, :len(a)] = a
            pcm, state, err = fused_celt_decode_to_pcm(
                K.pack_words(bufb, cap), np.full(2, len(a), np.int32),
                state, jtabs)
            jax_pcm.append(np.asarray(pcm)[0, 0])
            jax_rng.append(int(np.asarray(state["seed"])[0]))
            jax_err.append(bool(np.asarray(err).any()))
    finally:
        np_shim.uninstall(saved)

    dec = KernelCeltDecoder(2, max_payload=cap, device="cpu")
    port_pcm, port_rng, port_err = [], [], []
    for i, f in enumerate(frames):
        if i == HANDOFF:
            port_state_mid = state_to_numpy(dec.state)
        pcm, err = dec.decode([f, f])
        port_pcm.append(pcm[0, 0].numpy())
        port_rng.append(int(dec.state["seed"][0]))
        port_err.append(bool(err.any()))
    return dict(frames=frames, cap=cap, ref_pcm=ref_pcm, ref_rng=ref_rng,
                jax_pcm=jax_pcm, jax_rng=jax_rng, jax_err=jax_err,
                jax_state_mid=jax_state_mid, port_pcm=port_pcm,
                port_rng=port_rng, port_err=port_err,
                port_state_mid=port_state_mid)


def _check_matches_jax_fused(chain):
    assert chain["port_rng"] == chain["jax_rng"]
    assert chain["port_err"] == chain["jax_err"] == [False] * NFRAMES
    for i, (p, j) in enumerate(zip(chain["port_pcm"], chain["jax_pcm"])):
        assert np.abs(p - j).max() <= 1e-5, f"frame {i}"


def _check_matches_scalar(chain):
    assert chain["port_rng"] == chain["ref_rng"]
    for i, (p, r) in enumerate(zip(chain["port_pcm"], chain["ref_pcm"])):
        assert np.abs(p - r).max() <= 1e-4, f"frame {i}"


def _check_continues_from_jax_state(chain):
    """Frames [HANDOFF, NFRAMES) on the port from the JAX decoder's state:
    the same final ranges as the scalar decoder, PCM within 1e-4."""
    dec = KernelCeltDecoder(2, max_payload=chain["cap"], device="cpu")
    dec.state = state_from_jax(chain["jax_state_mid"])
    for i in range(HANDOFF, NFRAMES):
        f = chain["frames"][i]
        pcm, err = dec.decode([f, f])
        assert not err.any()
        assert int(dec.state["seed"][0]) == chain["ref_rng"][i]
        assert np.abs(pcm[0, 0].numpy() - chain["ref_pcm"][i]).max() <= 1e-4


def _check_state_roundtrip_bit_identical(chain):
    """Port state -> JAX layout (numpy) -> port continues bit-identically
    to the uninterrupted run."""
    dec = KernelCeltDecoder(2, max_payload=chain["cap"], device="cpu")
    dec.state = state_from_jax(chain["port_state_mid"])
    for i in range(HANDOFF, NFRAMES):
        f = chain["frames"][i]
        pcm, _err = dec.decode([f, f])
        assert np.array_equal(pcm[0, 0].numpy(), chain["port_pcm"][i])
        assert int(dec.state["seed"][0]) == chain["port_rng"][i]


def test_torch_decoder_chain():
    """One chained run shared by all checks: the JAX twin under np_shim
    costs ~2 s a frame, so it runs once per process, not once per test."""
    chain = _chain()
    _check_matches_jax_fused(chain)
    _check_matches_scalar(chain)
    _check_continues_from_jax_state(chain)
    _check_state_roundtrip_bit_identical(chain)


@pytest.mark.parametrize("frame_size", [120, 240])
def test_torch_kernel_decoder_refuses_lm_0_and_1(frame_size):
    """2.5 and 5 ms frames (LM 0/1): the reference's KernelCeltDecoder
    still refuses them (KTabs asserts LM >= 2); the port's decoder takes
    them on the plain versions of K1 and K2, and its chain of 6 frames
    gives the scalar OpusDecoder's final ranges and PCM within 1e-4."""
    from opus_tpu.models.celt_dec_kernel import \
        KernelCeltDecoder as JaxKernelCeltDecoder
    from opus_tpu.models.opus_decoder import OpusDecoder

    with pytest.raises(AssertionError):
        JaxKernelCeltDecoder(1024, frame_size=frame_size)
    dec = KernelCeltDecoder(2, frame_size=frame_size, device="cpu")
    assert dec.tabs.lm == {120: 0, 240: 1}[frame_size]
    frames = _encode_frames(frame_size, nframes=NFRAMES, bitrate=64000)
    toc = bytes([(28 + dec.tabs.lm) << 3])        # CELT-only fullband
    ref = OpusDecoder(48000, 1)
    for f in frames:
        want = np.asarray(ref.decode(toc + f)).reshape(-1)
        pcm, err = dec.decode([f, f])
        assert not err.any()
        assert dec.final_range().tolist() == [ref.rangeFinal] * 2
        assert np.abs(pcm[:, 0].numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("frame_size", [480, 960])
def test_torch_kernel_decoder_builds_at_lm_2_and_3(frame_size):
    dec = KernelCeltDecoder(2, frame_size=frame_size, device="cpu")
    assert dec.tabs.lm == {480: 2, 960: 3}[frame_size]
