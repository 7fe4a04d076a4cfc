"""The port's encoder end to end on the CPU: KernelCeltEncoder(device=
"cpu") over the 8 fixture frames of 8 streams with its own state carried
(tests/data/torch_celt20ms_64k_enc.npz).

- The scalar decoder (opus_tpu/celt/decoder.py, bit-exact with libopus)
  consumes every stream and lands on the encoder's final range in every
  frame: integers, exact.
- Decoded quality is within 1 dB of the JAX twin's stored SNR per stream
  (the front end's f32 sums run in another order, so a tie may flip a
  decision; 1 dB is the JAX package's own gate for its kernel twin).
- The port's encoder feeds the port's KernelCeltDecoder(device="cpu")
  directly and both reach the same final range.
- The encoder state round-trips through convert.enc_state_from_jax /
  enc_state_to_numpy, and the port's ETabs equals the JAX twin's.
- The entry points default to CUDA and raise where there is no card."""

import os

import numpy as np
import pytest
import torch

from opus_tpu_torch import convert
from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder
from opus_tpu_torch.models.celt_enc_kernel import KernelCeltEncoder
from opus_tpu_torch.quality import best_snr

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_celt20ms_64k_enc.npz")


@pytest.fixture(scope="module")
def encoded():
    fx = np.load(FIXTURE)
    pcm = fx["pcm"]
    ns, nf, n = pcm.shape
    enc = KernelCeltEncoder(ns, device="cpu")
    dec = KernelCeltDecoder(ns, max_payload=160, device="cpu")
    frames, pcm_out, dec_rng = [], [], []
    for f in range(nf):
        payload, rng, err = enc.encode_device(torch.as_tensor(pcm[:, f]))
        assert not err.any(), f
        frames.append((payload.numpy(), rng.numpy()))
        out, derr = dec.decode_packed(payload, torch.full((ns,), 160))
        assert not derr.any(), f
        pcm_out.append(out[:, 0].numpy())
        dec_rng.append(dec.state["seed"].numpy())
    return fx, frames, pcm_out, dec_rng, enc


def test_torch_encoder_streams_decode_to_final_range(encoded):
    from opus_tpu.celt.decoder import CeltDecoder

    fx, frames, _pcm, _dr, _enc = encoded
    ns, nf, n = fx["pcm"].shape
    same = 0
    for s in range(ns):
        dec = CeltDecoder.create(48000, 1)
        outs = []
        for f in range(nf):
            out = np.zeros(n)
            assert dec.decode_with_ec(bytes(frames[f][0][s].tobytes()), out,
                                      n, None) == n
            assert int(dec.rng) & 0xFFFFFFFF == int(frames[f][1][s]), (s, f)
            outs.append(out.copy())
            same += int(np.array_equal(frames[f][0][s], fx["payload"][f, s]))
        snr = best_snr(fx["pcm"][s].reshape(-1), np.concatenate(outs), n)
        assert snr > fx["snr"][s] - 1.0, (s, snr, fx["snr"][s])
    print(f"payloads byte-identical to the JAX twin: {same}/{ns * nf}")


def test_torch_encoder_feeds_port_decoder(encoded):
    fx, frames, _pcm, dec_rng, _enc = encoded
    for f, (_p, rng) in enumerate(frames):
        assert np.array_equal(dec_rng[f], rng), f


def test_torch_enc_state_and_tabs_convert(encoded):
    _fx, _fr, _pcm, _dr, enc = encoded
    np_state = convert.enc_state_to_numpy(enc.state)
    back = convert.enc_state_from_jax(np_state)
    assert back.keys() == enc.state.keys()
    for k, v in enc.state.items():
        assert torch.equal(back[k], v), k

    from tests.np_shim import install, uninstall
    import opus_tpu.models.celt_enc_kernel as EK
    import opus_tpu.models.celt_enc_fused as JEF
    mods = install(extra_modules=[EK, JEF])
    try:
        jax_tabs = EK.ETabs(48000, 960)
        jax_state = JEF.fused_celt_enc_init(3, jax_tabs.enc)
    finally:
        uninstall(mods)
    tabs = convert.enc_tabs_from_jax(jax_tabs)
    assert tabs.nb == jax_tabs.nb
    st = convert.enc_state_from_jax(jax_state)
    for k, v in st.items():
        assert v.shape[0] == 3, k


def test_torch_entry_points_default_to_cuda():
    """The encoder and decoder run on the card unless the caller passes
    device="cpu"; without a card the default raises (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError):
        KernelCeltEncoder(2)
    with pytest.raises(RuntimeError):
        KernelCeltDecoder(2)
