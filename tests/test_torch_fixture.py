"""The committed fixture tests/data/torch_celt20ms_64k.npz (written by
tools/make_torch_fixture.py with the scalar codec): the port's
KernelCeltDecoder on the CPU decodes every stream to the scalar
decoder's stored final ranges, and to its PCM within 1e-4 (the bound of
tests/test_torch_celt_decoder.py).  chip_smoke.py holds the card to the
same outputs."""

import os

import numpy as np
import torch

from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_celt20ms_64k.npz")


def test_torch_decoder_fixture_final_ranges():
    fx = np.load(FIXTURE)
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    dec = KernelCeltDecoder(ns, max_payload=p, device="cpu")
    for f in range(nf):
        pcm, err = dec.decode_packed(torch.from_numpy(frames[:, f]),
                                     torch.from_numpy(lens[:, f]))
        assert not err.any()
        assert dec.state["seed"].tolist() == \
            fx["final_range"][:, f].astype(np.int64).tolist(), f"frame {f}"
        assert np.abs(pcm[:, 0].numpy() - fx["pcm"][:, f]).max() <= 1e-4


def test_torch_wrappers_take_no_other_device():
    """A wrapper runs its plain version only for CPU tensors; any other
    device goes to the CUDA kernel's checks, which refuse a non-CUDA
    tensor instead of falling back."""
    import pytest
    from opus_tpu_torch.models.celt_dec_kernel import decode_frame
    from opus_tpu_torch.ops.iir import deemphasis

    meta = torch.device("meta")
    with pytest.raises(ValueError):
        deemphasis(torch.zeros((2, 960), device=meta),
                   torch.zeros(2, device=meta), 0.85)
    with pytest.raises(ValueError):
        decode_frame(torch.zeros((2, 160), dtype=torch.uint8, device=meta),
                     torch.zeros(2, dtype=torch.int64, device=meta),
                     torch.zeros((2, 21), device=meta),
                     torch.zeros((2, 21), device=meta),
                     torch.zeros(2, dtype=torch.int64, device=meta))
    from opus_tpu_torch.models.celt_enc_kernel import encode_frame
    ins = {k: torch.zeros(2, dtype=torch.int64, device=meta)
           for k in ("silence", "is_transient", "tf_select", "spread_calc",
                     "trim_calc", "prev_cb", "consec_transient")}
    ins.update({k: torch.zeros((2, 21), device=meta)
                for k in ("tf_res", "offsets_cnt", "ble_b", "old_e")})
    ins["delayed_intra"] = torch.zeros(2, device=meta)
    with pytest.raises(ValueError):
        encode_frame(torch.zeros((2, 800), device=meta), ins)
