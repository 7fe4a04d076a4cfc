"""The port's three decoders refuse a payload longer than their
``max_payload``, as the reference's do (numpy cannot broadcast it into the
row): a packet cut to the row decodes wrongly and mostly unflagged.  A
payload that fits is packed unchanged, zero-padded, with its length."""

import numpy as np
import pytest
import torch

from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder
from opus_tpu_torch.models.fused_silk_dec import FusedSilkDecoder
from opus_tpu_torch.models.hybrid_dec_fused import FusedHybridDecoder

DECODERS = {
    "celt": lambda p: KernelCeltDecoder(3, max_payload=p, device="cpu"),
    "silk": lambda p: FusedSilkDecoder(3, max_payload=p, device="cpu"),
    "hybrid": lambda p: FusedHybridDecoder(3, max_payload=p, device="cpu"),
}


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_torch_decoder_pack_raises_on_oversized_payload(kind):
    dec = DECODERS[kind](100)
    rng = np.random.default_rng(3)
    ok = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in
          (100, 7)]
    buf, lens = dec.pack(ok)
    assert buf.shape == (3, 100) and buf.dtype == torch.uint8
    assert lens.tolist() == [100, 7, 0]
    assert bytes(buf[1, :7].numpy()) == ok[1] and not buf[1, 7:].any()
    with pytest.raises(ValueError, match=r"lane 1: payload of 159 bytes"):
        dec.pack([ok[1], bytes(159)])
    with pytest.raises(ValueError, match="max_payload=100"):
        dec.decode([bytes(101)])
