"""opus_tpu_torch: the PyTorch/CUDA port of opus_tpu, beside the JAX package.

Layout mirrors ``opus_tpu`` so each counterpart is easy to find:

- ``opus_tpu_torch.celt``    — the port's own copies of the CELT mode
  tables (``modes``, ``tables``, ``cwrs``).
- ``opus_tpu_torch.silk``    — the port's own copies of the SILK tables
  (``tables``, ``tables_data``).
- ``opus_tpu_torch.ops``     — the [B]-lane range decoder and encoder, the
  MDCT bases, the de-emphasis IIR (plain torch + CUDA kernel K2), the
  SILK fixed-point macros and the SILK LPC synthesis (plain torch + CUDA
  kernel K4).
- ``opus_tpu_torch.models``  — the mono CELT decode symbol pass (plain torch
  twin of kernel K1 + its CUDA wrapper), the synthesis ``decode_step``,
  the encoder's analysis front end and encode symbol pass (plain torch
  twin of kernel K3 + its CUDA wrapper), the SILK decoder (symbol pass,
  NLSF -> LPC and decode_core; OSCE enhancement by ``set_osce``), the
  hybrid decoder.
- ``opus_tpu_torch.dnn``     — the neural layer runtime, weight blobs, the
  DRED RDOVAE networks, the FARGAN vocoder, the DRED payload decode and
  decoder objects, the LPCNet feature analysis, the pitch DNN, the
  deep-PLC state machine and OSCE (its adaptive filters, features, LACE
  and NoLACE); ``models.batched_dnn`` and
  ``models.dnn_recovery`` run them over a stream batch (DRED loss
  recovery), ``models.deep_plc`` conceals with DRED as FEC (deep PLC).
- ``opus_tpu_torch.bitstream`` — the host-side range decoder, Laplace
  decoder, packet and extension parsers that the DRED parse reaches.
- ``opus_tpu_torch.csrc``    — the hand-written CUDA sources for sm_90a,
  built at first use by ``opus_tpu_torch.cuda_build``.
- ``opus_tpu_torch.convert`` — carries encoder and decoder state and tables
  across from the JAX package.

The package imports torch and numpy only: nothing of jax and nothing of
the JAX package ``opus_tpu``.
"""

import torch

# the JAX package runs its float32 matmuls at Precision.HIGHEST; keep TF32
# off so the port's IMDCT, de-emphasis and DNN matmuls stay full float32 on
# the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
