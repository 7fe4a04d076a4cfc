"""opus_tpu_torch: the PyTorch/CUDA port of opus_tpu, beside the JAX package.

Layout mirrors ``opus_tpu`` so each counterpart is easy to find:

- ``opus_tpu_torch.ops``     — the [B]-lane range decoder, MDCT bases and the
  de-emphasis IIR (plain torch + CUDA kernel K2).
- ``opus_tpu_torch.models``  — the mono CELT decode symbol pass (plain torch
  twin of kernel K1 + its CUDA wrapper) and the synthesis ``decode_step``.
- ``opus_tpu_torch.csrc``    — the hand-written CUDA sources for sm_90a,
  built at first use by ``opus_tpu_torch.cuda_build``.
- ``opus_tpu_torch.convert`` — carries decoder state and tables across from
  the JAX package.

The package imports torch and numpy, plus the jax-free numpy modules
``opus_tpu.celt.{modes,tables,cwrs}``; it never imports jax.
"""

import torch

# the JAX package runs its float32 matmuls at Precision.HIGHEST; keep TF32
# off so the port's IMDCT/de-emphasis matmuls stay full float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
