"""SILK order-16 LPC synthesis over one subframe: kernel K4 and its plain
torch version.

``lpc_subframe`` is the wrapper, with the signature of
``opus_tpu/ops/lpc_pallas.py:lpc_subframe``: a CPU tensor runs
``lpc_subframe_plain``, a CUDA tensor runs the hand-written CUDA kernel
(``opus_tpu_torch/csrc/silk_lpc.cu``: one thread per stream, the block's
streams staged through shared memory, one tap on the per-sample chain)
or raises.  The kernel takes the SILK subframe lengths, sf 40, 60 and
80.  It replaces the Pallas kernel ``opus_tpu/ops/lpc_pallas.py:_kernel``.

The plain version is the ``lax.scan`` branch of
``opus_tpu/models/batched_silk.py:_lpc_subframe`` (decode_core.c:195-216)
as a loop over the subframe's samples of [B]-lane ops.
"""

from __future__ import annotations

import torch

from .silk_fixed import add_sat32, lshift_sat32, w32

ORDER = 16

# launches of kernel K4 (counted where the kernel is launched, only there)
launches = 0


def lpc_subframe_plain(slpc, res, a_rev, order_half: int):
    """slpc [B, 16] state (most recent last), res [B, sf], a_rev [B, 16]
    (int16-valued, reversed coefficients).  Returns (v [B, sf], new slpc
    [B, 16]), int32."""
    b, sf = res.shape
    res = res.to(torch.int64)
    a_rev = a_rev.to(torch.int64)
    hist = torch.cat([slpc.to(torch.int64),
                      torch.zeros((b, sf), dtype=torch.int64,
                                  device=res.device)], dim=1)
    for i in range(sf):
        # SMULWB of an int16 coefficient: the int64 product shifted is
        # value-exact (ops/silk_fixed.smulwb's split form computes the same)
        pred = w32(order_half + ((hist[:, i:i + ORDER] * a_rev) >> 16)
                   .sum(1))
        hist[:, ORDER + i] = add_sat32(res[:, i], lshift_sat32(pred, 4))
    return (hist[:, ORDER:].to(torch.int32),
            hist[:, sf:].to(torch.int32))


def lpc_subframe(slpc, res, a_rev, order_half: int):
    """LPC synthesis of one subframe for B streams (kernel K4 on the
    card)."""
    if res.device.type == "cpu":
        return lpc_subframe_plain(slpc, res, a_rev, order_half)
    return _lpc_subframe_cuda(slpc, res, a_rev, order_half)


def geometry(sf: int = 80) -> dict:
    """K4's launch geometry on the current card at subframe length ``sf``;
    see ``cuda_build.geometry``."""
    from ..cuda_build import geometry as geo

    return geo("opus_silk_lpc_occupancy", sf)


def _int32_aligned(x):
    """x as a contiguous int32 tensor whose data is 16-byte aligned (the
    kernel's vector loads); a view at another offset is copied."""
    x = x.to(torch.int32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _lpc_subframe_cuda(slpc, res, a_rev, order_half: int, lib=None):
    """K4's launch; lib: another build of its source (a profile build),
    else the port's library."""
    import ctypes

    from ..cuda_build import check_launch, library

    global launches
    dev = res.device
    if not res.is_cuda or slpc.device != dev or a_rev.device != dev:
        raise ValueError("lpc_subframe: all inputs on one CUDA device")
    b, sf = res.shape
    if slpc.shape != (b, ORDER) or a_rev.shape != (b, ORDER):
        raise ValueError("lpc_subframe: res [B, sf], slpc/a_rev [B, 16]")
    if sf not in (40, 60, 80):
        raise ValueError("lpc_subframe: the kernel takes sf 40, 60 or 80")
    res, a_rev, slpc = (_int32_aligned(x) for x in (res, a_rev, slpc))
    v = torch.empty_like(res)
    slpc_out = torch.empty_like(slpc)
    vp = ctypes.c_void_p
    rc = (lib or library()).opus_silk_lpc_launch(
        vp(res.data_ptr()), vp(a_rev.data_ptr()), vp(slpc.data_ptr()),
        vp(v.data_ptr()), vp(slpc_out.data_ptr()), b, sf, int(order_half),
        vp(torch.cuda.current_stream(dev).cuda_stream))
    check_launch(rc, "silk_lpc")
    launches += 1
    return v, slpc_out
