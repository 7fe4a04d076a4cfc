"""Weight-blob parser/writer and dequantizers: port of
``opus_tpu/dnn/weights.py`` (reference: dnn/parse_lpcnet_weights.c,
dnn/write_lpcnet_weights.c, dnn/nnet.h:43-63).

A model file is a stream of 64-byte ``WeightHead`` records ("DNNw",
version, type, size, block_size, name[44]), each followed by
``block_size`` bytes of payload: float32, int32, qweight (int8 in 8x4
blocks) or int8.  Parsing and dequantizing are numpy on the host; every
int8 or block-sparse format becomes a dense float32 [nb_inputs,
nb_outputs] tensor on the device the caller names, so the layers only
ever see dense matmuls.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np
import torch

from .nnet import Conv2d, Linear, np_linear

WEIGHT_BLOCK_SIZE = 64
WEIGHT_BLOB_VERSION = 0
WEIGHT_TYPE_FLOAT = 0
WEIGHT_TYPE_INT = 1
WEIGHT_TYPE_QWEIGHT = 2
WEIGHT_TYPE_INT8 = 3

SPARSE_BLOCK_SIZE = 32          # (parse_lpcnet_weights.c:37)

_HEAD = struct.Struct("<4siiii44s")

_DTYPES = {
    WEIGHT_TYPE_FLOAT: np.dtype("<f4"),
    WEIGHT_TYPE_INT: np.dtype("<i4"),
    WEIGHT_TYPE_QWEIGHT: np.dtype("<i1"),
    WEIGHT_TYPE_INT8: np.dtype("<i1"),
}


class WeightArray(NamedTuple):
    name: str
    type: int
    data: np.ndarray        # 1-D, dtype per type


def parse_blob(data: bytes) -> dict[str, WeightArray]:
    """(reference: parse_weights parse_lpcnet_weights.c:56).  Raises
    ValueError on a malformed stream, where the C parser returns -1."""
    out: dict[str, WeightArray] = {}
    pos, n = 0, len(data)
    while pos < n:
        if n - pos < WEIGHT_BLOCK_SIZE:
            raise ValueError("truncated weight head")
        head, version, wtype, size, block_size, name = _HEAD.unpack_from(
            data, pos)
        if head != b"DNNw" or version != WEIGHT_BLOB_VERSION:
            raise ValueError(f"bad weight head at {pos}")
        if size < 0 or block_size < size \
                or block_size > n - pos - WEIGHT_BLOCK_SIZE:
            raise ValueError(f"bad weight sizes at {pos}")
        if name[-1:] != b"\x00":
            raise ValueError("unterminated weight name")
        sname = name.split(b"\x00")[0].decode("ascii")
        if wtype not in _DTYPES:
            raise ValueError(f"unknown weight type {wtype}")
        payload = data[pos + WEIGHT_BLOCK_SIZE:pos + WEIGHT_BLOCK_SIZE + size]
        out[sname] = WeightArray(
            sname, wtype, np.frombuffer(payload, dtype=_DTYPES[wtype]).copy())
        pos += WEIGHT_BLOCK_SIZE + block_size
    return out


def write_blob(arrays: list[WeightArray]) -> bytes:
    """(reference: write_weights write_lpcnet_weights.c:54)"""
    out = bytearray()
    for a in arrays:
        raw = np.ascontiguousarray(a.data, dtype=_DTYPES[a.type]).tobytes()
        size = len(raw)
        block = (size + WEIGHT_BLOCK_SIZE - 1) \
            // WEIGHT_BLOCK_SIZE * WEIGHT_BLOCK_SIZE
        name = a.name.encode("ascii")
        if len(name) > 43:
            raise ValueError(f"name too long: {a.name}")
        out += _HEAD.pack(b"DNNw", WEIGHT_BLOB_VERSION, a.type, size, block,
                          name)
        out += raw + b"\x00" * (block - size)
    return bytes(out)


def deblock_dense(w: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Un-blocks the 8x4 gemv layout into [rows, cols] (out-major)
    (reference: cgemv8x4 dnn/vec.h:283: block (i, j) holds
    w[r*4+c] = W[i+r, j+c])."""
    w = w.reshape(rows // 8, cols // 4, 8, 4)
    return w.transpose(0, 2, 1, 3).reshape(rows, cols)


def deblock_sparse(w: np.ndarray, idx: np.ndarray, rows: int, cols: int,
                   col_major_blocks: bool) -> np.ndarray:
    """Expands the block-sparse stream into dense [rows, cols]: per 8-row
    block a count, then that many 4-aligned column positions, 32 weights
    a block.  Float blocks are column-major w[c*8+r] (sparse_sgemv8x4
    dnn/vec.h:124); int8 blocks row-major w[r*4+c] (sparse_cgemv8x4
    dnn/vec.h:249)."""
    out = np.zeros((rows, cols), np.float32)
    ip = wp = 0
    for i in range(0, rows, 8):
        nb = int(idx[ip])
        ip += 1
        for _ in range(nb):
            pos = int(idx[ip])
            ip += 1
            raw = w[wp:wp + 32]
            wp += 32
            blk = raw.reshape(4, 8).T if col_major_blocks \
                else raw.reshape(8, 4)
            out[i:i + 8, pos:pos + 4] += blk
    return out


def linear_params(arrays: dict[str, WeightArray], *,
                  bias: Optional[str] = None,
                  subias: Optional[str] = None,
                  weights: Optional[str] = None,
                  float_weights: Optional[str] = None,
                  weights_idx: Optional[str] = None,
                  diag: Optional[str] = None,
                  scale: Optional[str] = None,
                  nb_inputs: int, nb_outputs: int, device) -> Linear:
    """A dense Linear on ``device`` from blob arrays, as linear_init
    (parse_lpcnet_weights.c:133) but with int8 and sparse formats
    dequantized to dense float32; the matrix is [nb_inputs, nb_outputs],
    ready for ``x @ w``."""
    def get(name, dtype=None):
        if name is None:
            return None
        if name not in arrays:
            raise KeyError(f"missing weight array {name}")
        a = arrays[name].data
        return a if dtype is None else a.astype(dtype)

    b = get(bias, np.float32)
    d = get(diag, np.float32)
    idx = get(weights_idx)
    if float_weights is not None:
        fw = get(float_weights, np.float32)
        if idx is not None:
            dense = deblock_sparse(fw, idx, nb_outputs, nb_inputs,
                                   col_major_blocks=True)
        else:
            # stored column-major [cols=nb_inputs][rows=nb_outputs]
            dense = fw.reshape(nb_inputs, nb_outputs).T
    elif weights is not None:
        w8 = get(weights).astype(np.float32)
        sc = get(scale, np.float32)
        if sc is None:
            raise ValueError("int8 weights need a scale array")
        if idx is not None:
            dense = deblock_sparse(w8, idx, nb_outputs, nb_inputs,
                                   col_major_blocks=False)
        else:
            dense = deblock_dense(w8, nb_outputs, nb_inputs)
        # cgemv8x4 computes scale[i] * sum_j w8[i,j]*round(127*x[j]): the
        # dequantized float equivalent folds 127*scale into the row
        dense = dense * (127.0 * sc)[:, None]
    else:
        dense = np.zeros((nb_outputs, nb_inputs), np.float32)
    get(subias)   # the SU-arch bias variant: checked present, unused here
    return np_linear(np.ascontiguousarray(dense.T), b, d, device=device)


def conv2d_params(arrays: dict[str, WeightArray], *,
                  bias: Optional[str] = None, float_weights: str,
                  in_channels: int, out_channels: int, ktime: int,
                  kheight: int, device) -> Conv2d:
    """(reference: conv2d_init parse_lpcnet_weights.c; kernel layout
    [out_ch, in_ch, ktime, kheight], nnet_arch.h:162)"""
    w = arrays[float_weights].data.astype(np.float32).reshape(
        out_channels, in_channels, ktime, kheight)
    b = None if bias is None else torch.as_tensor(
        arrays[bias].data.astype(np.float32), device=device)
    return Conv2d(torch.as_tensor(w, device=device), b)


def linear_to_arrays(name: str, lin: Linear) -> list[WeightArray]:
    """A float Linear as blob arrays ``<name>_weights_float`` (the [M, N]
    matrix row-major, which is the reference's column-major layout) and
    ``<name>_bias`` where it has one; ``linear_params`` reads them back."""
    out = [WeightArray(f"{name}_weights_float", WEIGHT_TYPE_FLOAT,
                       lin.w.detach().cpu().numpy().astype(np.float32)
                       .reshape(-1))]
    if lin.bias is not None:
        out.append(WeightArray(f"{name}_bias", WEIGHT_TYPE_FLOAT,
                               lin.bias.detach().cpu().numpy()
                               .astype(np.float32)))
    return out
