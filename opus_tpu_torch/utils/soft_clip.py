"""Soft clipping for float -> int16 conversion, per lane.

Copy of ``opus_tpu/utils/soft_clip.py`` (``pcm_soft_clip``,
``float2int16``; reference: src/opus.c opus_pcm_soft_clip_impl,
celt/float_cast.h FLOAT2INT16) for the PyTorch port, which imports
nothing of the JAX package, and its batched form ``soft_clip_lanes``:
B mono lanes, each with its own ``softclip_mem``, on the lanes' device.

The batched form runs the scalar's steps on whole lanes at once.  The
scalar walks the frame segment by segment: a segment is a run of samples
of one sign (zeros join either side) around a sample beyond +-1, and it
applies x + a x^2 to it, a from the segment's peak.  Segments do not
overlap (but for the zeros between two of them, which the non-linearity
keeps at zero), so each run of one sign is a segment, its ``a`` a
reduction over the run, and a lane's runs all take their ``a`` at once.
The previous frame's curve, carried up to the first zero crossing, is a
prefix mask; the ramp of a segment that starts the frame repeats a float32
subtraction sample by sample, so it runs as a loop over the samples up
to the furthest such peak, over every lane at once.  Every output sample
is the scalar's bit for bit (a zero's sign aside).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def pcm_soft_clip(x: np.ndarray, channels: int,
                  declip_mem: np.ndarray) -> np.ndarray:
    """In-place soft clip of interleaved float32 PCM.

    x: float32 array of length N*channels (interleaved).
    declip_mem: float32 array [channels], persistent across calls.
    Returns x (modified in place).
    """
    if channels < 1 or x.size < 1:
        return x
    assert x.dtype == np.float32
    n = x.size // channels
    # Domain clamp: the non-linearity's derivative is zero outside [-2, 2],
    # so clamping there introduces no discontinuity.
    np.clip(x, F32(-2.0), F32(2.0), out=x)
    for c in range(channels):
        ch = x[c::channels]
        a = F32(declip_mem[c])
        # Keep applying the previous frame's non-linearity until the signal
        # crosses zero, so the curve stays continuous across the boundary.
        for i in range(n):
            if ch[i] * a >= 0:
                break
            ch[i] = ch[i] + a * ch[i] * ch[i]
        curr = 0
        x0 = ch[0]
        while True:
            over = np.nonzero(np.abs(ch[curr:]) > F32(1.0))[0]
            if over.size == 0:
                a = F32(0.0)
                break
            i = curr + int(over[0])
            peak_pos = i
            start = end = i
            maxval = abs(ch[i])
            while start > 0 and ch[i] * ch[start - 1] >= 0:
                start -= 1
            while end < n and ch[i] * ch[end] >= 0:
                if abs(ch[end]) > maxval:
                    maxval = abs(ch[end])
                    peak_pos = end
                end += 1
            special = start == 0 and ch[i] * ch[0] >= 0
            # a such that maxval + a*maxval^2 == 1 (tiny boost keeps the
            # result strictly inside +/-1 under -ffast-math in the ref).
            a = (maxval - F32(1.0)) / (maxval * maxval)
            a = a + a * F32(2.4e-7)
            if ch[i] > 0:
                a = -a
            seg = ch[start:end]
            ch[start:end] = seg + a * seg * seg
            if special and peak_pos >= 2:
                # Ramp from the frame's first sample to the peak to avoid a
                # discontinuity at the frame start.
                offset = x0 - ch[0]
                delta = offset / F32(peak_pos)
                for j in range(curr, peak_pos):
                    offset = offset - delta
                    v = ch[j] + offset
                    ch[j] = min(F32(1.0), max(F32(-1.0), v))
            curr = end
            if curr == n:
                break
        declip_mem[c] = a
    return x


def float2int16(x: np.ndarray) -> np.ndarray:
    """FLOAT2INT16 (reference: celt/float_cast.h): scale, saturate, round."""
    y = np.asarray(x, dtype=np.float32) * F32(32768.0)
    y = np.clip(y, F32(-32768.0), F32(32767.0))
    return np.round(y).astype(np.int16)


def soft_clip_lanes(pcm, mem, n=None):
    """``pcm_soft_clip`` on B mono lanes: pcm [B, N] float32, mem [B]
    float32 (each lane's ``softclip_mem``), n ([B] numpy, default N):
    lane i's samples are pcm[i, :n[i]]; a lane with n = 0 keeps its
    memory.  Returns (the clipped pcm, the new mem); samples past n[i] are
    clamped to [-2, 2] only."""
    b, w = pcm.shape
    dev = pcm.device
    if w == 0:
        return pcm.to(torch.float32), mem
    n = np.full(b, w, np.int64) if n is None else np.asarray(n, np.int64)
    nt = torch.as_tensor(n, device=dev)
    pos = torch.arange(w, device=dev)
    valid = pos[None, :] < nt[:, None]
    one = torch.ones((), dtype=torch.float32, device=dev)
    x = pcm.to(torch.float32).clamp(-2.0, 2.0)
    mem = mem.to(torch.float32)
    # the previous frame's curve up to the first zero crossing
    a0 = mem[:, None]
    carry = valid & ((x * a0 < 0) | ~valid).cumprod(1).bool()
    x = torch.where(carry, x + a0 * x * x, x)
    x0 = x[:, :1]
    # runs of one sign, zeros joining the run before them
    sgn = torch.sign(x).to(torch.int64)
    nz = valid & (sgn != 0)
    last = torch.where(nz, pos[None, :], -1).cummax(1).values
    before = torch.cat([torch.full((b, 1), -1, dtype=torch.int64,
                                   device=dev), last[:, :-1]], 1)
    prev_sgn = sgn.gather(1, before.clamp(min=0))
    run = (nz & (before >= 0) & (sgn != prev_sgn)).cumsum(1)
    flat = (torch.arange(b, device=dev)[:, None] * w + run).flatten()
    mag = torch.where(valid, x.abs(), 0.0).flatten()
    peak = torch.zeros(b * w, dtype=torch.float32, device=dev)
    peak = peak.scatter_reduce(0, flat, mag, "amax")
    side = torch.zeros(b * w, dtype=torch.int64, device=dev).scatter_add(
        0, flat, torch.where(valid, sgn, 0).flatten())
    # each run's a: its peak to +-1
    a = (peak - one) / (peak * peak)
    a = a + a * torch.tensor(np.float32(2.4e-7), device=dev)
    a = torch.where(peak > one, torch.where(side > 0, -a, a), 0.0)
    seg = (peak > one)[flat].view(b, w) & valid
    ar = a[flat].view(b, w)
    y = torch.where(seg, x + ar * x * x, x)
    # a segment that starts the frame: ramp from the first sample to its
    # peak (the scalar's ``special`` case)
    p0 = peak.view(b, w)[:, 0]
    first = seg[:, 0] & (run[:, 0] == 0)
    at_peak = (run == 0) & valid & (x.abs() == p0[:, None])
    ppos = torch.where(at_peak, pos[None, :], w).min(1).values
    ramp = first & (ppos >= 2)
    steps = int(torch.where(ramp, ppos, 0).max()) if b else 0
    if steps:
        off = (x0 - y[:, :1])[:, 0]
        delta = off / ppos.to(torch.float32)
        offs = torch.empty((b, steps), dtype=torch.float32, device=dev)
        for j in range(steps):
            off = off - delta
            offs[:, j] = off
        span = ramp[:, None] & (pos[None, :steps] < ppos[:, None])
        y[:, :steps] = torch.where(
            span, (y[:, :steps] + offs).clamp(-1.0, 1.0), y[:, :steps])
    # the memory: the last segment's a if it runs to the frame's end
    end = (nt - 1).clamp(min=0)
    a_end = a.view(b, w).gather(1, run.gather(1, end[:, None]))[:, 0]
    mem = torch.where(nt > 0, a_end, mem)
    return y, mem


def float2int16_lanes(x):
    """FLOAT2INT16 on a tensor: scale by 32768 in float32, saturate, round
    half to even (as numpy's ``round``) -> int16."""
    y = x.to(torch.float32) * 32768.0
    return torch.round(y.clamp(-32768.0, 32767.0)).to(torch.int16)
