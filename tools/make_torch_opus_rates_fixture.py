"""Writes tests/data/torch_opus_rates.npz: the JAX package's scalar
``OpusDecoder(fs, channels)`` at 8, 12, 16 and 24 kHz over the packets of
tests/data/torch_opus_api.npz and tests/data/torch_opus_stereo.npz, the
reference of the port's ``BatchedOpusDecoder(fs=...)``
(tests/test_torch_opus_rates.py, chip_smoke.py's opus_rates phase).  It
reads opus_tpu and never edits it.

The cases (``CASES``): the api fixture's 8 mono streams at one output
channel, the stereo fixture's 8 streams at one and at two, each at every
rate: 12 decoders a stream.  Each decodes the source fixture's steps as
its own test does at 48 kHz: the api fixture's packets (None where lost),
the stereo fixture's opus_demo ``-inbandfec`` steps (``decode_fec`` with
the lost duration, scaled from 48 kHz samples to the rate).

Stored per case ``{src}{khz}_{c}`` (src ``api`` or ``st``) and step
[S, T] (T the source's steps, padded): ``_rng`` (``rangeFinal``),
``_n`` (samples per channel; -1 past the stream's end), ``_celt`` (the
scalar CELT decoder's calls during the step: 0 means the output is
SILK's int16 / 32768 exactly), ``_d16`` and ``_d24`` [S, T, 16] (uint8
BLAKE2b digests of ``decode_int16``'s output, the soft clip's memory
carried from step to step, and of ``decode24``'s, both interleaved and
little-endian, computed from one ``decode`` call each step as those two
functions compute them), ``_pcm24`` (int32, ``decode24``'s output of the
steps with a CELT part, in a row; ``_off`` [S, T] their offsets): it
holds the float output to 2^-24, which the tests' float bound (1e-4)
does not see; and ``_pcm`` (float32, the first ``FLOAT_STEPS`` steps of
every stream, ``_foff`` their offsets).  The file stays near 1 MB.

Run from the repository root (~1 min, 8 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_opus_rates_fixture.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_opus_rates.npz")
API = os.path.join(REPO, "tests", "data", "torch_opus_api.npz")
STEREO = os.path.join(REPO, "tests", "data", "torch_opus_stereo.npz")
RATES = (8000, 12000, 16000, 24000)
CASES = [("api", fs, 1) for fs in RATES] + [
    ("st", fs, c) for fs in RATES for c in (1, 2)]
FLOAT_STEPS = 2


def steps(src: str, fs: int):
    """The source fixture's streams as steps (packet or None, fec,
    frame_size at fs or None)."""
    fx = np.load(API if src == "api" else STEREO)
    plen, buf = fx["plen"], fx["packets"]
    out = []
    for s in range(plen.shape[0]):
        row = []
        for t in range(plen.shape[1]):
            if plen[s, t] == -2:
                continue
            p = None if plen[s, t] == -1 else bytes(buf[s, t, :plen[s, t]])
            fec = src == "st" and bool(fx["fec"][s, t])
            size = int(fx["fsize"][s, t]) if src == "st" else 0
            row.append((p, fec, size * fs // 48000 or None))
        out.append(row)
    return out


def digest(x: np.ndarray) -> np.ndarray:
    """A step's output as 16 BLAKE2b bytes (little-endian samples)."""
    import hashlib
    h = hashlib.blake2b(np.ascontiguousarray(x).astype(
        x.dtype.newbyteorder("<")).tobytes(), digest_size=16)
    return np.frombuffer(h.digest(), np.uint8)


def decode_case(job):
    """One case on one stream: per step the range, sample count, CELT
    calls, int16 and 24-bit output (and float for the first steps)."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.utils.soft_clip import float2int16, pcm_soft_clip

    src, fs, c, s = job
    row = steps(src, fs)[s]
    dec = OpusDecoder(fs, c)
    calls = [0]
    celt_dec = dec.celt.decode_with_ec

    def spy(*a, **kw):
        calls[0] += 1
        return celt_dec(*a, **kw)
    dec.celt.decode_with_ec = spy
    res = dict(rng=[], n=[], celt=[], pcm16=[], pcm24=[], pcm=[])
    for t, (p, fec, size) in enumerate(row):
        calls[0] = 0
        x = np.asarray(dec.decode(p, size, decode_fec=fec))
        # decode_int16 and decode24 (opus_decoder.py:177-197) on this
        # call's output
        x16 = x.astype(np.float32)
        pcm_soft_clip(x16, c, dec.softclip_mem)
        res["pcm16"].append(float2int16(x16))
        res["pcm24"].append(np.clip(np.rint(x.astype(np.float64)
                                            * 8388608.0), -(1 << 31),
                                    (1 << 31) - 1).astype(np.int32))
        if t < FLOAT_STEPS:
            res["pcm"].append(x.astype(np.float32))
        res["rng"].append(dec.rangeFinal)
        res["n"].append(len(x) // c)
        res["celt"].append(calls[0])
    return job, res


def main() -> int:
    t0 = time.time()
    jobs = [(src, fs, c, s) for src, fs, c in CASES for s in range(8)]
    with mp.get_context("spawn").Pool(8) as pool:
        got = dict(pool.map(decode_case, jobs))
    out = {}
    for src, fs, c in CASES:
        key = f"{src}{fs // 1000}_{c}"
        rows = [got[(src, fs, c, s)] for s in range(8)]
        shape = (8, max(len(r["rng"]) for r in rows))
        rng = np.zeros(shape, np.int64)
        n = np.full(shape, -1, np.int64)
        celt = np.zeros(shape, np.int64)
        off = np.zeros(shape, np.int64)
        foff = np.zeros(shape, np.int64)
        d16 = np.zeros(shape + (16,), np.uint8)
        d24 = np.zeros(shape + (16,), np.uint8)
        pcm24, pcm = [], []
        pos = fpos = 0
        for s, r in enumerate(rows):
            for t in range(len(r["rng"])):
                rng[s, t], n[s, t], celt[s, t] = (r["rng"][t], r["n"][t],
                                                  r["celt"][t])
                d16[s, t] = digest(r["pcm16"][t])
                d24[s, t] = digest(r["pcm24"][t])
                off[s, t] = pos
                if celt[s, t]:
                    pcm24.append(r["pcm24"][t])
                    pos += len(r["pcm24"][t])
                if t < FLOAT_STEPS:
                    foff[s, t] = fpos
                    pcm.append(r["pcm"][t])
                    fpos += len(r["pcm"][t])
        out.update({f"{key}_rng": rng, f"{key}_n": n, f"{key}_celt": celt,
                    f"{key}_off": off, f"{key}_foff": foff,
                    f"{key}_d16": d16, f"{key}_d24": d24,
                    f"{key}_pcm24": np.concatenate(pcm24).astype(np.int32),
                    f"{key}_pcm": np.concatenate(pcm).astype(np.float32)})
        print(f"{key}: {int((n >= 0).sum())} steps, "
              f"{int(((celt == 0) & (n >= 0)).sum())} without CELT, "
              f"{pos} samples with")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
