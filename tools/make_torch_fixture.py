"""Writes tests/data/torch_celt20ms_64k.npz: real 20 ms CELT packets and the
scalar decoder's outputs for them, the packet source and oracle that
chip_smoke.py and the port's tests use where the JAX package is absent.

8 streams x 8 frames of 48 kHz mono, encoded by the scalar
OpusEncoder(48000, 1, "restricted-lowdelay") at 64 kb/s CBR (160-byte
packets).  Each stream is the tests/test_celt_dec_fused._encode_frames
signal with its own seed, pitch and amplitude, noise bursts for
transients, and one stream has three frames of digital silence.  The scalar decoder
(bit-exact with libopus, COMPONENTS.md) gives per frame the final range,
the band energies at synthesis and the float PCM.

Run from the repository root:  python tools/make_torch_fixture.py
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opus_tpu.bitstream import packet as pkt            # noqa: E402
from opus_tpu.models.opus_decoder import OpusDecoder    # noqa: E402
from opus_tpu.models.opus_encoder import OpusEncoder    # noqa: E402
import opus_tpu.celt.decoder as cdec                    # noqa: E402

FS = 48000
FRAME = 960
NSTREAMS = 8
NFRAMES = 8
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "torch_celt20ms_64k.npz")


def _signal(stream: int) -> np.ndarray:
    rng = np.random.default_rng(100 + stream)
    t = np.arange(FRAME * NFRAMES) / FS
    f0 = 180.0 + 55.0 * stream
    amp = 0.15 + 0.04 * stream
    sig = amp * np.sin(2 * np.pi * f0 * t) \
        * (1 + 0.3 * np.sin(2 * np.pi * 3 * t)) \
        + 0.1 * np.sin(2 * np.pi * (1870 + 97 * stream) * t)
    for _ in range(2 + stream % 4):
        p0 = int(rng.integers(0, len(t) - 500))
        sig[p0:p0 + 400] += 0.5 * rng.standard_normal(400) * np.hanning(400)
    if stream == 3:
        sig[2 * FRAME:5 * FRAME] = 0.0          # silent frames
    return np.clip(sig, -1, 1)


def main():
    toc = (28 + int(math.log2(FRAME // 120))) << 3   # CELT-only FB, 20 ms
    frames = np.zeros((NSTREAMS, NFRAMES, 160), np.uint8)
    lens = np.zeros((NSTREAMS, NFRAMES), np.int32)
    final_range = np.zeros((NSTREAMS, NFRAMES), np.uint32)
    energies = np.zeros((NSTREAMS, NFRAMES, 21), np.float32)
    pcm = np.zeros((NSTREAMS, NFRAMES, FRAME), np.float32)

    cur = {}
    orig_syn = cdec.CeltDecoder._synthesis

    def syn_spy(self, X, oldBandE, *args, **kw):
        cur["energies"] = np.array(oldBandE[:self.mode.nbEBands])
        return orig_syn(self, X, oldBandE, *args, **kw)

    cdec.CeltDecoder._synthesis = syn_spy
    try:
        for s in range(NSTREAMS):
            sig = _signal(s)
            enc = OpusEncoder(FS, 1, application="restricted-lowdelay")
            enc.set_bitrate(64000)
            enc.set_vbr(0)
            dec = OpusDecoder(FS, 1)
            for f in range(NFRAMES):
                p = enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME)
                assert pkt.packet_get_mode(p) == pkt.Mode.CELT_ONLY
                celt = pkt.packet_parse(p).frames[0]
                frames[s, f, :len(celt)] = np.frombuffer(celt, np.uint8)
                lens[s, f] = len(celt)
                cur.clear()
                out = np.asarray(dec.decode(bytes([toc]) + celt))
                pcm[s, f] = out.reshape(-1)[:FRAME]
                final_range[s, f] = dec.celt.rng
                energies[s, f] = cur.get("energies", np.full(21, -28.0))
    finally:
        cdec.CeltDecoder._synthesis = orig_syn

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, frames=frames, lens=lens,
                        final_range=final_range, energies=energies, pcm=pcm)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes; lens "
          f"{sorted(set(lens.reshape(-1).tolist()))}")


if __name__ == "__main__":
    main()
