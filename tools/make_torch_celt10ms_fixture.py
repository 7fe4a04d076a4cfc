"""Writes the 10 ms (LM 2) CELT fixtures of the port's tests and of
``chip_smoke.py``'s 10 ms phase, from the JAX package:

- ``tests/data/torch_celt10ms_64k.npz``: 8 streams x 8 frames of 48 kHz
  mono encoded by the scalar ``OpusEncoder(48000, 1,
  "restricted-lowdelay")`` at 64 kb/s CBR, 480 samples a frame (80-byte
  packets: the TOC byte and a 79-byte CELT frame), and the scalar
  decoder's (bit-exact with libopus) final range, band energies at
  synthesis and float PCM per frame.  Fields as
  ``tests/data/torch_celt20ms_64k.npz`` (``tools/make_torch_fixture.py``):
  ``frames [S, F, 80]``, ``lens``, ``final_range``, ``energies``,
  ``pcm [S, F, 480]``;
- ``tests/data/torch_celt10ms_64k_enc.npz``: the JAX kernel encoder's CPU
  twin (``unrolled_encode_frame`` of ``opus_tpu/models/celt_enc_kernel.py``,
  run eagerly under ``tests/np_shim``) at 480 samples and 80 bytes on the
  same signals, with the fields of ``tests/data/torch_celt20ms_64k_enc.npz``
  (``tools/make_torch_enc_fixture.py``): ``pcm``, ``st_*``, ``X``,
  ``in_*``, ``fr_*``, ``payload``, ``rng``, ``err``, ``dec_rng`` (the
  scalar decoder's final range on each payload) and ``snr``.

Signals: the first 80 ms of the 8 streams of ``tools/make_torch_fixture.py``
(stream 3 is digital silence from 40 ms on).

Run from the repository root (a few minutes on one CPU core; the JAX
encoder is the slow part):
    JAX_PLATFORMS=cpu python tools/make_torch_celt10ms_fixture.py
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_enc_fixture import _lanes                       # noqa: E402
from make_torch_fixture import FS, NFRAMES, NSTREAMS, _signal   # noqa: E402
from opus_tpu_torch.quality import best_snr                     # noqa: E402

FRAME = 480
NBYTES = 80
OUT_DEC = os.path.join(REPO, "tests", "data", "torch_celt10ms_64k.npz")
OUT_ENC = os.path.join(REPO, "tests", "data", "torch_celt10ms_64k_enc.npz")


def signals() -> np.ndarray:
    """[S, F, 480] float64: the first F x 480 samples of each stream."""
    return np.stack([_signal(s)[:NFRAMES * FRAME] for s in
                     range(NSTREAMS)]).reshape(NSTREAMS, NFRAMES, FRAME)


def write_decode_fixture(sig):
    from opus_tpu.bitstream import packet as pkt
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.models.opus_encoder import OpusEncoder
    import opus_tpu.celt.decoder as cdec

    toc = (28 + int(math.log2(FRAME // 120))) << 3   # CELT-only FB, 10 ms
    frames = np.zeros((NSTREAMS, NFRAMES, NBYTES), np.uint8)
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
            enc = OpusEncoder(FS, 1, application="restricted-lowdelay")
            enc.set_bitrate(64000)
            enc.set_vbr(0)
            dec = OpusDecoder(FS, 1)
            for f in range(NFRAMES):
                p = enc.encode(sig[s, f], FRAME)
                assert pkt.packet_get_mode(p) == pkt.Mode.CELT_ONLY
                assert p[0] == toc, (s, f, p[0])
                celt = pkt.packet_parse(p).frames[0]
                assert len(p) == NBYTES, (s, f, len(p))
                frames[s, f, :len(celt)] = np.frombuffer(celt, np.uint8)
                lens[s, f] = len(celt)
                cur.clear()
                out = np.asarray(dec.decode(bytes([toc]) + celt))
                pcm[s, f] = out.reshape(-1)[:FRAME]
                final_range[s, f] = dec.celt.rng
                energies[s, f] = cur.get("energies", np.full(21, -28.0))
    finally:
        cdec.CeltDecoder._synthesis = orig_syn
    np.savez_compressed(OUT_DEC, frames=frames, lens=lens,
                        final_range=final_range, energies=energies, pcm=pcm)
    print(f"wrote {OUT_DEC}: {os.path.getsize(OUT_DEC)} bytes")


def write_encode_fixture(sig):
    from tests.np_shim import install, uninstall
    import opus_tpu.models.celt_enc_kernel as EK
    import opus_tpu.models.celt_enc_fused as EF
    import opus_tpu.ops.rc_enc_kernel as RCE
    from opus_tpu.celt.decoder import CeltDecoder

    pcm = sig.astype(np.float32)
    rec = {}

    def put(key, f, val):
        arr = _lanes(val)
        if key not in rec:
            rec[key] = np.zeros((NFRAMES,) + arr.shape, arr.dtype)
        rec[key][f] = arr

    mods = install(extra_modules=[EK, EF, RCE])
    orig_front = EK._front_end
    cur = {}

    def front_spy(*args, **kw):
        out = orig_front(*args, **kw)
        cur["front"] = out
        return out

    EK._front_end = front_spy
    try:
        tabs = EK.ETabs(FS, FRAME)
        state = EF.fused_celt_enc_init(NSTREAMS, tabs.enc)
        for f in range(NFRAMES):
            t0 = time.time()
            for k, v in state.items():
                put("st_" + k, f, v)
            payload, rngv, err, state = EK.unrolled_encode_frame(
                pcm[:, f], state, tabs, NBYTES)
            _e, _dig, _end, ins, X, front = cur["front"]
            put("X", f, X)
            for k, v in ins.items():
                put("in_" + k, f, v)
            for k, v in front.items():
                if k == "sp_new":
                    for k2, v2 in v.items():
                        put("fr_sp_" + k2, f, v2)
                else:
                    put("fr_" + k, f, v)
            put("payload", f, np.asarray(payload, np.uint8))
            put("rng", f, np.asarray(rngv).astype(np.uint32))
            put("err", f, np.asarray(err).astype(np.int32))
            print(f"encode frame {f}: {time.time() - t0:.1f} s", flush=True)
    finally:
        EK._front_end = orig_front
        uninstall(mods)

    dec_rng = np.zeros((NFRAMES, NSTREAMS), np.uint32)
    snr = np.zeros(NSTREAMS, np.float64)
    for s in range(NSTREAMS):
        dec = CeltDecoder.create(FS, 1)
        outs = []
        for f in range(NFRAMES):
            out = np.zeros(FRAME)
            ret = dec.decode_with_ec(bytes(rec["payload"][f, s].tobytes()),
                                     out, FRAME, None)
            assert ret == FRAME, (s, f, ret)
            dec_rng[f, s] = int(dec.rng) & 0xFFFFFFFF
            outs.append(out.copy())
        snr[s] = best_snr(pcm[s].reshape(-1), np.concatenate(outs), FRAME)
    assert np.array_equal(dec_rng, rec["rng"]), "scalar decoder disagrees"
    np.savez_compressed(OUT_ENC, pcm=pcm, dec_rng=dec_rng, snr=snr, **rec)
    print(f"wrote {OUT_ENC}: {os.path.getsize(OUT_ENC)} bytes; SNR "
          f"{np.round(snr, 2).tolist()}; errors {int(rec['err'].sum())}")


def main():
    t0 = time.time()
    sig = signals()
    os.makedirs(os.path.dirname(OUT_DEC), exist_ok=True)
    write_decode_fixture(sig)
    write_encode_fixture(sig)
    print(f"done in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
