"""Writes tests/data/torch_celt20ms_64k_enc.npz: the JAX package's 20 ms
CELT kernel encoder (the CPU twin ``unrolled_encode_frame`` of
``opus_tpu/models/celt_enc_kernel.py``, run eagerly under
``tests/np_shim``) on 8 streams x 8 frames, so that the port's encoder
tests and ``chip_smoke.py`` never have to run the JAX encoder.

Signals: the 8 streams of ``tools/make_torch_fixture.py`` (one has three
frames of digital silence), 48 kHz mono, 160-byte CBR packets (64 kb/s),
encoded as one batch of 8 lanes.  Stored per frame f and stream s:

- ``pcm [S, F, 960]``: the encoder's input;
- ``st_<key> [F, S, ...]``: the encoder state before the frame
  (``fused_celt_enc_init`` layout, per-band lists stacked on the last
  axis);
- ``X [F, S, 800]``, ``in_<key> [F, S, ...]`` and ``fr_<key> [F, S, ...]``:
  the outputs of the JAX ``_front_end`` (the spectrum, the symbol pass's
  ``ins`` dict and the ``front`` dict);
- ``payload [F, S, 160]``, ``rng [F, S]``, ``err [F, S]``: the JAX twin's
  packets, final ranges and error flags;
- ``dec_rng [F, S]``: the scalar decoder's (``opus_tpu/celt/decoder.py``)
  final range on each payload;
- ``snr [S]``: the SNR of the scalar decoder's output of each stream
  against its input (``opus_tpu_torch.quality.best_snr``).

Run from the repository root (a few minutes on one CPU core):
    JAX_PLATFORMS=cpu python tools/make_torch_enc_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_fixture import (FS, FRAME, NSTREAMS, NFRAMES,  # noqa: E402
                                _signal)
from opus_tpu_torch.quality import best_snr                    # noqa: E402

NBYTES = 160
OUT = os.path.join(REPO, "tests", "data", "torch_celt20ms_64k_enc.npz")


def _lanes(v):
    """A [B] lane array, or a list of them (per band), as numpy."""
    if isinstance(v, (list, tuple)):
        return np.stack([np.asarray(x) for x in v], axis=-1)
    return np.asarray(v)


def main():
    from tests.np_shim import install, uninstall
    import opus_tpu.models.celt_enc_kernel as EK
    import opus_tpu.models.celt_enc_fused as EF
    import opus_tpu.ops.rc_enc_kernel as RCE
    from opus_tpu.celt.decoder import CeltDecoder

    t_start = time.time()
    pcm = np.stack([_signal(s) for s in range(NSTREAMS)]).astype(
        np.float32).reshape(NSTREAMS, NFRAMES, FRAME)
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
            print(f"frame {f}: {time.time() - t0:.1f} s", flush=True)
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

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, pcm=pcm, dec_rng=dec_rng, snr=snr, **rec)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t_start:.0f} s; SNR {np.round(snr, 2).tolist()}; "
          f"errors {int(rec['err'].sum())}")


if __name__ == "__main__":
    main()
