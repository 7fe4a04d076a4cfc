"""The port's DRED encoder (opus_tpu_torch/dnn/dred_enc.py, dnn/dred.py's
encoder half, models/dred_encoder.py and the bitstream writers it needs)
against the JAX package on the CPU.

- The range encoder, ``laplace_encode_p0``, ``extensions_generate`` and
  ``Repacketizer`` on seeded inputs: bytes identical to the JAX package's.
- ``convert_to_16k`` at 8, 12, 16, 24 and 48 kHz, mono and stereo: bit
  for bit ``DREDEnc._convert_to_16k`` (the float64 filter in the numpy
  loop's order; the 16 kHz samples and the filter state).
- ``quantize_latents`` + ``dred_encode`` on the JAX encoder's own float
  latents (tests/data/torch_dred_enc.npz's ring) under many activity
  patterns, budgets and rates: payloads byte-identical to
  ``opus_tpu.dnn.dred.dred_encode``, its ``None``s included.
- ``BatchedDREDEncoder`` on the fixture's PCM (8 streams at 48 kHz, 4 at
  16 kHz, 24 frames): every frame's newest latent and state within the
  RDOVAE bound of tests/test_torch_dnn_models.py (rtol 2e-4, atol 2e-5:
  the features and GEMMs sum in another order than numpy and XLA), the
  host ints equal; on the last two frames the quantized integers and the
  payloads and attached packets byte-identical to ``_attach_dred``'s; an
  integer may differ by one only where its value before rounding lies
  within that bound x scale / 256 of a k + 0.5 boundary
  (``chip_smoke.near_half``), and such a lane (counted and printed,
  expected 0) is held instead by coding the JAX floats through the port's
  quantizer and coder.
- ``attach`` against a live ``OpusEncoder._attach_dred`` on the same
  latent ring (VBR and CBR padding, budgets that cut or refuse DRED).
- The packets round-trip through the port's ``parse_batch``: each lane's
  coded latents dequantized, state, chunk count and offset exact.
- ``convert.dred_enc_state_from_jax`` resumes a JAX encoder mid-stream
  (10 ms frames at 16 kHz: a half-filled input buffer).
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (DRED_ATOL, DRED_RTOL, code_floats,
                        fixture_boundary_lanes, fixture_ring, near_half)
from opus_tpu.bitstream import extensions as JX
from opus_tpu.bitstream import laplace as JL
from opus_tpu.bitstream import range_coder as JRC
from opus_tpu.bitstream import repacketizer as JRP
from opus_tpu.dnn import dred as JD
from opus_tpu.dnn import pitchdnn as JP
from opus_tpu.dnn import rdovae as JR
from opus_tpu.dnn.dred_enc import DREDEnc
from opus_tpu.models.opus_encoder import OpusEncoder
from opus_tpu_torch import convert
from opus_tpu_torch.bitstream import extensions as PX
from opus_tpu_torch.bitstream import laplace as PL
from opus_tpu_torch.bitstream import range_coder as PRC
from opus_tpu_torch.bitstream import repacketizer as PRP
from opus_tpu_torch.dnn import dred as PD
from opus_tpu_torch.dnn import dred_enc as PE
from opus_tpu_torch.dnn import pitchdnn as PP
from opus_tpu_torch.dnn import rdovae as PV
from opus_tpu_torch.models.dnn_recovery import parse_batch
from opus_tpu_torch.models.dred_encoder import BatchedDREDEncoder

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_dred_enc.npz")
RATES = ("48k", "16k")
FS = {"48k": 48000, "16k": 16000}


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def models(fx):
    enc, _dec, stats, pitch, _fg = (int(s) for s in fx["seeds"])
    return dict(jenc=JR.random_enc_model(enc), jstats=JD.random_stats(stats),
                jpitch=JP.random_model(pitch),
                penc=PV.random_enc_model(enc, device="cpu"),
                pstats=PD.random_stats(stats),
                ppitch=PP.random_model(pitch, device="cpu"))


# ---- the bitstream writers ----------------------------------------------
def _coder_ops(rng, n):
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, 6))
        if k == 0:
            ft = int(rng.integers(2, 1 << 16))
            fl = int(rng.integers(0, ft))
            ops.append(("encode", fl, int(rng.integers(fl + 1, ft + 1)), ft))
        elif k == 1:
            bits = int(rng.integers(1, 16))
            fl = int(rng.integers(0, 1 << bits))
            ops.append(("encode_bin", fl,
                        int(rng.integers(fl + 1, (1 << bits) + 1)), bits))
        elif k == 2:
            ops.append(("enc_bit_logp", int(rng.integers(0, 2)),
                        int(rng.integers(1, 16))))
        elif k == 3:
            ftb = int(rng.choice([8, 15]))
            icdf = sorted(rng.choice(np.arange(1, 1 << ftb), 5,
                                     replace=False).tolist(), reverse=True)
            ops.append(("enc_icdf", int(rng.integers(0, 6)), icdf + [0],
                        ftb))
        elif k == 4:
            ft = int(rng.choice([2, 9, 256, 1000, 1 << 20, (1 << 32) - 1]))
            ops.append(("enc_uint", int(rng.integers(0, ft)), ft))
        else:
            bits = int(rng.integers(1, 17))
            ops.append(("enc_bits", int(rng.integers(0, 1 << bits)), bits))
    return ops


@pytest.mark.parametrize("size", [6, 40, 400])
def test_torch_range_encoder_matches_jax(size):
    """Every encoder call, a save / restore in the middle, shrink and done:
    the buffer, state, tell and error flag as the JAX package's (a 6-byte
    buffer overflows: the error flag)."""
    rng = np.random.default_rng(size)
    ops = _coder_ops(rng, 120)
    encs = [JRC.RangeEncoder(size), PRC.RangeEncoder(size)]
    saved = [None, None]
    for j, op in enumerate(ops):
        for i, e in enumerate(encs):
            getattr(e, op[0])(*op[1:])
            if j == 40:
                saved[i] = e.save_state()
            if j == 80:
                e.restore_state(saved[i])
        assert encs[0].tell() == encs[1].tell()
        assert encs[0].tell_frac() == encs[1].tell_frac()
    for e in encs:
        e.patch_initial_bits(1, 2)
        if e.offs + e.end_offs <= size - 2:
            e.shrink(size - 2)
        e.done()
    for k in JRC.RangeEncoder.__slots__:
        assert getattr(encs[0], k) == getattr(encs[1], k), k
    assert encs[0].data() == encs[1].data()


def test_torch_laplace_encode_p0_matches_jax():
    """Seeded latent-like values (many zeros, tails past the 7-step
    escape) with DRED's p0 / decay tables: bytes identical, and the port's
    decoder reads the values back."""
    rng = np.random.default_rng(3)
    st = PD.random_stats(9)
    vals = np.where(rng.random(600) < 0.4, 0,
                    np.round(rng.laplace(0, 4, 600))).astype(int)
    je, pe = JRC.RangeEncoder(1000), PRC.RangeEncoder(1000)
    for i, v in enumerate(vals.tolist()):
        p0 = int(st.latent_p0[i % 16, i % 80]) << 7
        r = int(st.latent_r[i % 16, i % 80]) << 7
        JL.laplace_encode_p0(je, v, p0, r)
        PL.laplace_encode_p0(pe, v, p0, r)
    je.done()
    pe.done()
    assert je.data() == pe.data()
    dec = PRC.RangeDecoder(pe.data())
    got = [PL.laplace_decode_p0(dec, int(st.latent_p0[i % 16, i % 80]) << 7,
                                int(st.latent_r[i % 16, i % 80]) << 7)
           for i in range(len(vals))]
    assert got == vals.tolist()


def _extensions(rng, nb_frames, n):
    out = []
    for _ in range(n):
        ext_id = int(rng.choice([int(rng.integers(3, 32)),
                                 int(rng.integers(32, 128)), 126]))
        ln = int(rng.integers(0, 2)) if ext_id < 32 else \
            int(rng.choice([0, 5, 200, 300]))
        out.append((ext_id, int(rng.integers(0, nb_frames)),
                    rng.integers(0, 256, ln, np.uint8).tobytes()))
    return sorted(out, key=lambda e: e[1])


@pytest.mark.parametrize("nb_frames", [1, 2, 3, 6])
def test_torch_extensions_generate_matches_jax(nb_frames):
    """Short and long extensions spread over the frames (repeats and frame
    separators), with and without padding, into a roomy and a tight
    buffer: the byte count or error and the bytes as the JAX package's;
    the port's reader parses them back."""
    rng = np.random.default_rng(nb_frames)
    for trial in range(6):
        ext = _extensions(rng, nb_frames, int(rng.integers(1, 5)))
        jext = [JX.ExtensionData(*e) for e in ext]
        pext = [PX.ExtensionData(*e) for e in ext]
        for pad in (False, True):
            for cap in (1500, 40):
                jn = JX.extensions_generate(jext, nb_frames, cap, pad=pad)
                pn = PX.extensions_generate(pext, nb_frames, cap, pad=pad)
                assert jn == pn, (trial, pad, cap)
                if pn < 0:
                    continue
                jb, pb = bytearray(jn), bytearray(pn)
                JX.extensions_generate(jext, nb_frames, jn, pad=pad, out=jb)
                PX.extensions_generate(pext, nb_frames, pn, pad=pad, out=pb)
                assert jb == pb
                back = PX.extensions_parse(bytes(pb), nb_frames)
                # repeats come back grouped by id: compare as a set
                assert sorted((e.id, e.frame, e.data) for e in back) == \
                    sorted(ext)


def test_torch_repacketizer_matches_jax():
    """cat of code 0-3 packets (equal and unequal frames, padding with
    extensions) and out_range with extensions, padding and tight maxlen:
    the result or error code as the JAX package's."""
    rng = np.random.default_rng(11)
    for trial in range(40):
        nf = int(rng.integers(1, 4))
        frames = [rng.integers(0, 256, int(rng.choice([20, 20, 61, 300])),
                               np.uint8).tobytes() for _ in range(nf)]
        toc = int(rng.choice([0xF8, 0x78, 0x48]))
        src = JRP.Repacketizer()
        for fr in frames:
            assert src.cat(bytes([toc]) + fr) == 0
        packet = src.out_range(
            0, nf, 4000, pad=bool(rng.integers(0, 2)),
            extensions=[JX.ExtensionData(*e) for e in
                        _extensions(rng, nf, int(rng.integers(0, 3)))])
        assert isinstance(packet, bytes)
        ext = _extensions(rng, nf, int(rng.integers(0, 3)))
        for maxlen in (1276, len(packet) + 8, len(packet) - 1):
            for pad in (False, True):
                outs = []
                for mod in (JRP, PRP):
                    rp = mod.Repacketizer()
                    ret = rp.cat(packet)
                    exts = [(JX if mod is JRP else PX).ExtensionData(*e)
                            for e in ext]
                    outs.append((ret, rp.out_range(0, rp.nb_frames, maxlen,
                                                   pad=pad,
                                                   extensions=exts)))
                assert outs[0] == outs[1], (trial, maxlen, pad)


# ---- the 16 kHz conversion ----------------------------------------------
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fs", [8000, 12000, 16000, 24000, 48000])
def test_torch_convert_to_16k_bit_exact(fs, channels):
    """Two 20 ms frames of 2 lanes (seeded noise, a full-scale clip and a
    digital-silence frame): the 16 kHz samples and the filter state bit
    for bit DREDEnc._convert_to_16k's."""
    rng = np.random.default_rng(fs + channels)
    js = [DREDEnc(fs, channels, None, None, None) for _ in range(2)]
    mem = torch.zeros(2, PE.RESAMPLING_ORDER + 1, dtype=torch.float64)
    n = fs // 50
    for f in range(2):
        pcm = np.clip(0.5 * rng.standard_normal((2, n * channels)), -1.2,
                      1.2)
        if f == 1:
            pcm[1] = 0.0
        ref = np.stack([j._convert_to_16k(pcm[i], 320)
                        for i, j in enumerate(js)])
        out, mem = PE.convert_to_16k(torch.from_numpy(pcm), fs, channels,
                                     mem, 320)
        assert out.dtype == torch.float32 and out.shape == (2, 320)
        assert np.array_equal(out.numpy().view(np.uint32),
                              ref.view(np.uint32)), f
        assert np.array_equal(mem.numpy(),
                              np.stack([j.resample_mem for j in js])), f


# ---- quantizer and payload coder on the JAX floats ----------------------
def _activity_patterns(rng):
    n = 4 * JD.DRED_MAX_FRAMES
    pats = {"all": np.ones(n, np.uint8), "none": np.zeros(n, np.uint8)}
    for name, silent in (("last 60 ms", 24), ("last 140 ms", 56),
                         ("last 400 ms", 160)):
        a = np.ones(n, np.uint8)
        a[:silent] = 0
        pats[name] = a
    alt = np.zeros(n, np.uint8)
    alt[8::32] = 1
    pats["sparse"] = alt
    mid = np.ones(n, np.uint8)
    mid[40:120] = 0
    pats["middle gap"] = mid
    old = np.zeros(n, np.uint8)
    old[150:] = 1
    pats["oldest only"] = old
    pats["random"] = (rng.random(n) < 0.3).astype(np.uint8)
    return pats


def test_torch_dred_encode_matches_jax_on_jax_floats(fx, models):
    """The JAX ring of 48 kHz streams 0-3 at the last frame, every activity
    pattern, several (q0, dQ, qmax) ladders and budgets: byte-identical
    payloads, None where the JAX package gives None."""
    rng = np.random.default_rng(5)
    rl, rs, fill = fixture_ring(fx, "48k", 23)
    dred_offset = int(fx["dred_offset_48k"][23])
    pats = _activity_patterns(rng)
    nones = same = 0
    for s in range(4):
        for name, act in pats.items():
            for q0, dq, qmax, mc, mb in ((4, 3, 15, 11, 997),
                                         (6, 5, 15, 26, 400),
                                         (9, 2, 12, 11, 60),
                                         (14, 0, 15, 5, 997),
                                         (6, 3, 15, 11, 9)):
                ref = JD.dred_encode(models["jstats"], rl[s], rs[s], fill,
                                     dred_offset, act, q0=q0, dq=dq,
                                     qmax=qmax, max_chunks=mc, max_bytes=mb)
                got, nchunks = code_floats(
                    models["pstats"], rl[s], rs[s], fill, dred_offset, act,
                    q0, dq, qmax, mc, mb)
                assert got == ref, (s, name, q0, dq, qmax, mc, mb)
                assert (nchunks == 0) == (got is None)
                nones += got is None
                same += 1
    assert 0 < nones < same
    print(f"dred_encode: {same} payloads byte-identical, {nones} None")


# ---- the batched encoder on the fixture ---------------------------------
def _bytes(buf, ln):
    return None if ln < 0 else buf[:ln].tobytes()


@pytest.fixture(scope="module")
def encoded(fx, models):
    """BatchedDREDEncoder over each rate's fixture streams, 24 frames,
    attach on the last two: per frame the newest latent/state and host
    ints, per attach frame the packets, payloads and quantized ints."""
    out = {}
    for key in RATES:
        pcm = fx["pcm_" + key]
        ns, nf, n = pcm.shape
        enc = BatchedDREDEncoder(models["penc"], models["ppitch"],
                                 models["pstats"], ns, fs=FS[key],
                                 duration_frames_10ms=40, device="cpu")
        rec = dict(latent=[], state=[], ints=[], packets=[], chunks=[],
                   quant=[], dred_offset=[])
        for f in range(nf):
            enc.step(torch.from_numpy(pcm[:, f]), fx["activity_" + key][:, f],
                     int(fx["extra_delay_" + key]))
            d = enc.dred
            rec["latent"].append(d.latents[:, 0].numpy())
            rec["state"].append(d.states[:, 0].numpy())
            rec["ints"].append((d.dred_offset, d.latents_buffer_fill,
                                d.input_buffer_fill))
            if f >= nf - 2:
                a = f - (nf - 2)
                assert np.array_equal(enc.activity_mem,
                                      fx["activity_mem_" + key][a])
                packets = [p.tobytes() for p in fx["packet_" + key][a]]
                rec["packets"].append(enc.attach(
                    packets, int(fx["max_data_bytes_" + key]),
                    int(fx["bitrate_" + key])))
                q = {k: (v.numpy() if torch.is_tensor(v) else v)
                     for k, v in d.quantized.items()}
                rec["quant"].append(q)
                rec["dred_offset"].append(d.dred_offset)
        out[key] = rec
    return out


def test_torch_batched_dred_encoder_matches_jax(fx, encoded):
    worst = 0.0
    for key in RATES:
        rec = encoded[key]
        for f in range(len(rec["latent"])):
            for name in ("latent", "state"):
                ref = fx[f"{name}_{key}"][f]
                np.testing.assert_allclose(rec[name][f], ref, rtol=DRED_RTOL,
                                           atol=DRED_ATOL)
                worst = max(worst, float(np.abs(rec[name][f] - ref).max()))
            assert rec["ints"][f] == (int(fx["dred_offset_" + key][f]),
                                      int(fx["fill_" + key][f]),
                                      int(fx["input_fill_" + key][f])), f
    print(f"latents and states over 24 frames: max abs err {worst:.3g} "
          f"(rtol {DRED_RTOL}, atol {DRED_ATOL})")


def test_torch_batched_dred_encoder_payloads_and_attach(fx, models,
                                                        encoded):
    """Quantized ints and attached packets on the last two frames against
    the fixture: an integer differs only by one at a value near a
    rounding boundary (on the JAX floats), and a lane whose packet then
    differs is held by coding the JAX floats through the port's coder."""
    st = models["pstats"]
    n_flip = n_same = 0
    for key in RATES:
        rec = encoded[key]
        nf = len(rec["latent"])
        for a in range(2):
            q = rec["quant"][a]
            frame = nf - 2 + a
            rl, rs, fill = fixture_ring(fx, key, frame)
            assert np.array_equal(q["latent_offset"],
                                  fx["latent_offset_" + key][a])
            for s in range(len(rec["packets"][a])):
                lo = int(q["latent_offset"][s])
                q0 = int(fx["q0_" + key][a, s])
                dq = int(fx["dq_" + key][a, s])
                v = fx["v_latents_" + key][a, s]
                n = (min(2 * v.shape[0], fill - lo) + 1) // 2
                levels = [PD.compute_quantizer(q0, dq, 15, c)
                          for c in range(n)]
                for got, vj, x, scale in (
                        (q["q_latents"][s, :n], v[:n],
                         rl[s, 2 * np.arange(n) + lo],
                         st.latent_scale[levels]),
                        (q["q_state"][s], fx["v_state_" + key][a, s],
                         rs[s, lo], st.state_scale[q0])):
                    ref_q = np.floor(0.5 + vj)
                    diff = got != ref_q
                    assert (np.abs(got - ref_q)[diff] <= 1).all()
                    assert near_half(vj, x, scale)[diff].all(), (key, a, s)
                ref = _bytes(fx["attached_" + key][a, s],
                             fx["attached_len_" + key][a, s])
                if rec["packets"][a][s] == ref:
                    n_same += 1
                    continue
                assert s in fixture_boundary_lanes(fx, key, a, st)
                got, _ = code_floats(
                    st, rl[s], rs[s], fill, rec["dred_offset"][a],
                    fx["activity_mem_" + key][a, s], q0, dq, 15,
                    int(fx["chunks_" + key][a, s]),
                    int(fx["max_bytes_" + key][a, s]))
                assert got == _bytes(fx["payload_" + key][a, s],
                                     fx["payload_len_" + key][a, s])
                n_flip += 1
    print(f"attached packets byte-identical to _attach_dred: {n_same}; "
          f"lane-frames with a rounding flipped at a boundary (held on the "
          f"JAX floats instead): {n_flip}")


def test_torch_dred_packets_round_trip_through_parse_batch(fx, models,
                                                           encoded):
    """The port's packets parsed by the port's parse_batch: the state and
    every coded chunk dequantized (q 256 / scale, the q-level column), the
    chunk count and the offset as the encoder coded them."""
    st = models["pstats"]
    for key in RATES:
        rec = encoded[key]
        for a in range(2):
            q = rec["quant"][a]
            parsed = parse_batch(st, rec["packets"][a], FS[key], FS[key])
            q0 = int(fx["q0_" + key][a, 0])
            dq = int(fx["dq_" + key][a, 0])
            for s in range(len(rec["packets"][a])):
                n = int(parsed.nb_latents[s])
                ref_len = fx["payload_len_" + key][a, s]
                assert parsed.has_dred[s] == (ref_len >= 0)
                if ref_len < 0:
                    continue
                lo = int(q["latent_offset"][s])
                assert parsed.dred_offset[s] == rec["dred_offset"][a] - 8 * lo
                scale = np.maximum(st.state_scale[q0], 1).astype(np.float64)
                mask = (st.state_r[q0] != 0) & (st.state_p0[q0] != 255)
                exp = np.where(mask, q["q_state"][s] * 256.0 / scale, 0.0)
                assert np.array_equal(parsed.state0[s],
                                      exp.astype(np.float32))
                for c in range(n):
                    lv = PD.compute_quantizer(q0, dq, 15, c)
                    sc = np.maximum(st.latent_scale[lv], 1).astype(
                        np.float64)
                    mask = (st.latent_r[lv] != 0) & (st.latent_p0[lv] != 255)
                    exp = np.where(mask, q["q_latents"][s, c] * 256.0 / sc,
                                   0.0)
                    assert np.array_equal(parsed.latents[c, s, :80],
                                          exp.astype(np.float32))
                    assert parsed.latents[c, s, 80] == np.float32(
                        lv * 0.125 - 1.0)
                # the chunks the payload codes, as dred_encode counted them
                assert n == q["chunks"][s], (key, a, s)


# ---- attach on a shared ring, and the mid-stream handoff ----------------
def test_torch_attach_matches_attach_dred(fx, models):
    """The JAX ring of the 48 kHz streams at the last frame in both
    encoders: attach == _attach_dred byte for byte under VBR and CBR
    (padding to max_data_bytes) and budgets that cut the ladder or leave
    no room for DRED."""
    rl, rs, fill = fixture_ring(fx, "48k", 23)
    ns = rl.shape[0]
    port = BatchedDREDEncoder(models["penc"], models["ppitch"],
                              models["pstats"], ns, duration_frames_10ms=40,
                              device="cpu")
    d = port.dred
    d.latents, d.states = torch.from_numpy(rl), torch.from_numpy(rs)
    d.latents_buffer_fill = fill
    d.dred_offset = int(fx["dred_offset_48k"][23])
    port.activity_mem = fx["activity_mem_48k"][1].copy()
    packets = [p.tobytes() for p in fx["packet_48k"][1]]
    cases = 0
    for mdb, bitrate, vbr in ((1276, 64000, 1), (1276, 24000, 0),
                              (230, 64000, 1), (220, 16000, 0),
                              (172, 64000, 1)):
        got = port.attach(packets, mdb, bitrate, pad=not vbr)
        for s in range(ns):
            jenc = OpusEncoder(48000, 1, "restricted-lowdelay")
            jenc.set_bitrate(bitrate)
            jenc.set_vbr(vbr)
            jenc.enable_dred(models["jenc"], models["jpitch"],
                             models["jstats"], 40)
            jd = jenc.dred
            jd.latents, jd.states = rl[s].copy(), rs[s].copy()
            jd.latents_buffer_fill = fill
            jd.dred_offset = d.dred_offset
            jenc.activity_mem = port.activity_mem[s].copy()
            ref = jenc._attach_dred(packets[s], mdb)
            assert got[s] == ref, (mdb, bitrate, vbr, s)
            cases += 1
    assert cases == 5 * ns


def test_torch_dred_enc_state_from_jax_resumes_mid_stream(models):
    """Three JAX DREDEncs at 16 kHz fed 10 ms frames (160 samples: the
    input buffer is half full every other frame) for 5 frames, handed to
    the port, then 3 more frames on both: the rings, the pending input,
    the filter state and the host ints follow the JAX encoders."""
    rng = np.random.default_rng(21)
    b, n, fs = 3, 160, 16000
    jencs = [DREDEnc(fs, 1, models["jenc"], models["jpitch"],
                     models["jstats"]) for _ in range(b)]
    pcm = np.clip(0.2 * rng.standard_normal((8, b, n)), -1, 1).astype(
        np.float32).astype(np.float64)
    for f in range(5):
        for i, j in enumerate(jencs):
            j.compute_latents(pcm[f, i], n, extra_delay=64)
    port = convert.dred_enc_state_from_jax(jencs, device="cpu")
    assert port.input_buffer_fill == jencs[0].input_buffer_fill == 160
    for f in range(5, 8):
        for i, j in enumerate(jencs):
            j.compute_latents(pcm[f, i], n, extra_delay=64)
        port.compute_latents(torch.from_numpy(pcm[f]), n, extra_delay=64)
        for name in ("latents_buffer_fill", "dred_offset", "latent_offset",
                     "input_buffer_fill"):
            assert getattr(port, name) == getattr(jencs[0], name), name
        for name in ("latents", "states"):
            np.testing.assert_allclose(
                getattr(port, name).numpy(),
                np.stack([getattr(j, name) for j in jencs]),
                rtol=DRED_RTOL, atol=DRED_ATOL)
        fill = port.input_buffer_fill
        assert np.array_equal(port.input_buffer.numpy(), np.stack(
            [j.input_buffer[:fill] for j in jencs]))
        assert np.array_equal(port.resample_mem.numpy(), np.stack(
            [j.resample_mem for j in jencs]))


def test_torch_dred_encoder_defaults_to_cuda(models):
    with pytest.raises(ValueError):
        BatchedDREDEncoder(models["penc"], models["ppitch"],
                           models["pstats"], 2, duration_frames_10ms=105,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            BatchedDREDEncoder(models["penc"], models["ppitch"],
                               models["pstats"], 2)
        with pytest.raises(RuntimeError):
            PE.BatchedDREDEnc(48000, 1, models["penc"], models["ppitch"],
                              models["pstats"], 2)
