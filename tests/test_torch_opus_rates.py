"""The port's decode API below 48 kHz on the CPU, against the JAX package:

- the decoder-direction SILK resampler (opus_tpu_torch/silk/resampler.py
  ``resample`` / ``resample_lanes``) for every pair of internal rate (8,
  12, 16 kHz) and API rate (8, 12, 16, 24, 48 kHz) against the scalar
  ``opus_tpu.silk.resampler.Resampler``, live, on seeded int16 over 6
  calls of 10 and 20 ms, then over a schedule whose internal rate changes
  (the resampler set up anew, as ``set_fs`` does), bit for bit;
- ``BatchedOpusDecoder(fs=8000 | 12000 | 16000 | 24000, channels=1 | 2)``
  against tests/data/torch_opus_rates.npz (the scalar ``OpusDecoder(fs,
  c)`` over the packets of torch_opus_api.npz and torch_opus_stereo.npz,
  written by tools/make_torch_opus_rates_fixture.py): every case's first
  steps on all 8 streams at once (``RATE_STEPS``: a tick costs ~2.5 s of
  plain K1 and SILK symbol passes here), and from the JAX decoders' state
  taken mid-stream (``convert.opus_decoder_state`` at 16 and 8 kHz) over
  a window that holds the transitions, both redundancy directions, the
  hybrid -> SILK fade and DTX.  Bounds: final range equal on every step;
  int16 (``decode_int16``) and ``decode24`` equal to the scalar's, by
  their BLAKE2b digests, on every step the scalar CELT decoder took no
  part in; float PCM within PCM_TOL of ``decode24`` / 2^23 (within 2^-24
  of the scalar's float) on the others, and within CLASSIC_LSB / 32768 on
  a lost or FEC step with a CELT part;
- the quality extension refused: a packet carrying extension 124 (made
  with the port's extension writer) sets OPUS_UNIMPLEMENTED on its lane
  alone and leaves that lane's state as it was, the other lanes decode as
  without it, and ``fs=96000`` raises ValueError naming QEXT.
"""

import hashlib

import numpy as np
import pytest
import torch

from opus_tpu_torch.bitstream import packet as pkt
from opus_tpu_torch.models.opus_decoder import BatchedOpusDecoder, to_int24
from opus_tpu_torch.silk import resampler as RS

RATES_FIXTURE = "tests/data/torch_opus_rates.npz"
SOURCES = dict(api="tests/data/torch_opus_api.npz",
               st="tests/data/torch_opus_stereo.npz")
PCM_TOL = 1e-4
CLASSIC_LSB = int(32768 * PCM_TOL) + 1
RATE_STEPS = dict(api=2, st=1)
CASES = [("api", fs, 1) for fs in (8000, 12000, 16000, 24000)] + [
    ("st", fs, c) for fs in (8000, 12000, 16000, 24000) for c in (1, 2)]


@pytest.fixture(scope="module")
def rf():
    return dict(np.load(RATES_FIXTURE))


@pytest.fixture(scope="module")
def sources():
    return {k: dict(np.load(v)) for k, v in SOURCES.items()}


def digest(x: np.ndarray) -> np.ndarray:
    """tools/make_torch_opus_rates_fixture.digest."""
    h = hashlib.blake2b(np.ascontiguousarray(x).astype(
        x.dtype.newbyteorder("<")).tobytes(), digest_size=16)
    return np.frombuffer(h.digest(), np.uint8)


def steps(fx, src: str, fs: int, t: int):
    """Step t of the 8 streams: (packets, decode_fec, frame_size at fs),
    a stream past its end lost (its output is not checked)."""
    plen, buf = fx["plen"], fx["packets"]
    pk, fec, size = [], [], []
    for s in range(plen.shape[0]):
        on = t < plen.shape[1] and plen[s, t] != -2
        pk.append(bytes(buf[s, t, :plen[s, t]]) if on and plen[s, t] >= 0
                  else None)
        fec.append(on and src == "st" and bool(fx["fec"][s, t]))
        size.append(int(fx["fsize"][s, t]) * fs // 48000
                    if on and src == "st" else 0)
    return pk, fec, size


def check_step(rf, key, t, dec, pk, fec, pcm, n, lanes=None, seen=None):
    """The step's checks on ``lanes`` (default all 8) against the fixture
    (see the module docstring); ``dec``'s soft clip memory advances."""
    p16, _n = dec.soft_clip_int16(pcm, n)
    p24 = to_int24(pcm)
    for s in range(8) if lanes is None else lanes:
        if rf[key + "_n"][s, t] < 0:
            continue
        assert n[s] == rf[key + "_n"][s, t], (key, t, s)
        assert int(dec.final_range[s]) == rf[key + "_rng"][s, t], (key, t, s)
        a24 = p24[s, :n[s]].reshape(-1).numpy()
        if rf[key + "_celt"][s, t] == 0:
            a16 = p16[s, :n[s]].reshape(-1).numpy()
            assert np.array_equal(digest(a16), rf[key + "_d16"][s, t]), (
                key, t, s)
            assert np.array_equal(digest(a24), rf[key + "_d24"][s, t]), (
                key, t, s)
            kind = "silk"
            e = 0.0
        else:
            o = rf[key + "_off"][s, t]
            ref = rf[key + "_pcm24"][o:o + len(a24)] / 2.0 ** 23
            e = float(np.abs(pcm[s, :n[s]].reshape(-1).numpy() - ref).max(
                initial=0.0))
            kind = "lossy" if pk[s] is None or fec[s] else "celt"
            lim = CLASSIC_LSB / 32768 if kind == "lossy" else PCM_TOL
            assert e <= lim + 2.0 ** -24, (key, t, s, e, kind)
            if t < 2:
                fo = rf[key + "_foff"][s, t]
                fl = rf[key + "_pcm"][fo:fo + len(a24)]
                assert np.abs(pcm[s, :n[s]].reshape(-1).numpy() - fl).max(
                    initial=0.0) <= lim, (key, t, s)
        if seen is not None:
            seen[kind] = max(seen.get(kind, 0.0), e)


@pytest.mark.parametrize("fs_out", RS.API_RATES)
def test_torch_resampler_every_pair_matches_scalar(fs_out):
    """Every internal rate into fs_out kHz: 6 calls of 10 / 20 ms on 4
    lanes (speech-like noise, a saturating lane, a lane alternating at
    -32768) on the widest state store, then a schedule whose internal rate
    changes every other call, each change a new resampler on both sides."""
    from opus_tpu.silk.resampler import Resampler

    rng = np.random.default_rng(fs_out)
    b = 4

    def block(fi, ms):
        x = np.clip(rng.standard_normal((b, fi * ms)) * 9000, -32768,
                    32767).astype(np.int64)
        x[0] = 32767
        x[1, ::2] = -32768
        return x

    pairs = [fi for fi in RS.IN_RATES
             if fs_out >= fi or (fi, fs_out) in RS._DOWN]
    for fi in pairs:
        st = RS.wide_init(b)
        refs = [Resampler(fi * 1000, fs_out * 1000) for _ in range(b)]
        for k in range(6):
            x = block(fi, (10, 20)[k % 2])
            y, st = RS.resample_lanes(torch.from_numpy(x), st, fi, fs_out)
            want = np.array([r.process(x[i].tolist())
                             for i, r in enumerate(refs)])
            assert np.array_equal(y.numpy(), want), (fi, fs_out, k)
    sched = [pairs[k // 2 % len(pairs)] for k in range(2 * len(pairs) + 2)]
    st, refs, last = None, None, None
    for k, fi in enumerate(sched):
        if fi != last:
            st = RS.wide_init(b)
            refs = [Resampler(fi * 1000, fs_out * 1000) for _ in range(b)]
            last = fi
        x = block(fi, 20)
        y, st = RS.resample_lanes(torch.from_numpy(x), st, fi, fs_out)
        want = np.array([r.process(x[i].tolist())
                         for i, r in enumerate(refs)])
        assert np.array_equal(y.numpy(), want), (sched, k)


@pytest.mark.parametrize("src,fs,channels", CASES)
def test_torch_opus_rates_fixture_matches_scalar(rf, sources, src, fs,
                                                 channels):
    """The case's first RATE_STEPS[src] steps, 8 streams on 8 lanes."""
    key = f"{src}{fs // 1000}_{channels}"
    dec = BatchedOpusDecoder(8, fs=fs, channels=channels, device="cpu")
    seen = {}
    for t in range(RATE_STEPS[src]):
        pk, fec, size = steps(sources[src], src, fs, t)
        pcm, n = dec.decode(pk, fec, size)
        assert not dec.status.any() and not dec.flagged.any()
        check_step(rf, key, t, dec, pk, fec, pcm, n, seen=seen)
    print(f"\n{key}: largest errors {seen}")


# (rate, first step, steps): a window of the api streams that holds
# redundancy both ways, transitions, the hybrid -> SILK fade and DTX
WINDOWS = [(16000, 4, 4), (8000, 12, 3)]


@pytest.mark.parametrize("fs,first,count", WINDOWS)
def test_torch_opus_rates_continue_from_jax_state(rf, sources, fs, first,
                                                  count):
    """The JAX scalar decoders at fs run to step ``first`` on the api
    streams, their state converted (``convert.opus_decoder_state``, the
    SILK resamplers at fs): the port continues for ``count`` steps with the
    fixture's ranges, SILK int16 and decode24 exact, PCM within the
    bounds; the window holds the events named in ``want``."""
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu_torch.convert import opus_decoder_state

    fx = sources["api"]
    refs = [OpusDecoder(fs, 1) for _ in range(8)]
    for t in range(first):
        pk, _f, _z = steps(fx, "api", fs, t)
        for s, ref in enumerate(refs):
            if fx["plen"][s, t] != -2:
                ref.decode(pk[s])
    dec = BatchedOpusDecoder(8, fs=fs, device="cpu")
    dec.set_state(opus_decoder_state(refs))
    key = f"api{fs // 1000}_1"
    for t in range(first, first + count):
        pk, fec, size = steps(fx, "api", fs, t)
        pcm, n = dec.decode(pk, fec, size)
        check_step(rf, key, t, dec, pk, fec, pcm, n)
    want = {16000: ("redundancy_celt_to_silk", "redundancy_silk_to_celt",
                    "transition", "dtx", "concealed", "fade_hybrid_to_silk"),
            8000: ("redundancy_celt_to_silk", "redundancy_silk_to_celt",
                   "fade_hybrid_to_silk")}[fs]
    for k in want:
        assert dec.events.get(k, 0) > 0, (k, dec.events)


def _lane_state(dec, i):
    """Lane i's rows of ``get_state`` (numpy), for equality checks."""
    def rows(t):
        if isinstance(t, dict):
            return {k: rows(v) for k, v in t.items()}
        return np.asarray(t[i] if isinstance(t, np.ndarray) else
                          t[i].cpu().numpy()).copy()
    return rows(dec.get_state())


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("fs", [48000, 16000])
def test_torch_opus_qext_packet_refused_on_its_lane(sources, fs):
    """Three lanes decode the api fixture's stream 3 (hybrid SWB, padded
    code 3 packets); at step 2 lane 1's packet is rebuilt with a quality
    extension (id 124) for its first frame by the port's repacketizer:
    lane 1 gets OPUS_UNIMPLEMENTED, its state stays as it was, lanes 0 and
    2 decode as a decoder that got the plain packet everywhere; the next
    step decodes on every lane."""
    from opus_tpu_torch.bitstream.extensions import ExtensionData
    from opus_tpu_torch.bitstream.repacketizer import Repacketizer
    from opus_tpu_torch.models.opus_decoder import has_qext

    fx = sources["api"]
    row = [bytes(fx["packets"][3, t, :fx["plen"][3, t]]) for t in range(4)]
    rp = Repacketizer()
    assert rp.cat(row[2]) == 0
    qext = rp.out_range(0, rp.nb_frames, extensions=[
        ExtensionData(124, 0, bytes(range(1, 20)))])
    assert isinstance(qext, bytes)
    assert has_qext(pkt.packet_parse(qext)) and not has_qext(
        pkt.packet_parse(row[2]))
    dec = BatchedOpusDecoder(3, fs=fs, device="cpu")
    ref = BatchedOpusDecoder(3, fs=fs, device="cpu")
    for t in range(2):
        dec.decode([row[t]] * 3)
        ref.decode([row[t]] * 3)
    before = _lane_state(dec, 1)
    pcm, n = dec.decode([row[2], qext, row[2]])
    want, wn = ref.decode([row[2]] * 3)
    assert dec.status.tolist() == [0, pkt.OPUS_UNIMPLEMENTED, 0]
    assert n[1] == 0 and n[0] == wn[0] and n[2] == wn[2]
    assert _same(before, _lane_state(dec, 1))
    for i in (0, 2):
        # equal but for the f32 products' change with the batch's lanes
        assert (pcm[i, :n[i]] - want[i, :wn[i]]).abs().max() <= 1e-6
        assert int(dec.final_range[i]) == int(ref.final_range[i])
    pcm, n = dec.decode([row[3]] * 3)
    assert dec.status.tolist() == [0, 0, 0] and (n > 0).all()


def test_torch_opus_96k_refused_naming_qext():
    with pytest.raises(ValueError, match="QEXT"):
        BatchedOpusDecoder(1, fs=96000, device="cpu")
    with pytest.raises(ValueError):
        BatchedOpusDecoder(1, fs=44100, device="cpu")


def test_torch_opus_demo_decode_at_16k_matches_jax(sources, tmp_path):
    """``opus_demo decode --rate 16000 --device cpu`` on the api fixture's
    SILK-only stream 2 (its first 8 packets, NB and MB, code 0-3) written
    as an opus_demo .bit file: exit code 0 (every final range checked) and
    the PCM file equal to the JAX package's ``opus_demo.decode(16000, 1,
    ...)``."""
    import struct

    from opus_tpu.tools import opus_demo as jax_demo
    from opus_tpu_torch.tools import opus_demo

    fx = sources["api"]
    bit = tmp_path / "s2.bit"
    with open(bit, "wb") as fh:
        for t in range(8):
            n = int(fx["plen"][2, t])
            p = bytes(fx["packets"][2, t, :n]) if n > 0 else b""
            fh.write(struct.pack(">iI", len(p), int(fx["rng"][2, t])
                                 if p else 0) + p)
    out, ref = tmp_path / "s2.pcm", tmp_path / "ref.pcm"
    assert opus_demo.main(["decode", "--device", "cpu", "--rate", "16000",
                           str(bit), str(out)]) == 0
    assert jax_demo.decode(16000, 1, str(bit), str(ref)) == 0
    got, want = np.fromfile(out, "<i2"), np.fromfile(ref, "<i2")
    assert len(got) == len(want) > 8 * 160 and np.array_equal(got, want)
