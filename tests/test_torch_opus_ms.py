"""The port's multistream and projection decoders
(opus_tpu_torch/models/multistream.py ``BatchedOpusMSDecoder``,
projection.py ``BatchedOpusProjectionDecoder``) on the CPU, against the
JAX package's ``OpusMSDecoder`` / ``OpusProjectionDecoder`` through
tests/data/torch_opus_ms.npz (tools/make_torch_opus_ms_fixture.py: 5.1
at 256 kb/s (CELT, the LFE stream SILK), at 64 kb/s voip (hybrid and
SILK), at 40 ms (code 1 stream packets), a stereo + mono layout with a
255 in its mapping, first-order ambisonics), two streams a case:

- the elementary packets rebuilt from each multistream packet
  (``multistream.split``) byte-equal to the ones the JAX decoder handed
  its elementary decoders;
- the decoded float PCM within PCM_TOL of ``decode24`` / 2^23 (within
  2^-24 of JAX's float) on every output channel, the elementary decoders'
  final ranges equal, a 255 channel silent, and ``decode24`` and
  ``decode_int16`` equal to JAX's on the channels of SILK-only streams;
- the projection decoder's float within the bound scaled by the demixing
  matrix, and its Q15 integer demix fed JAX's internal int16 equal to
  JAX's ``decode_int16`` bit for bit;
- ``convert.opus_ms_decoder_state``: JAX decoders taken after two frames,
  continued by the port with equal ranges and SILK int16; and the 64 kb/s
  case decoded at 16 kHz against JAX's ``OpusMSDecoder(16000)``, live;
- a lane whose multistream packet does not parse: OPUS_INVALID_PACKET on
  it alone, its state untouched (ranges equal, PCM within 1e-6: the f32
  products change with the lane count of a batch).
"""

import numpy as np
import pytest
import torch

from opus_tpu_torch.bitstream import packet as pkt
from opus_tpu_torch.models.multistream import (BatchedOpusMSDecoder,
                                               default_surround_layout,
                                               split)
from opus_tpu_torch.models.opus_decoder import to_int24
from opus_tpu_torch.models.projection import (
    BatchedOpusProjectionDecoder, order_plus_one_from_channels,
    streams_from_channels)
from opus_tpu_torch.utils.soft_clip import float2int16_lanes

FIXTURE = "tests/data/torch_opus_ms.npz"
PCM_TOL = 1e-4
CLASSIC_LSB = int(32768 * PCM_TOL) + 1
MS_CASES = ("hi", "lo", "long", "gap")
TEST_FRAMES = 3         # of each case's 3-6 frames (a tick ~1-3 s here)
SILK = int(pkt.Mode.SILK_ONLY)


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def packets(fx, case, f):
    plen, buf = fx[case + "_plen"], fx[case + "_packets"]
    return [bytes(buf[i, f, :plen[i, f]]) for i in range(plen.shape[0])]


def layout(fx, case):
    ch, streams, coupled = (int(v) for v in fx[case + "_layout"])
    return ch, streams, coupled, [int(m) for m in fx[case + "_mapping"]]


def silk_channels(fx, case, f, mapping, coupled):
    """[L, C] bool: output channels fed by a stream that has been SILK on
    every frame up to f (its output is SILK's int16 / 32768 exactly)."""
    modes = fx[case + "_modes"][:, :f + 1]              # [L, f + 1, S]
    only = (modes == SILK).all(axis=1)                  # [L, S]
    out = np.zeros((only.shape[0], len(mapping)), bool)
    for c, m in enumerate(mapping):
        if m != 255:
            s = m // 2 if m < 2 * coupled else m - coupled
            out[:, c] = only[:, s]
    return out


@pytest.mark.parametrize("case", MS_CASES + ("foa",))
def test_torch_ms_split_matches_jax_rebuild(fx, case):
    _ch, streams, _cp, _m = layout(fx, case)
    elem, elen = fx[case + "_elem"], fx[case + "_elen"]
    for f in range(fx[case + "_plen"].shape[1]):
        for i, p in enumerate(packets(fx, case, f)):
            got = split(p, streams)
            want = [bytes(elem[i, f, s, :elen[i, f, s]])
                    for s in range(streams)]
            assert got == want, (case, i, f)


@pytest.mark.parametrize("case", MS_CASES)
def test_torch_ms_decoder_matches_jax(fx, case):
    ch, streams, coupled, mapping = layout(fx, case)
    lanes = fx[case + "_plen"].shape[0]
    dec = BatchedOpusMSDecoder(lanes, 48000, ch, streams, coupled, mapping,
                               device="cpu")
    worst = 0.0
    for f in range(min(TEST_FRAMES, fx[case + "_plen"].shape[1])):
        pcm, n = dec.decode(packets(fx, case, f))
        assert not dec.status.any()
        ref24 = fx[case + "_pcm24"][:, f]                 # [L, N, C]
        assert (n == ref24.shape[1]).all()
        assert np.array_equal(dec.final_range.numpy(),
                              fx[case + "_rng"][:, f]), (case, f)
        x = pcm.numpy()
        e = np.abs(x - ref24 / 2.0 ** 23).max()
        assert e <= PCM_TOL + 2.0 ** -24, (case, f, e)
        worst = max(worst, e)
        for c, m in enumerate(mapping):
            if m == 255:
                assert not x[:, :, c].any()
        exact = silk_channels(fx, case, f, mapping, coupled)
        p24, p16 = to_int24(pcm).numpy(), float2int16_lanes(pcm).numpy()
        want16 = np.clip(np.round(ref24 / 256.0), -32768, 32767)
        for i in range(lanes):
            cs = np.nonzero(exact[i])[0]
            assert np.array_equal(p24[i][:, cs], ref24[i][:, cs]), (i, f)
            assert np.array_equal(p16[i][:, cs], want16[i][:, cs]), (i, f)
    print(f"\n{case}: PCM within {worst:.3g}; SILK-only channels "
          f"{int(silk_channels(fx, case, 0, mapping, coupled).sum())}")


def test_torch_projection_matches_jax(fx):
    case = "foa"
    ch, streams, coupled, _m = layout(fx, case)
    assert order_plus_one_from_channels(ch) == 2
    assert streams_from_channels(ch) == (streams, coupled)
    matrix = fx[case + "_matrix"].tobytes()
    lanes = fx[case + "_plen"].shape[0]
    dec = BatchedOpusProjectionDecoder(lanes, 48000, ch, streams, coupled,
                                       matrix, device="cpu")
    gain = np.abs(dec.demix_q15.numpy()).sum(axis=1).max() / 32768.0
    for f in range(TEST_FRAMES):
        pcm, n = dec.decode(packets(fx, case, f))
        ref24 = fx[case + "_pcm24"][:, f]
        e = np.abs(pcm.numpy() - ref24 / 2.0 ** 23).max()
        assert e <= PCM_TOL * gain + 2.0 ** -24, (f, e)
        # the Q15 demix on JAX's internal int16: bit for bit
        got = dec.demix_int16(torch.from_numpy(fx[case + "_internal16"][:, f]))
        assert np.array_equal(got.numpy(), fx[case + "_pcm16"][:, f]), f
    # the whole int16 path on the port's own internal channels
    dec2 = BatchedOpusProjectionDecoder(lanes, 48000, ch, streams, coupled,
                                        matrix, device="cpu")
    p16, _n = dec2.decode_int16(packets(fx, case, 0))
    d = np.abs(p16.numpy().astype(np.int64) - fx[case + "_pcm16"][:, 0])
    assert d.max() <= int(np.ceil(CLASSIC_LSB * gain)) + ch, d.max()


def test_torch_ms_continues_from_jax_state(fx):
    """JAX OpusMSDecoders (the 64 kb/s voip 5.1: hybrid and SILK streams)
    run two frames, converted (``convert.opus_ms_decoder_state``): the
    port goes on for two frames with the fixture's ranges, PCM within
    PCM_TOL and the SILK streams' channels exact."""
    from opus_tpu.models.multistream import OpusMSDecoder
    from opus_tpu_torch.convert import opus_ms_decoder_state

    case = "lo"
    ch, streams, coupled, mapping = layout(fx, case)
    lanes = fx[case + "_plen"].shape[0]
    refs = [OpusMSDecoder(48000, ch, streams, coupled, mapping)
            for _ in range(lanes)]
    for f in range(2):
        for ref, p in zip(refs, packets(fx, case, f)):
            ref.decode(p)
    dec = BatchedOpusMSDecoder(lanes, 48000, ch, streams, coupled, mapping,
                               device="cpu")
    dec.set_state(opus_ms_decoder_state(refs))
    for f in range(2, 4):
        pcm, _n = dec.decode(packets(fx, case, f))
        assert np.array_equal(dec.final_range.numpy(),
                              fx[case + "_rng"][:, f]), f
        ref24 = fx[case + "_pcm24"][:, f]
        assert np.abs(pcm.numpy() - ref24 / 2.0 ** 23).max() <= PCM_TOL
        exact = silk_channels(fx, case, f, mapping, coupled)
        p24 = to_int24(pcm).numpy()
        assert exact.any()
        for i in range(lanes):
            cs = np.nonzero(exact[i])[0]
            assert np.array_equal(p24[i][:, cs], ref24[i][:, cs]), (i, f)


def test_torch_ms_at_16k_matches_jax_live(fx):
    """The 64 kb/s voip 5.1 decoded at 16 kHz: ranges equal to JAX's
    ``OpusMSDecoder(16000)``, PCM within PCM_TOL, decode24 exact on the
    SILK streams' channels."""
    from opus_tpu.models.multistream import OpusMSDecoder

    case = "lo"
    ch, streams, coupled, mapping = layout(fx, case)
    lanes = fx[case + "_plen"].shape[0]
    refs = [OpusMSDecoder(16000, ch, streams, coupled, mapping)
            for _ in range(lanes)]
    dec = BatchedOpusMSDecoder(lanes, 16000, ch, streams, coupled, mapping,
                               device="cpu")
    for f in range(2):
        pk = packets(fx, case, f)
        want = np.stack([np.asarray(r.decode(p)).reshape(-1, ch)
                         for r, p in zip(refs, pk)])
        p24, n = dec.decode24(pk)
        assert (n == 320).all() and want.shape[1] == 320
        assert np.array_equal(
            dec.final_range.numpy(),
            [[d.rangeFinal for d in r.decoders] for r in refs]), f
        want24 = np.clip(np.rint(want * 8388608.0), -(1 << 31), (1 << 31) - 1)
        e = np.abs(p24.numpy() - want24).max() / 2.0 ** 23
        assert e <= PCM_TOL + 2.0 ** -23, (f, e)
        exact = silk_channels(fx, case, f, mapping, coupled)
        for i in range(lanes):
            cs = np.nonzero(exact[i])[0]
            assert np.array_equal(p24.numpy()[i][:, cs], want24[i][:, cs])


def test_torch_ms_invalid_packet_on_its_lane(fx):
    """Lane 1's packet cut inside its first stream's self-delimited
    framing: OPUS_INVALID_PACKET on lane 1 alone, no output, its state
    untouched (the next frame decodes as on a decoder that never saw the
    bad packet); the surround layout helper gives the fixture's 5.1."""
    case = "hi"
    ch, streams, coupled, mapping = layout(fx, case)
    assert default_surround_layout(6) == (streams, coupled, mapping)
    pk = packets(fx, case, 0)
    dec = BatchedOpusMSDecoder(2, 48000, ch, streams, coupled, mapping,
                               device="cpu")
    ref = BatchedOpusMSDecoder(2, 48000, ch, streams, coupled, mapping,
                               device="cpu")
    pcm, n = dec.decode([pk[0], pk[1][:2]])
    assert dec.status.tolist() == [0, pkt.OPUS_INVALID_PACKET]
    assert n.tolist() == [960, 0]
    want, _wn = ref.decode([pk[0], pk[0]])
    # lane 0 decodes as it would beside a good lane (within the f32
    # products' change with the batch's lane count)
    assert (pcm[0] - want[0]).abs().max() <= 1e-6
    assert torch.equal(dec.final_range[0], ref.final_range[0])
    nxt = packets(fx, case, 1)
    ref2 = BatchedOpusMSDecoder(2, 48000, ch, streams, coupled, mapping,
                                device="cpu")
    ref2.decode([pk[0], pk[1]])
    got, _n = dec.decode([nxt[0], pk[1]])
    want2, _n2 = ref2.decode([nxt[0], nxt[1]])
    # lane 1 decodes its first frame now, as a fresh decoder would
    fresh = BatchedOpusMSDecoder(1, 48000, ch, streams, coupled, mapping,
                                 device="cpu")
    first, _n3 = fresh.decode([pk[1]])
    assert (got[0] - want2[0]).abs().max() <= 1e-6
    assert (got[1] - first[0]).abs().max() <= 1e-6
    assert torch.equal(dec.final_range[1], fresh.final_range[0])
