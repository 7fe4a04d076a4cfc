"""opus_demo's loss loops over SILK-WB and FB hybrid streams
(opus_tpu_torch/tools/sim_loss.py ``BatchedLossDecoder(mode=...)``: the
classic SILK concealment and comfort noise, in-band FEC, DTX, the hybrid
CELT half concealed at start band 17) against the JAX package's
``opus_demo.decode`` loop on the CPU, and DTX on a CELT lane.

tests/data/torch_silk_plc.npz (tools/make_torch_silk_plc_fixture.py) holds
the scalar loop on 8 SILK-WB streams (24 kb/s, FEC on, two with DTX) and 8
FB hybrid streams (32 kb/s, FEC on), 16 frames each, every lane under its
own pattern (runs of 1-4 losses, a loss before the first packet, a loss on
the last frame), plain and with -inbandfec.  One decoder of 16 lanes runs
each mode: lanes 0-7 the plain loop, 8-15 -inbandfec.  Bounds
(chip_smoke.silk_plc_compare): slot kinds, final ranges and SILK loss
counts equal; SILK int16 equal on every sample (each slot's digest);
hybrid int16 within CLASSIC_LSB.
"""

import os

import numpy as np
import pytest

import chip_smoke as CS
from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def sfx():
    return dict(np.load(os.path.join(DATA, "torch_silk_plc.npz")))


@pytest.mark.parametrize("mode,ticks", [("silk", 16), ("hybrid", 16)])
def test_plain_and_inbandfec_loops_match_opus_demo(sfx, mode, ticks):
    """The plain loop conceals each lost packet in its own tick (a DTX
    packet too); -inbandfec conceals a run's pending span less 20 ms when
    it ends, decodes the resuming packet's LBRR frame into the last 20 ms
    (or conceals it where the packet has none) and then the packet;
    flush() conceals a run open at the end.  Both modes over all 16
    frames of the fixture (chip_smoke.py's silk_plc phase holds the card
    to the first SILK_PLC_TICKS of them)."""
    pk = CS.silk_plc_packets(sfx, mode)
    lost = sfx[f"{CS.SILK_PLC_KEY[mode]}_lost"][:, :ticks]
    dec = BatchedLossDecoder(16, device="cpu", dred=False, mode=mode,
                             inbandfec=np.arange(16) >= 8)
    got = CS.loss_run(dec, pk + pk, np.concatenate([lost, lost]))
    assert (got["n"] == ticks * 960).all()
    assert not got["pending"].any()
    for j, loop in enumerate(("plain", "fec")):
        e, kinds = CS.silk_plc_compare(
            got, CS.silk_plc_fixture(sfx, mode, loop, ticks), mode, loop,
            lanes=range(8 * j, 8 * j + 8))
        print(f"{mode} {loop}: slots by kind {kinds}, int16 within {e} LSB "
              f"of opus_demo")
        assert kinds[1] and (kinds[4] if loop == "fec" else True)
    if mode == "silk":
        assert (got["kind"] == 5).any()


def test_silk_dred_loop_conceals_classically_without_dred(sfx):
    """-dred on SILK packets that carry no DRED: each run is concealed
    classically when it ends, the SILK state where the last packet left
    it, so every emitted slot equals the plain loop's (6 ticks; a run
    still open at the end is not emitted)."""
    nf = 6
    pk = CS.silk_plc_packets(sfx, "silk")
    lost = sfx["silk_lost"][:, :nf]
    dec = BatchedLossDecoder(8, *CS.sim_models("cpu"), device="cpu",
                             dred=True, mode="silk")
    got = CS.loss_run(dec, pk, lost, flush=False)
    ref = CS.silk_plc_fixture(sfx, "silk", "plain")
    done = got["kind"] >= 0
    assert done.sum() < done.size and not (got["kind"] == 2).any()
    for k in CS.SLOT_KEYS:
        assert np.array_equal(got[k][done], ref[k][:, :nf][done]), k
    dg = CS.slot_digests(got["out16"])
    assert (dg == ref["digest"][:, :nf]).all(axis=2)[done].all()


def test_celt_dtx_packet_is_concealed(sfx):
    """A TOC-only CELT packet (DTX) is concealed for its 20 ms, as
    opus_demo's decoder does (opus_decoder.py:292-300), not decoded as an
    empty frame; its final range is 0.  6 ticks of opus_demo's plain loop
    on two CELT lanes with DTX packets at frames 5 and 2-3, held to its
    int16 within CLASSIC_LSB."""
    nf = 6
    buf, lens = sfx["celt_dtx_packets"], sfx["celt_dtx_lens"]
    pk = [[bytes(buf[i, f, :lens[i, f]]) for f in range(nf)]
          for i in range(len(buf))]
    lost = sfx["celt_dtx_lost"][:, :nf]
    dec = BatchedLossDecoder(len(pk), device="cpu", dred=False)
    out = np.zeros((len(pk), nf * 960), np.int16)
    n = np.zeros(len(pk), np.int64)
    rng = []
    for f in range(nf):
        o, cnt = dec.tick([p[f] for p in pk], lost[:, f])
        o = o.numpy()
        for i in range(len(pk)):
            out[i, n[i]:n[i] + cnt[i]] = o[i, :cnt[i]]
        n += cnt
        rng.append(dec.final_range().numpy().copy())
    ref = sfx["celt_dtx_out16"][:, :nf * 960]
    e = int(np.abs(out.astype(np.int64) - ref).max())
    print(f"CELT lanes with DTX packets: int16 within {e} LSB of opus_demo")
    assert e <= CS.CLASSIC_LSB
    rng = np.stack(rng, axis=1)
    assert rng[0, 5] == 0 and rng[1, 2] == 0 and rng[1, 3] == 0
    assert rng[0, 4] != 0
