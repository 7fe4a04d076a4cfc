"""opus_demo's loss loops with the classic CELT concealment
(opus_tpu_torch/tools/sim_loss.py ``BatchedLossDecoder(dred=, inbandfec=)``
and ``flush``) against the JAX package's ``opus_demo.decode`` loop on the
CPU.

tests/data/torch_celt_plc.npz (tools/make_torch_celt_plc_fixture.py) holds
the JAX loop on torch_sim_loss.npz's 8 streams (24 frames of 20 ms CELT
with DRED), each lane under its own pattern (lost before its first packet,
single losses, a run of 7 into the noise branch, noise then one good frame
then a loss, a run still open at the end, LossGen patterns): plain, with
-inbandfec (the same output: a CELT-only stream carries no LBRR) and with
-dred over 12 frames with DRED stripped from chosen packets.  Bounds
(chip_smoke.classic_compare): kinds, branches, pitch periods, zeroing
decisions and final ranges equal; decoded PCM after a loss within
PCM_ABS_TOL; concealed int16 within CLASSIC_LSB (DRED's within
PLC_LSB_48K).
"""

import os

import numpy as np
import pytest

import chip_smoke as CS
from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def cfx():
    return dict(np.load(os.path.join(DATA, "torch_celt_plc.npz")))


@pytest.fixture(scope="module")
def packets():
    return CS.sim_fixture_packets(np.load(os.path.join(
        DATA, "torch_sim_loss.npz")))


def _report(name, got, e):
    k = got["kind"]
    print(f"{name}: {int((k == 1).sum())} classic concealments "
          f"({int((got['branch'] == 1).sum())} periodic, "
          f"{int((got['branch'] == 2).sum())} noise), {int((k == 2).sum())} "
          f"from DRED, {int((k == 3).sum())} before any packet; decoded PCM "
          f"after a loss {e[0]:.3g}, concealed {e[1]} LSB (DRED {e[2]})")


@pytest.mark.parametrize("inbandfec", [False, True])
def test_plain_and_inbandfec_loops_match_jax(cfx, packets, inbandfec):
    """The plain loop conceals a lost packet in its own tick (24 frames);
    -inbandfec defers it to the next packet (n = 0 on the lost tick) and
    conceals the same frames there (the first 12 frames: a lane conceals
    the same sequence whenever it emits it); flush() conceals the run open
    at the end."""
    nf = cfx["lost"].shape[1] // 2 if inbandfec else cfx["lost"].shape[1]
    lost = cfx["lost"][:, :nf]
    dec = BatchedLossDecoder(len(packets), device="cpu", dred=False,
                             inbandfec=inbandfec)
    got = CS.classic_loss_run(dec, packets, lost)
    e = CS.classic_compare(got, CS.classic_fixture(cfx, "plain", nf),
                           "port vs JAX")
    assert (got["n"] == nf * 960).all()
    assert not got["pending"].any()
    if not inbandfec:
        assert got["kind"][4, -5:].tolist() == [1] * 5
    _report("-inbandfec" if inbandfec else "plain", got, e)


def test_inbandfec_defers_then_flushes(cfx, packets):
    """-inbandfec: a lost tick emits nothing and leaves its 20 ms pending;
    the next packet emits the concealed span then itself; flush() empties
    pending()."""
    dec = BatchedLossDecoder(2, device="cpu", dred=False, inbandfec=True)
    two = [packets[1], packets[2]]
    lost = np.array([[False, True, False, True],
                     [False, True, True, True]])
    ns = []
    for f in range(4):
        _out, n = dec.tick([p[f] for p in two], lost[:, f])
        ns.append(n.tolist())
    assert ns == [[960, 960], [0, 0], [1920, 0], [0, 0]]
    assert dec.pending().tolist() == [960, 2880]
    _out, n = dec.flush()
    assert n.tolist() == [960, 2880] and not dec.pending().any()


def test_dred_loop_falls_back_to_classic_concealment(cfx, packets):
    """-dred: a resuming packet with DRED conceals from it, one without
    (stripped) conceals classically; flush() conceals the rest."""
    nd = CS.CLASSIC_DRED_FRAMES
    dec = BatchedLossDecoder(len(packets), *CS.sim_models("cpu"),
                             device="cpu", dred=True)
    got = CS.classic_loss_run(
        dec, CS.dred_loop_packets(packets, cfx["strip"][:, :nd]),
        cfx["lost"][:, :nd])
    e = CS.classic_compare(got, CS.classic_fixture(cfx, "dred"),
                           "port vs JAX")
    assert (got["kind"] == 1).any() and (got["kind"] == 2).any()
    assert not got["pending"].any()
    _report("-dred", got, e)
