"""The port's simulated-loss DRED decode loop (opus_tpu_torch/tools/
sim_loss.py ``BatchedLossDecoder``, with tools/loss.py's flags) against the
JAX package's ``opus_demo.decode`` loop with ``-dred`` (opus_tpu/tools/
opus_demo.py:109-180: the scalar ``OpusDecoder`` with ``load_deep_plc`` and
``OpusDREDDecoder``) on the CPU.

tests/data/torch_sim_loss.npz (tools/make_torch_sim_loss_fixture.py) holds
8 streams of the JAX encoder's 48 kHz CELT packets with DRED and the JAX
loop over their first 12 frames: streams 0-3 at ``-sim_loss 10``
(``LossGen(random_model(33), 500 + s)``), 4-7 at ``-loss 10``
(``default_rng(500 + s)``).  Bounds (chip_smoke.sim_compare): loss flags
and final ranges exact; CELT PCM within 1e-4 (PCM_ABS_TOL, the CELT
decode's f32 budget); concealed int16 at 48 kHz within 4 LSB
(PLC_LSB_48K: FARGAN's 1-LSB differences at 16 kHz through the
upsampler).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu_torch.tools.sim_loss import BatchedLossDecoder

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(DATA, "torch_sim_loss.npz"))


def _decoder(b):
    return BatchedLossDecoder(b, *CS.sim_models("cpu"), device="cpu")


def test_sim_loss_loop_matches_jax_opus_demo(fx):
    n = CS.SIM_LOOP
    lost = CS.sim_loss_flags(500 + np.arange(8), np.arange(8) < 4, n,
                             int(fx["dred_from"]), "cpu")
    assert np.array_equal(lost, fx["loop_lost"])
    packets = CS.sim_fixture_packets(fx)
    got = CS.sim_loss_run(_decoder(8), packets, lost)
    e_pcm, e_conc, n_conc = CS.sim_compare(got, fx, "port vs JAX")
    assert np.array_equal(got["pending"], fx["loop_pending"])
    assert n_conc == int(fx["loop_concealed"].sum()) > 0
    print(f"sim_loss loop: {int(lost.sum())} of {lost.size} packets lost, "
          f"{got['resumes']} resume events, {n_conc} concealed frames; CELT "
          f"PCM {e_pcm:.3g}, concealed {e_conc} LSB; pending at the end "
          f"{got['pending'].tolist()}")


def test_sim_loss_resume_without_dred_raises(fx):
    """A lane that resumes on a packet without DRED conceals its pending
    span with the classic CELT concealment (it raised NotImplementedError
    before that was ported): lane 1 loses its second packet, lane 0 its
    first (before any decode: zeros); the output equals the JAX
    package's OpusDecoder within CLASSIC_LSB."""
    from opus_tpu.models.opus_decoder import OpusDecoder

    cfx = np.load(os.path.join(DATA, "torch_celt20ms_64k.npz"))
    plain = [[bytes([0xF8]) + bytes(cfx["frames"][i, f, :cfx["lens"][i, f]])
              for f in range(3)] for i in range(2)]
    lost = np.array([[True, False, False], [False, True, False]])
    dec = _decoder(2)
    outs = [[], []]
    for f in range(3):
        out, n = dec.tick([p[f] for p in plain], lost[:, f])
        for i in range(2):
            outs[i].append(out[i, :n[i]].numpy())
    assert dec.pending().tolist() == [0, 0] and dec.resumes == 0
    assert len(dec.classic_trace) == 2
    assert dec.classic_trace[1]["branch"].tolist() == [0, 1]
    for i in range(2):
        ref = OpusDecoder(48000, 1)
        r = []
        for f in range(3):
            if lost[i, f]:
                continue
            if f and lost[i, f - 1]:
                r.append(ref.decode(None, 960))
            r.append(ref.decode(plain[i][f]))
        r16 = np.clip(np.floor(np.concatenate(r) * 32768 + 0.5), -32768,
                      32767)
        got = np.concatenate(outs[i]).astype(np.int64)
        assert len(got) == len(r16)
        assert np.abs(got - r16).max() <= CS.CLASSIC_LSB
    assert not outs[0][1][:960].any()


def test_sim_loss_lost_lanes_keep_state_and_report_pending(fx):
    """A lost lane's CELT state does not move and it emits nothing; a loss
    run at the end stays pending."""
    packets = CS.sim_fixture_packets(fx)
    dec = _decoder(2)
    dec.tick([p[0] for p in packets[:2]], np.array([False, False]))
    st = {k: v.clone() for k, v in dec.celt.state.items()
          if torch.is_tensor(v)}
    out, n = dec.tick([p[1] for p in packets[:2]], np.array([True, False]))
    assert n.tolist() == [0, 960] and not out[0].any()
    for k, v in st.items():
        assert torch.equal(dec.celt.state[k][0], v[0])
    assert dec.pending().tolist() == [960, 0]
    assert not dec.err.any()


def test_sim_loss_refuses_other_packets_and_missing_card(fx):
    dec = _decoder(1)
    silk = bytes([0x0 << 3]) + bytes(40)            # SILK NB 10 ms
    with pytest.raises(ValueError):
        dec.tick([silk], np.array([False]))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BatchedLossDecoder(1, *CS.sim_models("cpu"))
