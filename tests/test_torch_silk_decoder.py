"""The port's all-on-device SILK decoder (opus_tpu_torch/models/
fused_silk_dec.py, FusedSilkDecoder on the CPU) against the scalar decoder:
int16 PCM and final range identical on every lane-frame of the committed
fixture (tests/data/torch_silk16k_24k.npz, written by
tools/make_torch_silk_fixture.py from the scalar codec) at WB 20 ms (with
LBRR frames and unvoiced frames), NB, MB and WB 10 ms, with no error lane;
garbage and truncated lanes must not raise.  Also: the port's
silk_decode_step against the JAX batched_silk.silk_decode_step on the
port's own symbol outputs, and the convert.silk_* helpers."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from opus_tpu.models import batched_silk as JB
from opus_tpu.models import fused_silk_dec as JF
from opus_tpu_torch import convert
from opus_tpu_torch.models import batched_silk as PB
from opus_tpu_torch.models import fused_silk_dec as PF

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_silk16k_24k.npz")


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


def _bad_lanes(frames, lens, f, rng, n):
    """n lanes: truncated fixture packets, then random bytes."""
    ns, _nf, p = frames.shape
    buf = np.zeros((n, p), np.uint8)
    ln = np.zeros(n, np.int64)
    for j in range(n):
        if j < n // 2:
            cut = int(rng.integers(0, lens[j % ns, f]))
            buf[j, :cut] = frames[j % ns, f, :cut]
        else:
            cut = int(rng.integers(0, p + 1))
            buf[j, :cut] = rng.integers(0, 256, cut)
        ln[j] = cut
    return buf, ln


@pytest.mark.parametrize("pre,fs_khz,nb_subfr,n_bad", [
    ("", 16, 4, 4), ("nb_", 8, 4, 0), ("mb_", 12, 4, 0),
    ("wb10_", 16, 2, 0)])
def test_torch_silk_decoder_bit_exact(fx, pre, fs_khz, nb_subfr, n_bad):
    frames, lens = fx[pre + "frames"], fx[pre + "lens"]
    xq_ref, rng_ref = fx[pre + "xq"], fx[pre + "final_range"]
    ns, nf, p = frames.shape
    dec = PF.FusedSilkDecoder(ns + n_bad, fs_khz=fs_khz, nb_subfr=nb_subfr,
                              max_payload=p, device="cpu")
    rng = np.random.default_rng(11)
    for f in range(nf):
        bb, bl = _bad_lanes(frames, lens, f, rng, n_bad)
        buf = np.concatenate([frames[:, f], bb])
        ln = np.concatenate([lens[:, f].astype(np.int64), bl])
        xq, err = dec.decode_packed(torch.from_numpy(buf),
                                    torch.from_numpy(ln))
        assert xq.dtype == torch.int16
        assert xq.shape == (ns + n_bad, nb_subfr * 5 * fs_khz)
        assert not err[:ns].any(), f"frame {f}: fixture lane flagged"
        assert np.array_equal(xq[:ns].numpy(), xq_ref[:, f]), f"frame {f}"
        assert dec.final_range[:ns].tolist() == rng_ref[:, f].tolist(), f
    if pre == "":
        # the main set covers LBRR frames and unvoiced/inactive frames
        assert (frames[:, :, 0] & 0x40).any()


def test_torch_silk_decode_step_matches_jax(fx):
    """Two fixture frames at B = 4: the port's symbol pass gives the
    decode_core inputs; the JAX and port silk_decode_step on them (state
    carried across the frames, converted with convert.silk_state_*) agree
    exactly."""
    frames, lens = fx["frames"][:4], fx["lens"][:4]
    state = PF.fused_init_state(4, 16)
    jstate = JB.SilkState(**convert.silk_state_to_numpy(state["synth"]))
    for f in range(2):
        buf = torch.from_numpy(frames[:, f].copy())
        ln = torch.from_numpy(lens[:, f].astype(np.int64))
        step_in, carry, _err, _d = PF.silk_symbols(buf, ln, state)
        xq, synth = PB.silk_decode_step(**step_in, state=state["synth"])
        jin = {k: jnp.asarray(v.numpy().astype(
            np.bool_ if v.dtype == torch.bool else np.int32))
            for k, v in step_in.items()}
        jxq, jstate = JB.silk_decode_step(**jin, state=jstate)
        assert np.array_equal(xq.numpy(), np.asarray(jxq))
        got = convert.silk_state_to_numpy(synth)
        assert np.array_equal(got["slpc"], np.asarray(jstate.slpc))
        assert np.array_equal(got["out_buf"], np.asarray(jstate.out_buf))
        assert np.array_equal(xq.numpy(), fx["xq"][:4, f])
        state = dict(carry, first_frame=torch.zeros(4, dtype=torch.bool),
                     synth=synth)


def test_torch_silk_state_and_tabs_convert(fx):
    """JAX FusedSilkState (numpy leaves) <-> the port's dict, both ways,
    and every _SilkTabs table against the JAX twin's at 8/12/16 kHz and
    10/20 ms."""
    jst = JF.fused_init_state(3, 12)
    np_st = JF.FusedSilkState(
        *[np.asarray(x) for x in jst[:4]],
        JB.SilkState(*[np.asarray(x) for x in jst.synth]))
    port = convert.silk_state_from_jax(np_st)
    ref = PF.fused_init_state(3, 12)
    for k in ("prev_nlsf", "last_gain_index", "prev_gain_q16",
              "first_frame"):
        assert torch.equal(port[k], ref[k]), k
    for k in ("slpc", "out_buf"):
        assert torch.equal(port["synth"][k], ref["synth"][k]), k
    # a decoded state survives the round trip
    dec = PF.FusedSilkDecoder(2, fs_khz=16, max_payload=fx["frames"].shape[2],
                              device="cpu")
    dec.decode_packed(torch.from_numpy(fx["frames"][:2, 0].copy()),
                      torch.from_numpy(fx["lens"][:2, 0].astype(np.int64)))
    back = convert.silk_state_to_numpy(dec.state)
    again = convert.silk_state_from_jax(back)
    for k in ("prev_nlsf", "last_gain_index", "prev_gain_q16",
              "first_frame"):
        assert torch.equal(again[k], dec.state[k]), k
        assert back[k].dtype == np.asarray(getattr(jst, k)).dtype, k
    for k in ("slpc", "out_buf"):
        assert torch.equal(again["synth"][k], dec.state["synth"][k]), k
    synth_only = convert.silk_state_from_jax(JB.SilkState(**back["synth"]))
    assert torch.equal(synth_only["out_buf"], dec.state["synth"]["out_buf"])
    for fs_khz in (8, 12, 16):
        for nb_subfr in (2, 4):
            convert.silk_tabs_from_jax(JF._SilkTabs(fs_khz, nb_subfr))


def test_torch_silk_decoder_defaults_to_the_card():
    """FusedSilkDecoder's device defaults to CUDA and, with no card, raises
    instead of running on the CPU."""
    import inspect
    sig = inspect.signature(PF.FusedSilkDecoder)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PF.FusedSilkDecoder(4)


@pytest.mark.parametrize("fs_khz", [16, 8])
def test_torch_silk_nlsf_to_lpc_matches_jax(fx, fs_khz):
    """NLSF stabilization and NLSF -> LPC (with LPC_fit, the inverse
    prediction gain and the bandwidth-expansion rounds) against the JAX
    twin's outputs stored in the fixture, on seeded NLSF vectors that are
    sorted, clustered, unsorted and extreme, so the stabilizer's fallback
    and the unstable-LPC rounds run too; and the inverse prediction gain on
    random coefficients."""
    pre = f"nlsf{fs_khz}_"
    tabs = PF.silk_tabs(fs_khz)
    nlsf = PF._nlsf_stabilize(torch.from_numpy(
        fx[pre + "in"].astype(np.int64)), tabs.dmin)
    assert np.array_equal(nlsf.numpy(), fx[pre + "stab"])
    a_q12, unstable = PF._nlsf2a(tabs, nlsf)
    assert np.array_equal(a_q12.numpy(), fx[pre + "a_q12"])
    assert np.array_equal(unstable.numpy(), fx[pre + "unstable"])
    assert fx[pre + "unstable"].any() and not fx[pre + "unstable"].all()
    ok = PF._lpc_inverse_pred_gain(torch.from_numpy(
        fx[pre + "lpc_a"].astype(np.int64)), tabs.order)
    assert np.array_equal(ok.numpy(), fx[pre + "lpc_ok"])
