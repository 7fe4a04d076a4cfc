"""10 ms CELT (LM 2, 480 samples at 48 kHz) through the port on the CPU,
against the JAX package's 10 ms fixtures (written by
tools/make_torch_celt10ms_fixture.py):

- encode, tests/data/torch_celt10ms_64k_enc.npz (the JAX kernel encoder's
  CPU twin at 480 samples and 80 bytes, 8 streams x 8 frames):
  - the front end from the JAX state before each frame: integer
    decisions equal, X within the MDCT's f32 budget (as
    tests/test_torch_celt_enc_front.py at 20 ms);
  - the plain symbol pass (K3's plain version) on the JAX front end's
    outputs: payload bytes, final range and error flag identical on
    every lane-frame, and the next frame's JAX state carried;
  - ``KernelCeltEncoder(frame_size=480, nbytes=80, device="cpu")`` with
    its own state carried: final ranges and error flags identical on
    every lane-frame; the payloads differ only where the pulse search
    meets a near-tie that the front end's f32 sums (in torch's order, not
    XLA's) resolve the other way, as at 20 ms (the count is printed), and
    the scalar decoder (bit-exact with libopus) reaches the encoder's
    final range on every lane-frame, each stream's SNR within 1 dB of the
    JAX twin's;
- decode, tests/data/torch_celt10ms_64k.npz (the scalar encoder's
  80-byte packets): ``KernelCeltDecoder(frame_size=480, device="cpu")``
  reaches the scalar decoder's final range on every lane-frame, PCM
  within PCM_ABS_TOL = 1e-4 (chip_smoke.py derives it), and the port's
  encoder feeds the port's decoder to the same final range.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import PCM_ABS_TOL
from opus_tpu_torch.models import celt_enc_fused as EF
from opus_tpu_torch.models import celt_enc_kernel as CK
from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder
from opus_tpu_torch.quality import best_snr

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ENC_FIXTURE = os.path.join(DATA, "torch_celt10ms_64k_enc.npz")
DEC_FIXTURE = os.path.join(DATA, "torch_celt10ms_64k.npz")
N, NBYTES = 480, 80
MDCT_REL = 1.5e-4      # tests/test_torch_celt_enc_front.py's budget
INT_KEYS = ("is_transient", "tf_res", "tf_select", "offsets_cnt",
            "spread_calc", "trim_calc")


@pytest.fixture(scope="module")
def efx():
    return dict(np.load(ENC_FIXTURE))


def _jax_state(fx, f: int, tabs) -> dict:
    st = {}
    for k in EF.fused_celt_enc_init(1, tabs, "cpu"):
        v = torch.as_tensor(fx["st_" + k][f])
        st[k] = v.to(torch.int64) if v.dtype == torch.int32 else v
    return st


def _jax_inputs(fx, f: int):
    ins = {k: torch.as_tensor(fx["in_" + k][f]) for k in CK.FIN_KEYS}
    for k in CK.IIN_KEYS[1:]:
        ins[k] = torch.as_tensor(fx["in_" + k][f]).to(torch.int64)
    ins["silence"] = torch.as_tensor(fx["fr_silence"][f]).to(torch.int64)
    return torch.as_tensor(fx["X"][f]), ins


def test_torch_celt10ms_front_end_matches_jax(efx):
    tabs = CK.enc_tabs(48000, N)
    ns = efx["pcm"].shape[0]
    transients = 0
    for f in range(efx["pcm"].shape[1]):
        st = _jax_state(efx, f, tabs)
        pcm = torch.as_tensor(efx["pcm"][:, f])
        ins, X, front = CK._front_end(pcm, st, tabs, NBYTES)
        for k in INT_KEYS + ("prev_cb", "consec_transient"):
            assert np.array_equal(ins[k].numpy(), efx["in_" + k][f]), (f, k)
        assert np.array_equal(ins["silence"].numpy() != 0,
                              efx["fr_silence"][f])
        dsp = EF._encode_dsp(pcm, st["mem"], st["hist"], tabs,
                             torch.zeros(ns, dtype=torch.bool))
        tr = front["is_transient"][:, None]
        be = torch.where(tr, dsp["be_s"], dsp["be_l"]).numpy().astype(
            np.float64)
        scale = MDCT_REL * dsp["full"].abs().amax(dim=1).numpy()[:, None] \
            / be
        dx = np.abs(X.numpy() - efx["X"][f])
        assert (dx <= scale[:, tabs.band_map[:tabs.nx_rows]] + 1e-6).all()
        transients += int(ins["is_transient"].sum())
    assert transients > 0


def test_torch_celt10ms_symbols_match_jax_twin(efx):
    """K3's plain version at LM 2 on the JAX front end's outputs, frame by
    frame, with the JAX twin's state carry checked on the next frame."""
    tabs = CK.enc_tabs(48000, N)
    nf = efx["X"].shape[0]
    for f in range(nf):
        X, ins = _jax_inputs(efx, f)
        out = CK.encode_frame_plain(X, ins, tabs, NBYTES)
        assert np.array_equal(out["payload"].numpy(), efx["payload"][f]), f
        assert np.array_equal(out["rng"].numpy(),
                              efx["rng"][f].astype(np.int64)), f
        assert np.array_equal(out["err"].numpy(), efx["err"][f]), f
        if f + 1 < nf:
            sil = efx["fr_silence"][f][:, None]
            old_e = np.where(sil, np.float32(-28.0), out["old_e"].numpy())
            assert np.array_equal(old_e, efx["st_old_band_e"][f + 1])
            assert np.array_equal(out["error"].numpy().clip(-0.5, 0.5),
                                  efx["st_energy_error"][f + 1])
            assert np.array_equal(out["delayed_intra"].numpy(),
                                  efx["st_delayed_intra"][f + 1])


def test_torch_celt10ms_and_20ms_symbol_passes_share_a_process(efx):
    """The device-table cache keys the encoder's band transforms by rate
    and LM: 20 ms, 10 ms and 20 ms symbol passes in one process, in turn,
    each give its JAX twin's bytes (keyed by band alone, the 10 ms pass
    read the 20 ms tables and failed)."""
    fx20 = np.load(os.path.join(DATA, "torch_celt20ms_64k_enc.npz"))
    for fx, n, nbytes in ((fx20, 960, 160), (efx, N, NBYTES),
                          (fx20, 960, 160)):
        X, ins = _jax_inputs(fx, 1)
        out = CK.encode_frame_plain(X, ins, CK.enc_tabs(48000, n), nbytes)
        assert np.array_equal(out["payload"].numpy(), fx["payload"][1]), n


@pytest.fixture(scope="module")
def encoded(efx):
    pcm = efx["pcm"]
    ns, nf, _n = pcm.shape
    enc = CK.KernelCeltEncoder(ns, frame_size=N, nbytes=NBYTES, device="cpu")
    dec = KernelCeltDecoder(ns, frame_size=N, max_payload=NBYTES,
                            device="cpu")
    frames = []
    for f in range(nf):
        payload, rng, err = enc.encode_device(torch.as_tensor(pcm[:, f]))
        _out, derr = dec.decode_packed(payload, torch.full((ns,), NBYTES))
        frames.append((payload.numpy(), rng.numpy(), err.numpy(),
                       dec.state["seed"].numpy(), derr.numpy()))
    return frames


def test_torch_celt10ms_encoder_matches_jax_twin(efx, encoded):
    from opus_tpu.celt.decoder import CeltDecoder

    ns, nf, _n = efx["pcm"].shape
    same = 0
    for f, (payload, rng, err, dec_rng, derr) in enumerate(encoded):
        assert np.array_equal(rng, efx["rng"][f].astype(np.int64)), f
        assert np.array_equal(err, efx["err"][f]), f
        assert not err.any() and not derr.any(), f
        # the port's decoder on the port's packets: the encoder's range
        assert np.array_equal(dec_rng, rng), f
        same += int((payload == efx["payload"][f]).all(axis=1).sum())
    for s in range(ns):
        dec = CeltDecoder.create(48000, 1)
        outs = []
        for f in range(nf):
            out = np.zeros(N)
            assert dec.decode_with_ec(bytes(encoded[f][0][s].tobytes()), out,
                                      N, None) == N
            assert int(dec.rng) & 0xFFFFFFFF == int(encoded[f][1][s]), (s, f)
            outs.append(out.copy())
        snr = best_snr(efx["pcm"][s].reshape(-1), np.concatenate(outs), N)
        assert snr > efx["snr"][s] - 1.0, (s, snr, efx["snr"][s])
    assert same >= ns * nf // 2
    print(f"10 ms payloads byte-identical to the JAX twin: "
          f"{same}/{ns * nf}; final ranges and error flags: all")


def test_torch_celt10ms_decoder_matches_scalar():
    fx = np.load(DEC_FIXTURE)
    frames, lens = fx["frames"], fx["lens"]
    ns, nf, p = frames.shape
    assert p == NBYTES
    dec = KernelCeltDecoder(ns, frame_size=N, max_payload=p, device="cpu")
    worst = 0.0
    for f in range(nf):
        pcm, err = dec.decode_packed(torch.as_tensor(frames[:, f]),
                                     torch.as_tensor(lens[:, f]))
        assert not err.any(), f
        assert np.array_equal(dec.state["seed"].numpy(),
                              fx["final_range"][:, f].astype(np.int64)), f
        e = float(np.abs(pcm[:, 0].numpy() - fx["pcm"][:, f]).max())
        assert e <= PCM_ABS_TOL, (f, e)
        worst = max(worst, e)
    print(f"10 ms decode: every final range equal, PCM max err {worst:.3g}")
