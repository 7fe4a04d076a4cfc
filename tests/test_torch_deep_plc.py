"""The port's deep PLC with DRED (opus_tpu_torch/dnn/{plc,dred_dec}.py,
opus_tpu_torch/models/deep_plc.py) against the JAX package's
(opus_tpu/dnn/{plc,dred_dec}.py, ``OpusDecoder.load_deep_plc`` +
``dred_decode``) on the CPU, a few lanes against as many JAX instances,
and against tests/data/torch_deep_plc.npz (the JAX outputs of
chip_smoke.py's deep-PLC sequence, tools/make_torch_deep_plc_fixture.py).
Models from seeds: PLC 44, pitch DNN 45, FARGAN 46, RDOVAE decoder 42,
DRED statistics 43.

Integer decisions must be equal, and each test prints how many it held:
the FEC-or-prediction choice (the FEC read position), the skip and loss
counters, the FARGAN period of every concealed frame and the pitch period
of every analysed frame.  Bounds:

- int16 PCM at 16 kHz within 1 LSB: FARGAN's f32 output differs from
  XLA's by the order of the GEMM sums (~1e-7 of full scale, 0.003 LSB),
  which moves a rounding now and then;
- at 48 kHz within PLC_LSB_48K = 4 LSB (chip_smoke.py): the upsampler,
  bit-exact here, maps a 1-LSB step at 16 kHz to at most the largest
  per-phase sum of its |h| (3.02) plus its own rounding;
- features within FEAT_ATOL 1e-4 where the analysed PCM is the same
  (tests/test_torch_dnn_features.py), PLC_FEAT_TOL 2e-3 after concealed
  PCM with 1-LSB differences re-enters the analysis (chip_smoke.py; the
  CPU measures 4e-5);
- the DRED features (RDOVAE) within the DRED path's rtol 2e-4 / atol 2e-5
  (tests/test_torch_dred_recovery.py).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from opus_tpu.dnn import dred as JD
from opus_tpu.dnn import dred_dec as JDD
from opus_tpu.dnn import fargan as JFG
from opus_tpu.dnn import pitchdnn as JP
from opus_tpu.dnn import plc as JPL
from opus_tpu.dnn import rdovae as JR
from opus_tpu.dnn import weights as JW
from opus_tpu.models.opus_decoder import OpusDecoder
from opus_tpu.silk.resampler import Resampler
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import dred as PD
from opus_tpu_torch.dnn import dred_dec as PDD
from opus_tpu_torch.dnn import fargan as PFG
from opus_tpu_torch.dnn import plc as PPL
from opus_tpu_torch.dnn import rdovae as PR
from opus_tpu_torch.dnn import weights as PW
from opus_tpu_torch.models.deep_plc import BatchedDeepPLC
from opus_tpu_torch.silk import resampler as PRS

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FEAT_ATOL = 1e-4
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def jax_models():
    return (JPL.random_model(44), JP.random_model(45), JFG.random_model(46))


@pytest.fixture(scope="module")
def port_models():
    return CS.plc_models("cpu")


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(os.path.join(DATA, "torch_deep_plc.npz")))


@pytest.fixture(scope="module")
def dred_fx():
    return dict(np.load(os.path.join(DATA, "torch_dred_recovery.npz")))


@pytest.fixture(scope="module")
def dred_packets(dred_fx):
    return [bytes(dred_fx["packets"][i, :dred_fx["lens"][i]])
            for i in range(len(dred_fx["lens"]))]


@pytest.fixture(scope="module")
def dred_decoders():
    return (JDD.OpusDREDDecoder(JR.random_dec_model(42), JD.random_stats(43)),
            PDD.OpusDREDDecoder(PR.random_dec_model(42, device="cpu"),
                                PD.random_stats(43), device="cpu"))


def _jax_dred(jdd, dred_fx, packets, i):
    """The JAX package's processed OpusDRED of DRED-fixture packet i, its
    features taken from the fixture's stored RDOVAE output (the JAX
    ``rdovae_decode_frames`` of the same latents; ``process`` itself
    compiles its scan anew on every call); an empty one where the packet
    carries no DRED."""
    d, _ = jdd.parse(packets[i], 16000, 16000)
    if d is None:
        return JDD.OpusDRED(2, 0, 0, None, None,
                            np.zeros((0, 20), np.float32))
    q = dred_fx["qframes"][:d.nb_latents, i].reshape(-1, 20)
    return d._replace(process_stage=2, fec_features=q)


def _pcm_close(got, ref, lsb, what):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
    assert d.max() <= lsb, (what, int(d.max()))
    return int(d.max())


def test_torch_compute_plc_pred_matches_jax(jax_models, port_models):
    jm, pm = jax_models[0], port_models[0]
    rng = np.random.default_rng(2)
    b = 3
    jnet = [JPL._zero_net() for _ in range(b)]
    pnet = (torch.zeros(b, 128), torch.zeros(b, 128))
    err = 0.0
    for _ in range(6):
        x = rng.standard_normal((b, PPL.PLC_INPUT)).astype(np.float32)
        pnet, pout = PPL.compute_plc_pred(pm, pnet, torch.from_numpy(x))
        for i in range(b):
            jnet[i], jout = JPL.compute_plc_pred(jm, jnet[i], x[i])
            err = max(err, np.abs(pout[i].numpy() - jout).max(),
                      np.abs(pnet[1][i].numpy() - np.asarray(jnet[i][1])).max())
    print(f"compute_plc_pred: max err {err:.3g} over 6 steps")
    assert err <= FEAT_ATOL


def test_torch_plc_model_blob_and_convert_round_trip(jax_models, port_models):
    jm, pm = jax_models[0], port_models[0]
    blob = JW.write_blob(JPL.model_to_arrays(jm))
    assert PW.write_blob(PPL.model_to_arrays(pm)) == blob
    back = PPL.model_from_arrays(PW.parse_blob(blob), device="cpu")
    conv = convert.plc_from_jax(jm)
    for a, b, c in zip(pm, back, conv):
        for x, y, z in zip(a, b, c):
            assert (x is None) == (y is None) == (z is None)
            if x is not None:
                assert np.array_equal(x.numpy(), y.numpy())
                assert np.array_equal(x.numpy(), z.numpy())


def test_torch_upsampler_10ms_pieces_equal_scalar_resampler():
    """dred_decode's 48 kHz output: ``upsample_to_48k(frame_ms=10)`` on
    160-sample pieces, state carried, equals ``Resampler(16000, 48000)
    .process`` called the same way (opus_decoder.py:108), full-scale lanes
    included."""
    rng = np.random.default_rng(9)
    x = np.clip(rng.standard_normal((3, 6, 160)) * 9000, -32768,
                32767).astype(np.int64)
    x[0] = rng.choice([32767, -32768], size=(6, 160))
    st = PRS.upsampler_init(3, 16)
    outs = []
    for f in range(6):
        o, st = PRS.upsample_to_48k(torch.from_numpy(x[:, f]), st, 16,
                                    frame_ms=10)
        outs.append(o.numpy())
    for i in range(3):
        rs = Resampler(16000, 48000)
        for f in range(6):
            assert np.array_equal(outs[f][i], rs.process(
                [int(v) for v in x[i, f]])), (i, f)


def test_torch_upsampler_one_lsb_step_within_48k_bound():
    """The 48 kHz bound: the upsampler's impulse response (a 2**14 impulse
    scaled back) has per-phase sums of |h| of 3.02, so +-1 LSB differences
    at 16 kHz move a 48 kHz sample by less than 3.02 plus the output
    rounding, an integer of at most 4: PLC_LSB_48K.  A single 1-LSB step on a busy
    signal, at every position of a 10 ms piece, moves it by at most 2."""
    n = 160 * 6
    imp = np.zeros((1, n), np.int64)
    imp[0, 400] = 1 << 14
    rng = np.random.default_rng(6)
    base = np.round(rng.standard_normal(n) * 3000).astype(np.int64)
    x = np.repeat(base[None], 161, axis=0)
    x[np.arange(160), 320 + np.arange(160)] += 1
    outs = []
    for sig in (imp, x):
        st = PRS.upsampler_init(len(sig), 16)
        out = []
        for f in range(6):
            o, st = PRS.upsample_to_48k(
                torch.from_numpy(sig[:, f * 160:(f + 1) * 160]), st, 16,
                frame_ms=10)
            out.append(o.numpy())
        outs.append(np.concatenate(out, axis=1))
    h = outs[0][0] / float(1 << 14)
    phase_sum = max(np.abs(h[p::3]).sum() for p in range(3))
    step = np.abs(outs[1][:160] - outs[1][160]).max()
    print(f"upsampler: per-phase sum |h| {phase_sum:.4f}, a 1-LSB step "
          f"moves the output by at most {step} LSB")
    assert int(phase_sum) + 1 <= CS.PLC_LSB_48K
    assert step <= 2


def test_torch_dred_parse_process_and_batch_match_jax(dred_fx, dred_packets,
                                                      dred_decoders):
    """parse exact (offsets, latents, state, end); process against the
    live JAX ``process`` on packet 0 and against the JAX features stored
    in the DRED fixture on every packet; process_batch == process."""
    jdd, pdd = dred_decoders
    pds = []
    for i, p in enumerate(dred_packets):
        jd, jend = jdd.parse(p, 16000, 16000)
        pd, pend = pdd.parse(p, 16000, 16000)
        assert (jd is None) == (pd is None) and jend == pend
        pds.append(pd)
        if jd is None:
            continue
        assert (jd.dred_offset, jd.nb_latents) == (pd.dred_offset,
                                                   pd.nb_latents)
        assert np.array_equal(jd.latents, pd.latents)
        assert np.array_equal(jd.state, pd.state)
        pf = pdd.process(pd).fec_features.numpy()
        np.testing.assert_allclose(
            pf, _jax_dred(jdd, dred_fx, dred_packets, i).fec_features,
            rtol=RTOL, atol=ATOL)
        if i == 0:
            np.testing.assert_allclose(pf, jdd.process(jd).fec_features,
                                       rtol=RTOL, atol=ATOL)
    batch = pdd.process_batch(pds)
    for i, d in enumerate(pds):
        if d is None:
            assert batch.nb_latents[i] == 0
            continue
        n = 4 * d.nb_latents
        np.testing.assert_allclose(batch.fec_features[i, :n].numpy(),
                                   pdd.process(d).fec_features.numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blend", [0, 1])
def test_torch_feed_dred_fec_per_lane_offsets(jax_models, port_models,
                                              dred_fx, dred_packets,
                                              dred_decoders, blend):
    """Each lane at its own offset: rows inside the DRED window, offsets
    past it (skips first) and before it (nothing), a lane without DRED."""
    jdd, pdd = dred_decoders
    lanes = [0, 1, 2, 8]
    offs = np.array([2 * 480 + 7, 30 * 480, 0, 5 * 480])     # fs 48000
    jplc = [JPL.LPCNetPLC(*jax_models) for _ in lanes]
    pplc = PPL.LPCNetPLC(*port_models, len(lanes), device="cpu")
    dreds = []
    for k, i in enumerate(lanes):
        d, _ = pdd.parse(dred_packets[i], 16000, 16000)
        dreds.append(d)
        jd = _jax_dred(jdd, dred_fx, dred_packets, i)
        jplc[k].blend = blend
        JDD.feed_dred_fec(jplc[k], jd, int(offs[k]), 48000, 960)
    pplc.blend = torch.full((len(lanes),), blend, dtype=torch.int64)
    PDD.feed_dred_fec(pplc, pdd.process_batch(dreds), offs, 48000, 960)
    fill = [j.fec_fill_pos for j in jplc]
    assert pplc.fec_fill_pos.tolist() == fill
    assert pplc.fec_skip.tolist() == [j.fec_skip for j in jplc]
    assert pplc.fec_read_pos.tolist() == [0] * len(lanes)
    for k, j in enumerate(jplc):
        np.testing.assert_allclose(pplc.fec[k, :fill[k]].numpy(),
                                   j.fec[:fill[k]], rtol=RTOL, atol=ATOL)
    print(f"feed_dred_fec (blend {blend}): rows {fill}, skips "
          f"{pplc.fec_skip.tolist()} equal on {len(lanes)} lanes")
    assert max(fill) > 0 and max(pplc.fec_skip.tolist()) > 0


@pytest.fixture(scope="module")
def long_loss(jax_models, port_models):
    """Two lanes through 16 good frames, per-lane FEC (lane 0: a row, a
    skip, a row; lane 1: a skip, a row), 12 concealed frames (past the
    10-frame attenuation), 1 good frame and 1 more concealed frame (a
    catch-up with analysis_pos >= predict_pos); the port's run, JAX's, and
    a port instance converted from JAX's state after the 12th frame."""
    b = 2
    h = CS.speech_history(b, 21)
    rows = np.random.default_rng(4).standard_normal((3, 20)) \
        .astype(np.float32) * 0.5
    jp = [JPL.LPCNetPLC(*jax_models) for _ in range(b)]
    pp = PPL.LPCNetPLC(*port_models, b, device="cpu")
    for k in range(16):
        for i in range(b):
            jp[i].update(h[i, k])
        pp.update(torch.from_numpy(h[:, k]))
    jp[0].fec_add(rows[0])
    jp[0].fec_add(None)
    jp[0].fec_add(rows[1])
    jp[1].fec_add(None)
    jp[1].fec_add(rows[2])
    one = torch.ones(b, dtype=torch.bool)
    lane0 = torch.tensor([True, False])
    pp.fec_add(torch.from_numpy(np.stack([rows[0], rows[0]])), lanes=lane0)
    pp.fec_add(None)
    pp.fec_add(torch.from_numpy(np.stack([rows[1], rows[2]])), present=one)
    log = dict(jax=[], port=[], conv=[])

    def step(kind, inst):
        if kind == "jax":
            outs = []
            for j in inst:
                o = np.zeros(160, np.int16)
                j.conceal(o)
                outs.append(o)
            return (np.stack(outs), np.stack([j.features for j in inst]),
                    [j.fec_read_pos for j in inst],
                    [j.fec_skip for j in inst], [j.loss_count for j in inst])
        o = inst.conceal()
        return (o.numpy(), inst.features.numpy(), inst.fec_read_pos.tolist(),
                inst.fec_skip.tolist(), inst.loss_count.tolist())

    for _ in range(12):
        log["jax"].append(step("jax", jp))
        log["port"].append(step("port", pp))
    conv = convert.lpcnet_state_from_jax(jp, "cpu")
    for i in range(b):
        jp[i].update(h[i, 16])
    pp.update(torch.from_numpy(h[:, 16]))
    conv.update(torch.from_numpy(h[:, 16]))
    log["jax"].append(step("jax", jp))
    log["port"].append(step("port", pp))
    log["conv"].append(step("port", conv))
    return log


def test_torch_lpcnet_conceal_pcm_and_fec_choice_match_jax(long_loss):
    """Every concealed frame: PCM within 1 LSB, FEC-or-prediction choice,
    skip and loss counters equal; a pending skip before a queued row."""
    err = 0
    for t, (j, p) in enumerate(zip(long_loss["jax"], long_loss["port"])):
        err = max(err, _pcm_close(p[0], j[0], 1, f"frame {t}"))
        assert p[2:] == j[2:], t
        np.testing.assert_allclose(p[1], j[1], atol=CS.PLC_FEAT_TOL)
    reads = [p[2] for p in long_loss["port"]]
    # the catch-up's two predictions take the skip, then a row; the
    # concealed frame takes lane 0's second row and lane 1's prediction
    assert reads[0] == [2, 1] and long_loss["port"][0][3] == [0, 0]
    print(f"LPCNetPLC: {2 * 3 * len(reads)} FEC/skip/loss decisions equal "
          f"over {len(reads)} frames x 2 lanes; PCM max err {err} LSB")


def test_torch_lpcnet_long_loss_attenuation_matches_jax(long_loss):
    """Past 10 lost frames the energy feature falls by 2 a frame more
    (lpcnet_plc.c:200); the FARGAN periods of all frames are equal."""
    loss = [p[4] for p in long_loss["port"]]
    assert max(max(v) for v in loss) >= 10
    pj = np.stack([j[1] for j in long_loss["jax"]])
    pp = np.stack([p[1] for p in long_loss["port"]])
    per_j = np.asarray(JFG.period_from_feature(pj))
    per_p = PFG.period_from_feature(torch.from_numpy(pp)).numpy()
    assert np.array_equal(per_j, per_p)
    late = [t for t, v in enumerate(loss) if min(v) >= 10]
    assert late and np.abs(pp[late, :, 0] - pj[late, :, 0]).max() <= FEAT_ATOL
    print(f"long loss: frames {late} attenuated past 10 losses; "
          f"{per_p.size} FARGAN periods equal")


def test_torch_lpcnet_state_from_jax_continues_like_jax(long_loss):
    """A port LPCNetPLC built from the JAX instances' state after 12
    concealed frames continues (an update, a catch-up conceal) as JAX and
    as the port's own run do."""
    j, p, c = long_loss["jax"][-1], long_loss["port"][-1], \
        long_loss["conv"][-1]
    _pcm_close(c[0], j[0], 1, "converted vs JAX")
    _pcm_close(c[0], p[0], 1, "converted vs port")
    assert c[2:] == j[2:]
    np.testing.assert_allclose(c[1], j[1], atol=CS.PLC_FEAT_TOL)


@pytest.mark.parametrize("fs", [16000, 48000])
def test_torch_batched_deep_plc_dred_decode_matches_jax_decoders(
        jax_models, port_models, dred_fx, dred_packets, dred_decoders, fs):
    """BatchedDeepPLC.dred_decode on 2 lanes (a DRED packet, the packet
    without DRED) against 2 JAX OpusDecoder(fs, 1) with load_deep_plc:
    8 good frames, 20 ms, a good frame, 10 ms."""
    jdd, pdd = dred_decoders
    lanes = [3, 8]
    h = CS.speech_history(len(lanes), 31)
    f10 = fs // 100
    offs = [np.array([3 * f10 + 11, 2 * f10]), np.array([f10, 0])]
    jdec, jd, pd = [], [], []
    for k, i in enumerate(lanes):
        dec = OpusDecoder(fs, 1)
        dec.load_deep_plc(*jax_models)
        jdec.append(dec)
        jd.append(_jax_dred(jdd, dred_fx, dred_packets, i))
        pd.append(pdd.parse(dred_packets[i], 16000, 16000)[0])
    batch = pdd.process_batch(pd)
    plc = BatchedDeepPLC(*port_models, len(lanes), fs=fs, device="cpu")
    lsb = 1 if fs == 16000 else CS.PLC_LSB_48K
    errs = []
    for k in range(8):
        for i, dec in enumerate(jdec):
            dec.lpcnet.update(h[i, k])
        plc.lpcnet.update(torch.from_numpy(h[:, k]))
    for n, (off, size) in enumerate(zip(offs, (2 * f10, f10))):
        if n:
            for i, dec in enumerate(jdec):
                dec.lpcnet.update(h[i, 8])
            plc.lpcnet.update(torch.from_numpy(h[:, 8]))
        ref = np.stack([dec.dred_decode(jd[i], int(off[i]), size)
                        for i, dec in enumerate(jdec)])
        got = plc.dred_decode(batch, off, size).numpy()
        assert got.shape == ref.shape and got.dtype == np.int16
        errs.append(_pcm_close(got, ref, lsb, f"dred_decode {n} at {fs}"))
        assert plc.lpcnet.fec_read_pos.tolist() \
            == [d.lpcnet.fec_read_pos for d in jdec]
    print(f"dred_decode at {fs}: PCM max err {errs} LSB (bound {lsb})")


def test_torch_deep_plc_cpu_run_matches_fixture(fixture, dred_packets,
                                                dred_decoders):
    """chip_smoke.py's deep-PLC sequence on the fixture's 9 streams, the
    port on the CPU against the JAX outputs stored in the fixture, with
    chip_smoke.py's own bounds (compare_plc)."""
    pdd = dred_decoders[1]
    dreds = pdd.process_batch([pdd.parse(p, 16000, 16000)[0]
                               for p in dred_packets])
    out, _ = CS.deep_plc_sequence(CS.plc_models("cpu"), dreds,
                                  fixture["hist"], fixture["off48"],
                                  fixture["off16"], "cpu")
    assert set(out) == set(fixture) - {"hist", "off48", "off16",
                                       "nb_latents"}
    err = CS.compare_plc(out, fixture, "CPU vs the fixture")
    n = sum(out[k].size for k in CS.PLC_INT_KEYS)
    print(f"fixture: {n} integer decisions equal; max err {err}")


def test_torch_batched_deep_plc_refuses_bad_rate_and_missing_card(
        port_models):
    with pytest.raises(ValueError):
        BatchedDeepPLC(*port_models, 2, fs=44100, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BatchedDeepPLC(*port_models, 2)
    with pytest.raises(RuntimeError):
        PDD.OpusDREDDecoder(PR.random_dec_model(42, device="cpu"),
                            PD.random_stats(43))
