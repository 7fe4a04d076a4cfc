"""The port's DRED loss-recovery path (opus_tpu_torch/models/dnn_recovery.py
and the host parse it reaches: bitstream/{range_coder,laplace,packet,
extensions}.py, dnn/{dred,dred_dec}.py) against the JAX package's
(opus_tpu/models/dnn_recovery.py) on the committed fixture
tests/data/torch_dred_recovery.npz: 8 real DRED-bearing packets from the
scalar encoder and one without DRED, with the JAX outputs stored by
tools/make_torch_dred_fixture.py.  Models from the JAX suite's seeds
(RDOVAE decoder 42, statistics 43, FARGAN 46), rebuilt here.

Bounds: the parse (payload, offsets, latents, state) and the playback
rows are exact; the FARGAN pitch periods of every played and priming row
are equal as integers; the recovery PCM is within the JAX suite's own
batched-vs-scalar bound, rtol 2e-4 / atol 2e-5 (tests/test_dnn_recovery.py),
of the live JAX pipeline and of the fixture's stored output (which guards
against a stale fixture).  Measured: within 3.6e-7 (the test prints it)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opus_tpu.dnn import dred as JD
from opus_tpu.dnn import dred_dec as JDD
from opus_tpu.dnn import fargan as JF
from opus_tpu.dnn import rdovae as JR
from opus_tpu.models import dnn_recovery as JRec
from opus_tpu_torch.dnn import dred as PD
from opus_tpu_torch.dnn import dred_dec as PDD
from opus_tpu_torch.dnn import fargan as PF
from opus_tpu_torch.dnn import rdovae as PV
from opus_tpu_torch.models import batched_dnn as PB
from opus_tpu_torch.models import dnn_recovery as PRec

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_dred_recovery.npz")
RTOL, ATOL = 2e-4, 2e-5
FS = 16000


@pytest.fixture(scope="module")
def fx():
    d = dict(np.load(FIXTURE))
    d["list"] = [bytes(d["packets"][i, :d["lens"][i]])
                 for i in range(len(d["lens"]))]
    return d


@pytest.fixture(scope="module")
def port():
    return dict(dec=PV.random_dec_model(42, device="cpu"),
                stats=PD.random_stats(43),
                fargan=PF.random_model(46, device="cpu"))


def _parsed(fx):
    return PRec.ParsedBatch(fx["state0"], fx["latents"], fx["nb_latents"],
                            fx["dred_offset"], fx["has_dred"])


def test_torch_dred_find_payload_and_parse_exact(fx, port):
    """dred_find_payload and parse_batch equal the JAX package's on every
    fixture packet (and the fixture's stored parse): the fixture has DRED
    on 8 streams, a stream without it, and garbage packets parse to no
    DRED."""
    pk = fx["list"]
    for p in pk + [b"", b"\x00", bytes(range(7)) * 9, pk[0][:40]]:
        assert PDD.dred_find_payload(p) == JDD.dred_find_payload(p)
    parsed = PRec.parse_batch(port["stats"], pk + [None], FS, FS)
    jparsed = JRec.parse_batch(JD.random_stats(43), pk + [None], FS, FS)
    for f in PRec.ParsedBatch._fields:
        a, b = getattr(parsed, f), getattr(jparsed, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert np.array_equal(a[:, :len(pk)] if f == "latents"
                              else a[:len(pk)], fx[f]), f
    assert parsed.has_dred[:8].all() and not parsed.has_dred[8:].any()
    assert (parsed.nb_latents[:8] > 0).all()


def test_torch_dred_decode_matches_jax_per_payload(fx, port):
    """dred_decode on each payload: offsets, state and latents exact, and
    at two feature limits (the full window and a cut one)."""
    js = JD.random_stats(43)
    for p in fx["list"][:8]:
        payload, off = PDD.dred_find_payload(p)
        for max_feat in (100, 6):
            a = PD.dred_decode(port["stats"], payload, max_feat, off)
            b = JD.dred_decode(js, payload, max_feat, off)
            assert (a.dred_offset, a.nb_latents) == (b.dred_offset,
                                                     b.nb_latents)
            assert np.array_equal(a.state, b.state)
            assert np.array_equal(a.latents, b.latents)


def test_torch_dred_playback_rows_exact(fx):
    parsed = _parsed(fx)
    cont, play = PRec.playback_rows(parsed, fx["loss_offset"],
                                    int(fx["n_frames"]))
    jcont, jplay = JRec.playback_rows(parsed, fx["loss_offset"],
                                      int(fx["n_frames"]))
    assert np.array_equal(cont, jcont) and np.array_equal(play, jplay)
    assert np.array_equal(cont, fx["cont_idx"])
    assert np.array_equal(play, fx["play_idx"])
    assert (play[:8] >= 0).any() and (play[:8] == -1).any()
    assert (play[8] == -1).all() and (cont[8] == -1).all()


def test_torch_dred_feature_rows_and_periods(fx, port):
    """The RDOVAE qframes of the fixture's latents are within the bound of
    the JAX ones, and the FARGAN pitch period of every feature row the
    recovery reads (played and priming rows) is the same integer."""
    _, q = PB.rdovae_decode_frames(port["dec"],
                                   torch.from_numpy(fx["state0"]),
                                   torch.from_numpy(fx["latents"]))
    np.testing.assert_allclose(q.numpy(), fx["qframes"], rtol=RTOL,
                               atol=ATOL)
    t, b = q.shape[:2]
    feats = q.transpose(0, 1).reshape(b, 4 * t, 20)
    jfeats = fx["qframes"].transpose(1, 0, 2).reshape(b, 4 * t, 20)
    rows = np.concatenate([fx["cont_idx"], fx["play_idx"]], axis=1)
    n = 0
    for i in range(b):
        for r in rows[i][rows[i] >= 0]:
            a = int(JF.period_from_feature(jnp.asarray(jfeats[i, r])))
            p = int(PF.period_from_feature(feats[i, r]))
            assert a == p, (i, r, a, p)
            n += 1
    assert n >= 40, n


def test_torch_dred_recovery_matches_jax(fx, port):
    """BatchedDREDRecovery(device="cpu") against the live JAX pipeline and
    the fixture's stored output, on every lane."""
    parsed = _parsed(fx)
    n_frames = int(fx["n_frames"])
    rec = PRec.BatchedDREDRecovery(port["dec"], port["stats"],
                                   port["fargan"], device="cpu")
    out = rec.recover(parsed, fx["pcm0"], fx["loss_offset"], n_frames)
    assert out.shape == (len(fx["lens"]), n_frames * 160)
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    out = out.numpy()
    jax_rec = JRec.BatchedDREDRecovery(JR.random_dec_model(42),
                                       JD.random_stats(43),
                                       JF.random_model(46))
    live = np.asarray(jax_rec.recover(parsed, fx["pcm0"], fx["loss_offset"],
                                      n_frames))
    np.testing.assert_allclose(out, live, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, fx["pcm"], rtol=RTOL, atol=ATOL)
    print(f"DRED recovery at B={len(out)}: max abs err vs live JAX "
          f"{np.abs(out - live).max():.3g}, vs fixture "
          f"{np.abs(out - fx['pcm']).max():.3g}")


def test_torch_dred_recovery_defaults_to_the_card(port):
    """BatchedDREDRecovery's device defaults to CUDA and, with no card,
    raises instead of running on the CPU."""
    import inspect
    sig = inspect.signature(PRec.BatchedDREDRecovery)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PRec.BatchedDREDRecovery(port["dec"], port["stats"],
                                     port["fargan"])
