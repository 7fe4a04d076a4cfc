"""The port's generative loss model and per-lane loss flags
(opus_tpu_torch/dnn/lossgen.py, opus_tpu_torch/tools/loss.py) against the
JAX package's (opus_tpu/dnn/lossgen.py, ``opus_demo._loss_flags``) on the
CPU, lane by lane.

Flags are integers: every one must be equal.  The JAX ``LossGen`` runs its
GRU through XLA one step at a time (~12 ms a step on one CPU core, 1000 of
them in the burn-in), so its flags come from tests/data/torch_sim_loss.npz
(tools/make_torch_sim_loss_fixture.py): 8 seeds x 200 steps after the
burn-in on one model (``random_model(33)``, opus_demo's stand-in), and
``_loss_flags(40, 0, 10, ...)`` for two seeds, each with its own
``random_model(seed)``.  The i.i.d. and loss-file sources run live.
"""

import os

import numpy as np
import pytest
import torch

from opus_tpu.dnn import lossgen as JL
from opus_tpu.dnn import weights as JW
from opus_tpu.tools.opus_demo import _loss_flags
from opus_tpu_torch import convert
from opus_tpu_torch.dnn import lossgen as PL
from opus_tpu_torch.dnn import weights as PW
from opus_tpu_torch.tools.loss import loss_flags

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(DATA, "torch_sim_loss.npz"))


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """random_model(33) written as a weight blob by the port."""
    path = tmp_path_factory.mktemp("lossgen") / "lossgen.bin"
    model = PL.random_model(33, device="cpu")
    path.write_bytes(PW.write_blob(PL.model_to_arrays(model)))
    return str(path)


@pytest.mark.parametrize("source", ["random_model", "convert", "blob"])
def test_lossgen_model_equals_jax(blob, source):
    """The port's model equals JAX's random_model(33) array for array, by
    the port's ``random_model``, the converter and the port's blob read
    back."""
    jm = JL.random_model(33)
    if source == "random_model":
        pm = PL.random_model(33, device="cpu")
    elif source == "convert":
        pm = convert.lossgen_from_jax(jm)
    else:
        pm = PL.model_from_arrays(PW.parse_blob(open(blob, "rb").read()),
                                  device="cpu")
        jb = JL.model_from_arrays(JW.parse_blob(open(blob, "rb").read()))
        for a, b in zip(jb, jm):
            assert np.array_equal(np.asarray(a.w), np.asarray(b.w))
    for pl, jl in zip(pm, jm):
        assert np.array_equal(pl.w.numpy(), np.asarray(jl.w))
        assert np.array_equal(pl.bias.numpy(), np.asarray(jl.bias))


def test_batched_lossgen_equals_jax_lane_by_lane(fx):
    """8 lanes, one shared model, each lane its own seed: every flag of 200
    steps after the burn-in equals the JAX LossGen's."""
    gen = PL.BatchedLossGen(PL.random_model(33, device="cpu"),
                            fx["lg_seeds"], device="cpu")
    got = torch.stack([gen.sample(10.0) for _ in range(200)], 1).numpy()
    assert np.array_equal(got, fx["lg_flags"])
    print(f"BatchedLossGen: {got.size} flags equal, loss share "
          f"{got.mean():.3f} (the random model ignores the 10% it is given)")


@pytest.mark.parametrize("source", ["iid", "lossfile", "lossfiles",
                                    "sim_loss_per_seed", "sim_loss_blob",
                                    "none"])
def test_loss_flags_equal_jax(fx, blob, tmp_path, source):
    """Lane i of tools/loss.py equals opus_demo._loss_flags with seed =
    seeds[i], from each source."""
    n = 40
    if source == "iid":
        seeds = [3, 4, 5]
        got = loss_flags(n, seeds, loss_perc=10.0, device="cpu")
        ref = np.stack([_loss_flags(n, 10.0, 0, None, None, seed=s)
                        for s in seeds])
    elif source in ("lossfile", "lossfiles"):
        rng = np.random.default_rng(9)
        paths = []
        for k, m in enumerate((25, 60)):
            p = tmp_path / f"loss{k}.txt"
            p.write_text("\n".join(str(int(v)) for v in rng.random(m) < 0.3)
                         + "\n")
            paths.append(str(p))
        if source == "lossfile":
            paths = paths[:1] * 2
        got = loss_flags(n, [1, 2], loss_perc=50.0, lossfile=paths,
                         device="cpu")
        ref = np.stack([_loss_flags(n, 50.0, 0, p, None) for p in paths])
    elif source == "sim_loss_per_seed":
        got = loss_flags(n, fx["lf_seeds"], sim_loss_perc=10.0, device="cpu")
        ref = fx["lf_flags"]
    elif source == "sim_loss_blob":
        got = loss_flags(n, fx["lg_seeds"], sim_loss_perc=10.0,
                         weights=blob, device="cpu")
        ref = fx["lg_flags"][:, :n]
    else:
        got = loss_flags(n, [1, 2], device="cpu")
        ref = np.zeros((2, n), bool)
    assert got.dtype == torch.bool and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)


def test_lossgen_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        PL.BatchedLossGen(PL.random_model(33, device="cpu"), [1])
