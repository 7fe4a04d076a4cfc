"""The port (opus_tpu_torch) imports nothing of the JAX package and never
jax itself, not even transitively.

Checked in a fresh interpreter, because tests/conftest.py imports jax and
opus_tpu into this one.  The probe imports every module of the port and
chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import opus_tpu_torch
names = ["opus_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    opus_tpu_torch.__path__, "opus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("opus_tpu_torch.models.hybrid_dec_fused",
             "opus_tpu_torch.silk.resampler", "opus_tpu_torch.tools.kbench_ops",
             "opus_tpu_torch.dnn.nnet", "opus_tpu_torch.dnn.weights",
             "opus_tpu_torch.dnn.rdovae", "opus_tpu_torch.dnn.fargan",
             "opus_tpu_torch.dnn.dred", "opus_tpu_torch.dnn.dred_dec",
             "opus_tpu_torch.bitstream.range_coder",
             "opus_tpu_torch.bitstream.laplace",
             "opus_tpu_torch.bitstream.packet",
             "opus_tpu_torch.bitstream.extensions",
             "opus_tpu_torch.models.batched_dnn",
             "opus_tpu_torch.models.dnn_recovery",
             "opus_tpu_torch.dnn.pitchdnn", "opus_tpu_torch.dnn.features",
             "opus_tpu_torch.dnn.plc", "opus_tpu_torch.models.deep_plc",
             "opus_tpu_torch.dnn.nndsp", "opus_tpu_torch.dnn.osce_features",
             "opus_tpu_torch.dnn.osce", "opus_tpu_torch.dnn.dred_enc",
             "opus_tpu_torch.dnn.bbwe",
             "opus_tpu_torch.bitstream.repacketizer",
             "opus_tpu_torch.models.dred_encoder",
             "opus_tpu_torch.dnn.lossgen", "opus_tpu_torch.tools.loss",
             "opus_tpu_torch.tools.sim_loss", "opus_tpu_torch.ops.lanes",
             "opus_tpu_torch.celt.pitch", "opus_tpu_torch.celt.plc",
             "opus_tpu_torch.models.silk_plc",
             "opus_tpu_torch.models.fused_silk_dec",
             "opus_tpu_torch.models.batched_silk",
             "opus_tpu_torch.ops.silk_fixed", "opus_tpu_torch.ops.lpc",
             "opus_tpu_torch.convert",
             "opus_tpu_torch.models.opus_decoder",
             "opus_tpu_torch.utils.soft_clip",
             "opus_tpu_torch.tools.opus_demo",
             "opus_tpu_torch.models.multistream",
             "opus_tpu_torch.models.projection"):
    assert name in names, name
bad = sorted(m for m in sys.modules
             if m in ("jax", "opus_tpu") or m.startswith(("jax.",
                                                          "opus_tpu.")))
print(len(names), "modules;", "forbidden modules:", bad)
sys.exit(1 if bad else 0)
"""


def test_torch_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden modules: []" in proc.stdout


def _same(a, b):
    if isinstance(a, (int, float, str)) or a is None:
        return a == b
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and not isinstance(a[0], (int, float)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_torch_table_copies_equal_jax_originals():
    """Every table in the port's copies of opus_tpu/celt/{tables,cwrs,
    modes}.py and opus_tpu/silk/{tables,tables_data}.py equals the
    original; _INV_TABLE comes from opus_tpu/celt/encoder.py."""
    import opus_tpu.celt.cwrs as jc
    import opus_tpu.celt.encoder as jenc
    import opus_tpu.celt.modes as jm
    import opus_tpu.celt.tables as jt
    import opus_tpu_torch.celt.cwrs as pc
    import opus_tpu_torch.celt.modes as pm
    import opus_tpu_torch.celt.tables as pt

    names = [k for k, v in vars(jt).items()
             if k.isupper() and not callable(v)]
    assert names
    for k in names:
        assert _same(getattr(pt, k), getattr(jt, k)), k
    assert pt._INV_TABLE == jenc._INV_TABLE
    for k, v in vars(jc).items():
        if k.isupper() and not callable(v):
            assert _same(getattr(pc, k), v), k
    for n in range(1, 40):
        for k in range(0, 40):
            assert pc.pvq_u(n, k) == jc.pvq_u(n, k)
            assert pc.pvq_v(n, k) == jc.pvq_v(n, k)
    for frame in (120, 240, 480, 960):
        a, b = pm.mode_create(48000, frame), jm.mode_create(48000, frame)
        for f in ("Fs", "overlap", "nbEBands", "effEBands", "shortMdctSize",
                  "nbShortMdcts", "nbAllocVectors", "maxLM"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("eBands", "logN", "allocVectors", "window", "preemph"):
            assert _same(getattr(a, f), getattr(b, f)), f
        for f in ("size", "index", "bits", "caps"):
            assert _same(getattr(a.cache, f), getattr(b.cache, f)), f
    for i in range(40):
        assert pm.get_pulses(i) == jm.get_pulses(i)

    import opus_tpu.silk.tables as jst
    import opus_tpu.silk.tables_data as jsd
    import opus_tpu_torch.silk.tables as pst
    import opus_tpu_torch.silk.tables_data as psd
    for jmod, pmod in ((jsd, psd), (jst, pst)):
        names = [k for k, v in vars(jmod).items()
                 if k.isupper() and not callable(v)
                 and not isinstance(v, type(jmod))]      # not `T`
        assert names
        for k in names:
            v = getattr(jmod, k)
            if hasattr(v, "__dataclass_fields__"):      # NLSF codebooks
                assert vars(getattr(pmod, k)) == vars(v), k
            else:
                assert _same(getattr(pmod, k), v), k


def test_torch_resampler_constants_equal_jax_originals():
    """The upsampler's copies of the scalar Resampler's constants (the
    decoder delay matrix, the rate ids and the step search) give the
    scalar's input delay and step at every SILK rate."""
    from opus_tpu.silk import resampler as jr
    from opus_tpu_torch.silk import resampler as pr

    assert pr._DELAY_DEC == jr._DELAY_DEC
    for fs in (8000, 12000, 16000, 24000, 48000):
        assert pr._rate_id(fs) == jr._rate_id(fs)
    for fs_khz in (8, 12, 16):
        rs = jr.Resampler(fs_khz * 1000, 48000)
        assert pr.input_delay(fs_khz) == rs.input_delay
        assert pr._inv_ratio_q16(fs_khz * 1000, 48000) == rs.inv_ratio_q16


def test_torch_multistream_copies_equal_jax_originals():
    """The multistream decoder's copy of the Vorbis surround mappings, the
    projection decoder's channel-count helpers and the top-level decoder's
    QEXT extension id equal the originals."""
    from opus_tpu.models import multistream as jm
    from opus_tpu.models import opus_decoder as jo
    from opus_tpu.models import projection as jp
    from opus_tpu_torch.models import multistream as pm
    from opus_tpu_torch.models import opus_decoder as po
    from opus_tpu_torch.models import projection as pp

    assert pm.VORBIS_MAPPINGS == jm.VORBIS_MAPPINGS
    for c in range(1, 9):
        assert pm.default_surround_layout(c) == jm.default_surround_layout(c)
    for c in (1, 4, 6, 9, 11, 16, 18, 25, 36, 49, 64):
        assert pp.order_plus_one_from_channels(c) == \
            jp.order_plus_one_from_channels(c)
        assert pp.streams_from_channels(c) == jp.streams_from_channels(c)
    assert po.QEXT_EXTENSION_ID == jo.QEXT_EXTENSION_ID


def test_torch_dnn_and_bitstream_copies_equal_jax_originals():
    """The port's copies of the DRED constants and quantizer ladder, the
    DRED encoder's resampling filters, the range coder's constants and
    tell table, the Laplace p0 tables, the packet error codes and the DNN
    layer constants equal the originals."""
    import opus_tpu.bitstream.laplace as jl
    import opus_tpu.bitstream.packet as jp
    import opus_tpu.bitstream.range_coder as jr
    import opus_tpu.dnn.dred as jd
    import opus_tpu.dnn.dred_dec as jdd
    import opus_tpu.dnn.dred_enc as jde
    import opus_tpu.dnn.fargan as jf
    import opus_tpu.dnn.nnet as jn
    import opus_tpu.dnn.rdovae as jv
    import opus_tpu.dnn.weights as jw
    import opus_tpu_torch.bitstream.laplace as pl
    import opus_tpu_torch.bitstream.packet as pp
    import opus_tpu_torch.bitstream.range_coder as pr
    import opus_tpu_torch.dnn.dred as pd
    import opus_tpu_torch.dnn.dred_dec as pdd
    import opus_tpu_torch.dnn.dred_enc as pde
    import opus_tpu_torch.dnn.fargan as pf
    import opus_tpu_torch.dnn.nnet as pn
    import opus_tpu_torch.dnn.rdovae as pv
    import opus_tpu_torch.dnn.weights as pw

    for jmod, pmod in ((jr, pr), (jp, pp), (jd, pd), (jdd, pdd), (jde, pde),
                       (jf, pf), (jn, pn), (jv, pv), (jw, pw), (jl, pl)):
        names = [k for k, v in vars(pmod).items()
                 if k.lstrip("_").isupper() and k in vars(jmod)
                 and isinstance(v, (int, float, tuple))]
        assert names or pmod is pl, pmod.__name__
        for k in names:
            assert _same(getattr(pmod, k), getattr(jmod, k)), (pmod, k)
    assert pr._TELL_CORRECTION == jr._TELL_CORRECTION
    assert pd._DQ_TABLE == jd._DQ_TABLE
    assert pde._FILTERS == jde._FILTERS
    for q0 in range(16):
        for dq in range(8):
            for i in range(30):
                assert pd.compute_quantizer(q0, dq, 15, i) \
                    == jd.compute_quantizer(q0, dq, 15, i)
    for decay in range(0, 32768, 97):
        assert pl._p0_icdf(decay) == jl._p0_icdf(decay)
    assert pw._HEAD.format == jw._HEAD.format
    assert pw._DTYPES == jw._DTYPES


def test_torch_osce_copies_equal_jax_originals():
    """The port's copies of the OSCE constants and tables (osce_features'
    band centres and weights, window and DCT; osce's and nndsp's model
    constants) equal the originals."""
    import opus_tpu.dnn.nndsp as jd
    import opus_tpu.dnn.osce as jo
    import opus_tpu.dnn.osce_features as jf
    import opus_tpu_torch.dnn.nndsp as pd
    import opus_tpu_torch.dnn.osce as po
    import opus_tpu_torch.dnn.osce_features as pf

    for jmod, pmod in ((jf, pf), (jo, po), (jd, pd)):
        names = [k for k, v in vars(jmod).items()
                 if k.lstrip("_").isupper() and not callable(v)
                 and not isinstance(v, type(jmod))
                 and (not k.startswith("_") or hasattr(pmod, k))]
        assert names, pmod.__name__
        for k in names:
            assert _same(getattr(pmod, k), getattr(jmod, k)), (pmod, k)
    assert np.array_equal(pf._DCT18, jf._DCT18)
    assert np.array_equal(po.default_numbits_scales(),
                          jo.default_numbits_scales())
    assert np.array_equal(pd.compute_overlap_window(40),
                          jd.compute_overlap_window(40))
    x = np.random.default_rng(0).standard_normal(161)
    for bins, w in ((pf.CENTER_BINS_CLEAN, pf.BAND_WEIGHTS_CLEAN),
                    (pf.CENTER_BINS_NOISY, pf.BAND_WEIGHTS_NOISY)):
        np.testing.assert_allclose(x @ pf.filterbank_matrix(bins, w),
                                   jf.apply_filterbank(x, bins, w),
                                   rtol=1e-13, atol=1e-13)


def test_torch_pitch_copy_equals_jax_original():
    """The port's batched copy of opus_tpu/celt/pitch.py (and the PLC's
    autocorrelation, FIR and IIR, copies of opus_tpu/celt/decoder.py's)
    computes what the original computes lane by lane: the pitch index and
    the top-two picks equal, the float64 signals within 1e-9 relative
    (batched products sum in another order than np.dot)."""
    import torch

    from opus_tpu.celt import decoder as jd
    from opus_tpu.celt import pitch as jp
    from opus_tpu_torch.celt import pitch as pp
    from opus_tpu_torch.celt import plc as pplc

    rng = np.random.default_rng(7)
    t = np.arange(2048)
    xs = []
    for b in range(12):
        f0 = rng.uniform(80, 400)
        x = sum(rng.uniform(0.2, 1) * np.sin(2 * np.pi * f0 * k * t / 48000
                                              + rng.uniform(0, 6))
                for k in range(1, 8))
        xs.append(3000 * x + rng.normal(0, 100 * (b % 3), 2048))
    xs[5][:] = 0.0
    xs = np.array(xs)
    lp = pp.pitch_downsample(torch.from_numpy(xs), 1024)
    margin = {}
    idx = pp.pitch_search(lp[:, 360:], lp, 1328, 620, margin)
    for b in range(len(xs)):
        jlp = jp.pitch_downsample([xs[b]], 1024)
        scale = max(1.0, np.abs(jlp).max())
        assert np.abs(lp[b].numpy() - jlp).max() <= 1e-9 * scale
        assert int(idx[b]) == jp.pitch_search(jlp[360:], jlp, 1328, 620)
    assert (margin["pitch"] >= 0).all()
    ac = rng.standard_normal((6, 25))
    ac[:, 0] = np.abs(ac[:, 0]) + 30.0
    lpc = pp.celt_lpc(torch.from_numpy(ac), 24).numpy()
    for b in range(6):
        assert np.allclose(lpc[b], jp._celt_lpc(ac[b], 24), rtol=1e-9,
                           atol=1e-12)
    xc = rng.standard_normal((6, 40))
    yy = np.abs(rng.standard_normal(80)) * 10
    syy = pp._syy(torch.from_numpy(np.tile(yy, (6, 1))), 40, 40)
    got = pp.find_best_pitch(torch.from_numpy(xc), syy).numpy()
    for b in range(6):
        assert got[b].tolist() == jp._find_best_pitch(xc[b], yy, 40, 40)
    x = rng.standard_normal((3, 1048)) * 1000
    w = torch.from_numpy(jd._window(120))
    ac2 = pplc.windowed_autocorr(torch.from_numpy(x[:, 24:]), w, 120, 24)
    num = rng.standard_normal((3, 24)) * 0.1
    fir = pplc.celt_fir(torch.from_numpy(x), torch.from_numpy(num), 1024)
    mem = rng.standard_normal((3, 24))
    iir = pplc.celt_iir(torch.from_numpy(x[:, :200]), torch.from_numpy(num),
                        torch.from_numpy(mem))
    for b in range(3):
        ref = jd._windowed_autocorr(x[b, 24:], jd._window(120), 120, 24,
                                    1024)
        assert np.allclose(ac2[b].numpy(), ref, rtol=1e-12)
        assert np.allclose(fir[b].numpy(), jd._celt_fir(
            x[b, 24:], x[b, :24], num[b], 1024, 24), rtol=1e-12, atol=1e-9)
        assert np.allclose(iir[b].numpy(), jd._celt_iir(
            x[b, :200], num[b], 200, 24, mem[b]), rtol=1e-9, atol=1e-9)
