"""The port's [B]-lane range decoder (opus_tpu_torch/ops/rc_kernel.py) vs
the scalar coder (opus_tpu/bitstream/range_coder.py): the masked op
fuzz of tests/test_rc_kernel.py, with state and returned bits compared
exactly, plus truncated lengths (reads past ``lens`` return 0)."""

import numpy as np
import pytest
import torch

from opus_tpu.bitstream.range_coder import RangeDecoder, RangeEncoder
from opus_tpu_torch.ops import rc_kernel as T

from test_range_vec import ICDF_T, _gen, _py_encode


def _state_tuple(d, b):
    return (int(d["rng"][b]), int(d["val"][b]), int(d["offs"][b]),
            int(d["nbits_total"][b]), int(d["end_offs"][b]),
            int(d["end_window"][b]), int(d["nend_bits"][b]),
            int(d["rem"][b]))


@pytest.mark.parametrize("seed,trunc", [(3, False), (11, False),
                                        (5, True)])
def test_torch_rc_decoder_exact(seed, trunc):
    B, S, STEPS = 48, 96, 36
    kinds, active, params, values = _gen(seed, B, STEPS)
    pencs = _py_encode(kinds, active, params, values, B, S)
    bufs = np.stack([np.frombuffer(bytes(pe.buf[:S]), np.uint8)
                     for pe in pencs])
    lens = np.full(B, S, np.int64)
    if trunc:
        # cut lanes short: both coders then read zeros past the end,
        # from the front and from the back of the packet
        lens = np.random.default_rng(seed).integers(0, S + 1, B)
    buf = torch.from_numpy(bufs)
    st = torch.from_numpy(lens)
    d = T.rk_init(buf, st)
    pdecs = [RangeDecoder(bytes(bufs[b][:lens[b]])) for b in range(B)]
    for t in range(STEPS):
        am = torch.from_numpy(active[t])
        k = kinds[t]
        pv = torch.from_numpy(params[t].astype(np.int64))
        if k == 0:
            fs, d = T.rk_decode(d, pv, am)
            d = T.rk_update(d, buf, st, fs, fs + 1, pv, am)
            ref = []
            for b in range(B):
                w = 0
                if active[t, b]:
                    w = pdecs[b].decode(int(params[t][b]))
                    pdecs[b].update(w, w + 1, int(params[t][b]))
                ref.append(w)
            got = fs
        elif k == 1:
            got, d = T.rk_dec_bit_logp(d, buf, st, int(params[t][0]), am)
            ref = [pdecs[b].dec_bit_logp(int(params[t][b]))
                   if active[t, b] else 0 for b in range(B)]
        elif k == 2:
            got, d = T.rk_dec_icdf(d, buf, st, ICDF_T, 4, am)
            ref = [pdecs[b].dec_icdf(ICDF_T, 4) if active[t, b] else 0
                   for b in range(B)]
        elif k == 3:
            got, d = T.rk_dec_bits(d, buf, st, torch.where(am, pv, 0), am)
            ref = [pdecs[b].dec_bits(int(params[t][b]))
                   if active[t, b] else 0 for b in range(B)]
        else:
            got, d = T.rk_dec_uint(d, buf, st, pv, am)
            ref = [pdecs[b].dec_uint(int(params[t][b]))
                   if active[t, b] else 0 for b in range(B)]
        assert got.tolist() == ref, f"step {t} kind {k}"
    tell = T.rk_tell(d)
    tell_frac = T.rk_tell_frac(d)
    for b in range(B):
        p = pdecs[b]
        assert _state_tuple(d, b) == (p.rng, p.val, p.offs, p.nbits_total,
                                      p.end_offs, p.end_window,
                                      p.nend_bits, p.rem), f"lane {b}"
        assert int(tell[b]) == p.tell()
        assert int(tell_frac[b]) == p.tell_frac()
        assert int(d["error"][b]) == int(p.error != 0), f"lane {b} error"


def test_torch_rc_per_lane_logp_and_bin():
    """Per-lane logp tensors and rk_decode_bin vs the scalar coder."""
    rng = np.random.default_rng(9)
    B, S = 32, 64
    pencs = [RangeEncoder(S) for _ in range(B)]
    seq = []
    for _ in range(24):
        logp = rng.integers(1, 9, B)
        bit = rng.integers(0, 2, B)
        ftb = int(rng.integers(2, 10))
        v = rng.integers(0, 1 << ftb, B)
        seq.append((logp, bit, ftb, v))
        for b in range(B):
            pencs[b].enc_bit_logp(int(bit[b]), int(logp[b]))
            pencs[b].encode_bin(int(v[b]), int(v[b]) + 1, ftb)
    for pe in pencs:
        pe.done()
    bufs = np.stack([np.frombuffer(bytes(pe.buf[:S]), np.uint8)
                     for pe in pencs])
    buf = torch.from_numpy(bufs)
    st = torch.full((B,), S, dtype=torch.int64)
    d = T.rk_init(buf, st)
    for logp, bit, ftb, v in seq:
        r, d = T.rk_dec_bit_logp(d, buf, st, torch.from_numpy(logp))
        fs, d = T.rk_decode_bin(d, ftb)
        d = T.rk_update(d, buf, st, fs, fs + 1, 1 << ftb)
        assert r.tolist() == bit.tolist()
        assert fs.tolist() == v.tolist()


def test_torch_pack_words_matches_jax_layout():
    from opus_tpu.ops import rc_kernel as K
    rng = np.random.default_rng(4)
    bufs = rng.integers(0, 256, (5, 37)).astype(np.uint8)
    assert np.array_equal(T.pack_words(bufs, 40), K.pack_words(bufs, 40))


def _random_icdf(rng, width):
    """A descending iCDF (ftb 8) of random length <= width, zero-padded."""
    n = int(rng.integers(2, width + 1))
    cuts = np.sort(rng.choice(np.arange(1, 256), n - 1, replace=False))
    row = np.zeros(width, np.int64)
    row[:n - 1] = cuts[::-1]
    return row


@pytest.mark.parametrize("seed", [1, 6])
def test_torch_rc_icdf_tensor_tables_exact(seed):
    """rk_dec_icdf with tensor tables, one row per lane ([B, T]) and shared
    ([T]), masked, on truncated and full lanes: symbols and the final state
    exact against the scalar coder (range_vec.rd_dec_icdf's threshold
    count and gather)."""
    rng = np.random.default_rng(seed)
    B, S, STEPS, W = 40, 80, 48, 18
    steps = []
    for _ in range(STEPS):
        shared = bool(rng.random() < 0.3)
        rows = np.stack([_random_icdf(rng, W)] * B) if shared else \
            np.stack([_random_icdf(rng, W) for _ in range(B)])
        nsym = (rows > 0).sum(axis=1) + 1
        vals = (rng.random(B) * nsym).astype(np.int64)
        steps.append((shared, rows, vals, rng.random(B) < 0.8))
    pencs = [RangeEncoder(S) for _ in range(B)]
    for shared, rows, vals, act in steps:
        for b in range(B):
            if act[b]:
                pencs[b].enc_icdf(int(vals[b]), tuple(rows[b].tolist()), 8)
    for pe in pencs:
        pe.done()
    bufs = np.stack([np.frombuffer(bytes(pe.buf[:S]), np.uint8)
                     for pe in pencs])
    lens = np.where(np.arange(B) % 5 == 4, rng.integers(0, S, B), S)
    buf, st = torch.from_numpy(bufs), torch.from_numpy(lens)
    d = T.rk_init(buf, st)
    pdecs = [RangeDecoder(bytes(bufs[b][:lens[b]])) for b in range(B)]
    for t, (shared, rows, vals, act) in enumerate(steps):
        tab = torch.from_numpy(rows[0] if shared else rows)
        got, d = T.rk_dec_icdf(d, buf, st, tab, 8, torch.from_numpy(act))
        ref = [pdecs[b].dec_icdf(tuple(rows[b].tolist()), 8) if act[b]
               else 0 for b in range(B)]
        assert got.tolist() == ref, f"step {t}"
        full = lens == S
        assert (got.numpy()[full & act] == vals[full & act]).all()
    for b in range(B):
        p = pdecs[b]
        assert _state_tuple(d, b) == (p.rng, p.val, p.offs, p.nbits_total,
                                      p.end_offs, p.end_window,
                                      p.nend_bits, p.rem), f"lane {b}"
