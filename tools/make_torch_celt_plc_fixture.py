"""Writes tests/data/torch_celt_plc.npz: the JAX package's classic CELT
packet-loss concealment, the reference of the port's classic PLC
(opus_tpu_torch/celt/plc.py, ``KernelCeltDecoder.conceal``) and of the
classic loops of ``tools/sim_loss.BatchedLossDecoder``
(tests/test_torch_celt_plc.py, tests/test_torch_classic_loss.py,
chip_smoke.py's celt_plc phase).  It reads opus_tpu and never edits it.
Two parts, each in its own process:

1. ``loops``: opus_demo's decode loop (``opus_tpu/tools/opus_demo.py``
   ``decode``, the scalar ``OpusDecoder(48000, 1)``) over the 8 JAX-encoded
   streams of tests/data/torch_sim_loss.npz (``packets``, 24 frames of 20
   ms CELT with DRED), each lane under its own pattern (``lost_flags`` below;
   lanes 5-7 are torch_sim_loss.npz's ``lg_flags`` rows 5-7): plain, with
   ``-inbandfec`` and with ``-dred`` (random models 32-36, as opus_demo
   builds them) over the first ``DRED_FRAMES`` frames, DRED stripped from
   the packets of ``strip`` (the TOC as code 0 and the CELT frame alone).
   Each loop runs twice: through ``opus_demo.decode`` itself (a .bit file
   and a lossfile a stream; its int16 output is the reference) and through
   a replica of the loop that conceals 20 ms at a time and records, per
   frame slot: ``kind`` (0 decoded, 1 classic concealment, 2 DRED, 3 the
   zeros of a lane that has decoded nothing), the final range of each
   decoded packet, the classic concealment's branch (1 periodic, 2
   noise), pitch period and zeroing decision, the int16 of every
   concealed slot (``conc``, kinds 1 and 2, in slot order) and the float
   PCM of the first decoded frame after each concealed run
   (``after_pcm``); the replica's int16 equals opus_demo's on every
   sample, and -inbandfec's equals the plain loop's (a CELT-only stream
   carries no LBRR: its loss is deferred and concealed the same way).
   Snapshots of the scalar CELT state before and after the plain loop's
   concealments in ``SNAPS`` (lane, frame) hold the module tests.
2. ``module10``: 10 ms (LM 2) concealment on tests/data/
   torch_celt10ms_64k.npz's 8 streams: each lane follows a schedule of
   ``SCHED10`` events (p: its next packet, q: frame 0 of stream lane + 1,
   an intra frame after a loss, L: 10 ms concealed) through the scalar
   ``OpusDecoder``: per event the kind, final range, branch, period and
   zeroing decision, the int16 of the concealed events and the float PCM
   of the first decoded event after each concealed run.

Run from the repository root (~1.5 min, 2 processes):
    JAX_PLATFORMS=cpu python tools/make_torch_celt_plc_fixture.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_celt_plc.npz")
SIM_FIXTURE = os.path.join(REPO, "tests", "data", "torch_sim_loss.npz")
FIX10 = os.path.join(REPO, "tests", "data", "torch_celt10ms_64k.npz")
STREAMS, FRAMES, DRED_FRAMES = 8, 24, 12
DBUF = 2048


def lost_flags(lg_flags):
    """[8, 24] bool: lane 0 lost at frames 0-1 (before any decode); 1
    single losses; 2 a run of 7 (five periodic, two noise); 3 a run of 6
    (five periodic, one noise), one good frame, a loss (noise: skip_plc
    holds), two good frames, a loss (periodic again); 4 a single loss and
    a run still open at the end; 5-7 torch_sim_loss.npz's lg_flags."""
    f = np.zeros((STREAMS, FRAMES), bool)
    f[0, [0, 1]] = True
    f[1, [3, 9, 15, 21]] = True
    f[2, 4:11] = True
    f[3, list(range(2, 8)) + [9, 12]] = True
    f[4, [5] + list(range(19, 24))] = True
    f[5:8] = lg_flags[5:8, :FRAMES]
    return f


def strip_mask():
    """[8, 24] bool: packets whose DRED the -dred loop strips: resumes of
    lanes 1-3 and 5-7, so that classic concealment follows a loss there,
    DRED elsewhere."""
    s = np.zeros((STREAMS, FRAMES), bool)
    s[1, [4, 10]] = True
    s[2, 11] = True
    s[3, 8] = True
    s[5:8, 1::4] = True
    return s


SNAPS = ((1, 3), (2, 5), (2, 9), (2, 10), (3, 9), (4, 5))
SCALAR_KEYS = ("loss_duration", "plc_duration", "skip_plc",
               "last_frame_type", "prefilter_and_fold", "last_pitch_index",
               "postfilter_period", "postfilter_period_old",
               "postfilter_tapset", "postfilter_tapset_old",
               "postfilter_gain", "postfilter_gain_old", "decode_mem",
               "oldEBands", "oldLogE", "oldLogE2", "backgroundLogE", "rng",
               "plc_lpc", "preemph_memD")
SCHED10 = ("LLpppLpLLpppLLpL",
           "ppLLLLLLLLLLLLpp",
           "pLLpLLLppLppLLpp",
           "pppLpLLpLLpLLpLp",
           "ppLLqpLppLpLLppL",
           "pLpLLpLppLLLpLpp",
           "pppLLLLppLppLpLL",
           "pLLqLqppLpLLppLp")


def strip(p: bytes) -> bytes:
    """The packet without its padding (and DRED): code 0, the CELT frame."""
    from opus_tpu.bitstream import packet as pkt
    return bytes([p[0] & 0xFC]) + bytes(pkt.packet_parse(p).frames[0])


def snapshot(celt) -> dict:
    out = {}
    for k in SCALAR_KEYS:
        v = getattr(celt, k)
        out[k] = np.array(v, dtype=np.float64 if isinstance(
            v, (float, np.ndarray)) else np.int64)
    return out


def _trace(celt, n: int = 960):
    """(branch, period, zeroed) of the n-sample concealment just run (the
    period and the zeroing of a periodic frame, 0 on a noise frame): a
    zeroed periodic frame leaves decode_mem[DBUF - n:] all zero (one that
    is not zeroed leaves it all zero only on a silent history, which the
    energy check zeroes too)."""
    branch = int(celt.last_frame_type)
    if branch != 1:
        return branch, 0, False
    zeroed = not celt.decode_mem[0, DBUF - n:].any()
    return branch, int(celt.last_pitch_index), bool(zeroed)


def demo_loop(packets, lost, inbandfec, dred):
    """opus_demo.decode itself on each stream -> int16 [8, n * 960]."""
    from opus_tpu.tools import opus_demo
    import struct
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, row in enumerate(packets):
            bit = os.path.join(tmp, f"s{i}.bit")
            with open(bit, "wb") as fh:
                for p in row:
                    fh.write(struct.pack(">iI", len(p), 0) + p)
            lf = os.path.join(tmp, f"s{i}.loss")
            with open(lf, "w") as fh:
                fh.write("".join(f"{int(v)}\n" for v in lost[i]))
            pcm = os.path.join(tmp, f"s{i}.pcm")
            rc = opus_demo.decode(48000, 1, bit, pcm, lossfile=lf,
                                  inbandfec=inbandfec, use_dred=dred)
            if rc != 0:
                raise SystemExit(f"opus_demo.decode stream {i}: rc {rc}")
            outs.append(np.fromfile(pcm, "<i2"))
    return np.stack(outs)


def replica_loop(packets, lost, defer, dred, snaps=()):
    """The loop of opus_demo.decode, concealing 20 ms a call and recording
    each frame slot; defer: -inbandfec or -dred (a loss waits for the next
    packet); dred: conceal from the packet's DRED where it carries one."""
    from opus_tpu.dnn.dred_dec import OpusDREDDecoder
    from opus_tpu.models.opus_decoder import OpusDecoder
    from opus_tpu.tools.opus_demo import _models_from_blob

    n, nf = lost.shape
    rec = dict(kind=np.zeros((n, nf), np.int8),
               range=np.zeros((n, nf), np.uint32),
               branch=np.zeros((n, nf), np.int8),
               pitch=np.zeros((n, nf), np.int16),
               zeroed=np.zeros((n, nf), bool),
               pcm=np.zeros((n, nf, 960)))
    before, after = [], []
    m = _models_from_blob(None, ("dred_dec", "stats", "plc", "pitch",
                                 "fargan")) if dred else None
    for i in range(n):
        dec = OpusDecoder(48000, 1)
        ddec = None
        if dred:
            dec.load_deep_plc(m["plc"], m["pitch"], m["fargan"])
            ddec = OpusDREDDecoder(m["dred_dec"], m["stats"])

        def classic(f):
            if (i, f) in snaps:
                before.append(snapshot(dec.celt))
            decoded_any = dec.prev_mode != 0
            rec["pcm"][i, f] = dec.decode(None, 960)
            if (i, f) in snaps:
                after.append(snapshot(dec.celt))
            if decoded_any:
                rec["kind"][i, f] = 1
                (rec["branch"][i, f], rec["pitch"][i, f],
                 rec["zeroed"][i, f]) = _trace(dec.celt)
            else:
                rec["kind"][i, f] = 3
        pend = []
        for f in range(nf):
            p = packets[i][f]
            if lost[i, f]:
                if defer:
                    pend.append(f)
                else:
                    classic(f)
                continue
            if pend:
                d = None
                if dred:
                    d, _ = ddec.parse(p, 960 * len(pend), 48000,
                                      defer_processing=False)
                if d is not None:
                    k = 960 * len(pend)
                    out = dec.dred_decode(d, k, k).reshape(len(pend), 960)
                    rec["pcm"][i, pend] = out.astype(np.float64) / 32768.0
                    rec["kind"][i, pend] = 2
                else:
                    for g in pend:
                        classic(g)
                pend = []
            rec["pcm"][i, f] = dec.decode(p)
            rec["range"][i, f] = dec.rangeFinal
        for g in pend:
            classic(g)
    return rec, before, after


def to16(pcm):
    return np.clip(np.floor(pcm * 32768 + 0.5), -32768, 32767).astype(
        np.int16)


def after_mask(kind):
    """The first decoded frame after a run of concealed ones (kind 1 or
    2)."""
    c = (kind == 1) | (kind == 2)
    after = np.zeros_like(c)
    after[:, 1:] = c[:, :-1] & (kind[:, 1:] == 0)
    return after


def slots(name, rec, ref16):
    """A loop's record: per slot kind, range, branch, pitch and zeroing;
    the int16 of the concealed slots (classic or DRED, ``<name>_conc``,
    checked equal to opus_demo's output ``ref16``) and the float PCM of
    the first decoded frame after each run (``<name>_after_pcm``)."""
    n = rec["kind"].shape[0]
    pcm16 = to16(rec["pcm"])
    if not np.array_equal(pcm16.reshape(n, -1), ref16):
        raise SystemExit(f"the replica of the {name} loop != opus_demo")
    conc = (rec["kind"] == 1) | (rec["kind"] == 2)
    after = after_mask(rec["kind"])
    out = {f"{name}_{k}": rec[k] for k in ("kind", "range", "branch",
                                           "pitch", "zeroed")}
    out[f"{name}_conc"] = pcm16[conc]
    out[f"{name}_after_pcm"] = rec["pcm"][after].astype(np.float32)
    return out


def part_loops():
    sfx = np.load(SIM_FIXTURE)
    lens = sfx["packet_lens"]
    packets = [[bytes(sfx["packets"][i, f, :lens[i, f]])
                for f in range(FRAMES)] for i in range(STREAMS)]
    lost = lost_flags(sfx["lg_flags"])
    smask = strip_mask()
    out = dict(lost=lost, strip=smask)
    plain, before, after = replica_loop(packets, lost, False, False,
                                        set(SNAPS))
    ref = demo_loop(packets, lost, False, False)
    out.update(slots("plain", plain, ref))
    if not np.array_equal(demo_loop(packets, lost, True, False), ref):
        raise SystemExit("-inbandfec's output != the plain loop's")
    fec, _, _ = replica_loop(packets, lost, True, False)
    if not np.array_equal(to16(fec["pcm"]), to16(plain["pcm"])):
        raise SystemExit("the -inbandfec replica != the plain loop")
    for k in SCALAR_KEYS:
        out[f"snap_before_{k}"] = np.stack([s[k] for s in before])
        if k != "decode_mem":
            out[f"snap_after_{k}"] = np.stack([s[k] for s in after])
    # the port keeps its history in float32: so does the snapshot
    out["snap_before_decode_mem"] = out["snap_before_decode_mem"].astype(
        np.float32)
    out["snaps"] = np.asarray(SNAPS)

    dp = [[strip(p) if smask[i, f] else p for f, p in enumerate(row)]
          [:DRED_FRAMES] for i, row in enumerate(packets)]
    dlost = lost[:, :DRED_FRAMES]
    dred, _, _ = replica_loop(dp, dlost, True, True)
    out.update(slots("dred", dred, demo_loop(dp, dlost, False, True)))
    return out


def part_module10():
    from opus_tpu.models.opus_decoder import OpusDecoder

    fx = np.load(FIX10)
    t = max(len(s) for s in SCHED10)
    sched = [s + "L" * (t - len(s)) for s in SCHED10]
    rec = dict(m10_pcm=np.zeros((STREAMS, t, 480)),
               m10_range=np.zeros((STREAMS, t), np.uint32),
               m10_branch=np.zeros((STREAMS, t), np.int8),
               m10_pitch=np.zeros((STREAMS, t), np.int16),
               m10_zeroed=np.zeros((STREAMS, t), bool))
    for i in range(STREAMS):
        dec = OpusDecoder(48000, 1)
        nxt = 0
        for e, ev in enumerate(sched[i]):
            if ev == "L":
                rec["m10_pcm"][i, e] = dec.decode(None, 480)
                if dec.prev_mode:
                    (rec["m10_branch"][i, e], rec["m10_pitch"][i, e],
                     rec["m10_zeroed"][i, e]) = _trace(dec.celt, 480)
                continue
            s, f = ((i + 1) % STREAMS, 0) if ev == "q" else (i, nxt)
            nxt += ev == "p"
            frame = bytes(fx["frames"][s, f, :fx["lens"][s, f]])
            rec["m10_pcm"][i, e] = dec.decode(bytes([0xF0]) + frame)
            rec["m10_range"][i, e] = dec.rangeFinal
    kind = np.where(rec["m10_branch"] > 0, 1, np.array(
        [[0 if ev != "L" else 3 for ev in row] for row in sched], np.int8))
    conc = kind == 1
    after = after_mask(kind)
    rec["m10_conc"] = to16(rec["m10_pcm"][conc])
    rec["m10_after_pcm"] = rec["m10_pcm"][after].astype(np.float32)
    rec["m10_kind"] = kind.astype(np.int8)
    del rec["m10_pcm"]
    rec["m10_sched"] = np.array(sched)
    return rec


PARTS = dict(loops=part_loops, module10=part_module10)


def _run(name):
    t0 = time.time()
    res = PARTS[name]()
    print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    return res


def main():
    t0 = time.time()
    with mp.get_context("spawn").Pool(len(PARTS)) as pool:
        parts = pool.map(_run, list(PARTS))
    arrays = {}
    for p in parts:
        arrays.update(p)
    for name in ("plain", "dred"):
        kind = arrays[f"{name}_kind"]
        br = arrays[f"{name}_branch"]
        print(f"{name}: {int((kind == 1).sum())} classic concealments "
              f"({int((br == 1).sum())} periodic, {int((br == 2).sum())} "
              f"noise, {int(arrays[f'{name}_zeroed'].sum())} zeroed), "
              f"{int((kind == 2).sum())} from DRED, {int((kind == 3).sum())} "
              f"before any packet; {len(arrays[f'{name}_after_pcm'])} "
              f"decoded frames after a loss")
    br = arrays["m10_branch"]
    print(f"10 ms: {int((br == 1).sum())} periodic, {int((br == 2).sum())} "
          f"noise concealments")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes in "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
