"""Where the port's 20 ms encode, decode, duplex, SILK or hybrid decode
step spends its time on the card.

Runs one path of opus_tpu_torch on CUDA over B streams tiled from the
committed fixtures, under torch.profiler, and prints the device time by
kernel, the number of device launches per step and the device's busy
share of the step's wall time:

- ``decode``: KernelCeltDecoder on the fixture's packets
  (tests/data/torch_celt20ms_64k.npz);
- ``encode``: KernelCeltEncoder on the encoder fixture's PCM
  (tests/data/torch_celt20ms_64k_enc.npz), plus the wall time per step of
  its stages (front end, K3, state carry), each timed alone with the
  card synchronised around it;
- ``duplex``: the encoder's packets straight into the decoder;
- ``silk``: FusedSilkDecoder (SILK wideband, 20 ms, 24 kb/s) on the SILK
  fixture's packets (tests/data/torch_silk16k_24k.npz), plus the wall
  time per step of its two stages (the symbol pass and decode_core with
  kernel K4), each timed alone with the card synchronised around it;
- ``hybrid``: FusedHybridDecoder (SILK-WB + CELT bands 17-20, fullband
  20 ms) on the hybrid fixture's packets
  (tests/data/torch_hybrid_fb20ms.npz), plus the wall time per step of its
  SILK half, CELT half (redundancy parse, K1 at start 17, synthesis) and
  upsampler, each timed alone with the card synchronised around it.

Run from the repository root on a machine with a card:
    python3 tools/profile_torch.py [--path silk] [--batch 4096] [--steps 8]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from opus_tpu_torch.models import celt_enc_kernel as EK  # noqa: E402
from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder  # noqa
from opus_tpu_torch.models import fused_silk_dec as SD  # noqa: E402
from opus_tpu_torch.models import hybrid_dec_fused as HD  # noqa: E402
from opus_tpu_torch.models.batched_silk import silk_decode_step  # noqa


def _fixture(name):
    return np.load(os.path.join(REPO, "tests", "data", name))


def _steps(args, dev):
    """(step callables, one per profiled step)."""
    lane = np.arange(args.batch)
    if args.path == "silk":
        dec = SD.FusedSilkDecoder(args.batch, device=dev)
        return [lambda b=b: dec.decode_packed(*b)
                for b in _silk_frames(args, dev)]
    if args.path == "hybrid":
        frames = _silk_frames(args, dev, "torch_hybrid_fb20ms.npz")
        dec = HD.FusedHybridDecoder(args.batch, device=dev,
                                    max_payload=frames[0][0].shape[1])
        return [lambda b=b: dec.decode_packed(*b) for b in frames]
    if args.path == "decode":
        fx = _fixture("torch_celt20ms_64k.npz")
        ns, nf, p = fx["frames"].shape
        bufs = [(torch.from_numpy(fx["frames"][lane % ns, f % nf]).to(dev),
                 torch.from_numpy(fx["lens"][lane % ns, f % nf]).to(dev))
                for f in range(args.steps + 1)]
        dec = KernelCeltDecoder(args.batch, device=dev, max_payload=p)
        return [lambda b=b: dec.decode_packed(*b) for b in bufs]
    pcm = _fixture("torch_celt20ms_64k_enc.npz")["pcm"]
    ns, nf, _n = pcm.shape
    frames = [torch.from_numpy(pcm[lane % ns, f % nf]).to(dev)
              for f in range(args.steps + 1)]
    enc = EK.KernelCeltEncoder(args.batch, device=dev)
    if args.path == "encode":
        return [lambda x=x: enc.encode_device(x) for x in frames]
    dec = KernelCeltDecoder(args.batch, device=dev, max_payload=enc.nbytes)
    lens = torch.full((args.batch,), enc.nbytes, dtype=torch.int64,
                      device=dev)
    return [lambda x=x: dec.decode_packed(enc.encode_device(x)[0], lens)
            for x in frames]


def _silk_frames(args, dev, name="torch_silk16k_24k.npz"):
    """(buf, lens) on the card per step, a fixture's streams (the SILK
    one's by default) tiled over the batch."""
    fx = _fixture(name)
    ns, nf, _p = fx["frames"].shape
    lane = np.arange(args.batch)
    return [(torch.from_numpy(fx["frames"][lane % ns, f % nf]).to(dev),
             torch.from_numpy(fx["lens"][lane % ns, f % nf].astype(
                 np.int64)).to(dev)) for f in range(args.steps + 1)]


def _silk_stages(args, dev) -> str:
    """Wall ms per step of the SILK symbol pass and of decode_core (with
    K4), each synchronised alone, averaged over the steps."""
    state = SD.fused_init_state(args.batch, 16, dev)
    tot = dict(symbols=0.0, decode_core=0.0)
    for f, (buf, ln) in enumerate(_silk_frames(args, dev)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_in, carry, err, _d = SD.silk_symbols(buf, ln, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _xq, synth = silk_decode_step(**step_in, state=state["synth"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = dict(carry, first_frame=torch.zeros_like(err), synth=synth)
        if f:                                          # step 0 warms up
            tot["symbols"] += t1 - t0
            tot["decode_core"] += t2 - t1
    return ", ".join(f"{k} {v * 1e3 / args.steps:.3f}" for k, v in
                     tot.items())


def _hybrid_stages(args, dev) -> str:
    """Wall ms per step of the hybrid decoder's SILK half, CELT half and
    upsampler, each synchronised alone, averaged over the steps (the
    composition of hybrid_dec_fused.fused_hybrid_decode)."""
    from opus_tpu_torch.models.celt_dec_kernel import \
        kernel_celt_decode_to_pcm
    from opus_tpu_torch.ops import rc_kernel as K
    from opus_tpu_torch.silk.resampler import upsample_to_48k

    frames = _silk_frames(args, dev, "torch_hybrid_fb20ms.npz")
    dec = HD.FusedHybridDecoder(args.batch, device=dev,
                                max_payload=frames[0][0].shape[1])
    st = dec.state
    tot = dict(silk=0.0, celt=0.0, upsample=0.0)
    for f, (buf, ln) in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xq, silk, _err, d = SD.fused_silk_decode(buf, ln, st["silk"],
                                                 return_rc=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        can = K.rk_tell(d) + 37 <= 8 * ln
        _red, d = K.rk_dec_bit_logp(d, buf, ln, 12, can)
        _pcm, celt, _e = kernel_celt_decode_to_pcm(buf, ln, st["celt"],
                                                   dec.tabs, d0=d)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        seq = torch.cat([st["smid"][:, 1:], xq[:, :-1]], dim=1)
        _y, rs = upsample_to_48k(seq, st["rs"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        st = dict(silk=silk, celt=celt, rs=rs, smid=xq[:, -2:])
        if f:                                          # step 0 warms up
            tot["silk"] += t1 - t0
            tot["celt"] += t2 - t1
            tot["upsample"] += t3 - t2
    return ", ".join(f"{k} {v * 1e3 / args.steps:.3f}" for k, v in
                     tot.items())


def _encode_stages(args, dev) -> str:
    """Wall ms per step of the encoder's front end, K3 and state carry,
    each synchronised alone, averaged over the steps."""
    pcm = _fixture("torch_celt20ms_64k_enc.npz")["pcm"]
    ns, nf, _n = pcm.shape
    lane = np.arange(args.batch)
    tabs = EK.enc_tabs()
    enc = EK.KernelCeltEncoder(args.batch, device=dev)
    tot = dict(front=0.0, k3=0.0, carry=0.0)
    for f in range(args.steps + 1):
        x = torch.from_numpy(pcm[lane % ns, f % nf]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ins, X, front = EK._front_end(x, enc.state, tabs, enc.nbytes)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = EK.encode_frame(X, ins, tabs, enc.nbytes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enc.state = EK._assemble_state(enc.state, front, out)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if f:                                          # step 0 warms up
            tot["front"] += t1 - t0
            tot["k3"] += t2 - t1
            tot["carry"] += t3 - t2
    return ", ".join(f"{k} {v * 1e3 / args.steps:.3f}" for k, v in
                     tot.items())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("decode", "encode", "duplex", "silk",
                                       "hybrid"), default="decode")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    steps = _steps(args, dev)
    steps[0]()                                       # build + warm up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for step in steps[1:]:
            step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    ka = prof.key_averages()
    rows = []
    for e in ka:
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            rows.append((dt, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows)
    print(f"{args.path} B={args.batch} steps={args.steps}: wall "
          f"{wall * 1e3:.3f} ms, {wall * 1e3 / args.steps:.3f} ms/step; "
          f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% of "
          f"wall); {launches / args.steps:.0f} device launches/step")
    for dt, cnt, key in rows[:15]:
        print(f"  {dt / 1e3 / args.steps:9.4f} ms/step {cnt // args.steps:6d}"
              f"x  {key[:90]}")
    if args.path == "encode":
        print(f"encode stages, wall ms/step (unprofiled): "
              f"{_encode_stages(args, dev)}")
    if args.path == "silk":
        print(f"silk stages, wall ms/step (unprofiled): "
              f"{_silk_stages(args, dev)}")
    if args.path == "hybrid":
        print(f"hybrid stages, wall ms/step (unprofiled): "
              f"{_hybrid_stages(args, dev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
