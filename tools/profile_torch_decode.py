"""Where the port's 20 ms decode step spends its time on the card.

Decodes the committed fixture's packets (tests/data/torch_celt20ms_64k.npz)
tiled over B streams with opus_tpu_torch's KernelCeltDecoder on CUDA,
under torch.profiler, and prints the device time by kernel, the number
of device launches per step and the device's busy share of the step's
wall time.

Run from the repository root on a machine with a card:
    python3 tools/profile_torch_decode.py [--batch 4096] [--steps 8]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from opus_tpu_torch.models.celt_dec_kernel import KernelCeltDecoder  # noqa


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: CUDA is not available", file=sys.stderr)
        return 1
    fx = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data",
        "torch_celt20ms_64k.npz"))
    ns, nf, p = fx["frames"].shape
    lane = np.arange(args.batch) % ns
    dev = torch.device("cuda", 0)
    bufs = [(torch.from_numpy(fx["frames"][lane, f % nf]).to(dev),
             torch.from_numpy(fx["lens"][lane, f % nf]).to(dev))
            for f in range(args.steps)]
    dec = KernelCeltDecoder(args.batch, device=dev, max_payload=p)
    dec.decode_packed(*bufs[0])                      # build + warm up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for buf, ln in bufs:
            dec.decode_packed(buf, ln)
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
    print(f"B={args.batch} steps={args.steps}: wall {wall * 1e3:.3f} ms, "
          f"{wall * 1e3 / args.steps:.3f} ms/step; device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall); "
          f"{launches / args.steps:.0f} device launches/step")
    for dt, cnt, key in rows[:15]:
        print(f"  {dt / 1e3 / args.steps:9.4f} ms/step {cnt // args.steps:6d}"
              f"x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
