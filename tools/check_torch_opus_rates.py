"""Holds ``BatchedOpusDecoder(fs=...)`` on the CPU to every step of
tests/data/torch_opus_rates.npz: the 12 cases (the api fixture's 8
streams at one channel, the stereo fixture's at one and two, each at 8,
12, 16 and 24 kHz), all 8 streams on 8 lanes, with the bounds and checks
of tests/test_torch_opus_rates.py (``check_step``), whose first steps
alone the tier-1 tests run (a tick costs ~2.5-5 s of host here).  One
process a case; prints each case's largest errors and seconds.

Run from the repository root (~3-4 min with 12 processes):
    JAX_PLATFORMS=cpu python tools/check_torch_opus_rates.py
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_case(case):
    import torch

    from opus_tpu_torch.models.opus_decoder import BatchedOpusDecoder
    from tests import test_torch_opus_rates as T

    torch.set_num_threads(1)
    src, fs, c = case
    os.chdir(REPO)
    rf = dict(np.load(T.RATES_FIXTURE))
    fx = dict(np.load(T.SOURCES[src]))
    key = f"{src}{fs // 1000}_{c}"
    dec = BatchedOpusDecoder(8, fs=fs, channels=c, device="cpu")
    seen = {}
    t0 = time.time()
    for t in range(rf[key + "_n"].shape[1]):
        pk, fec, size = T.steps(fx, src, fs, t)
        pcm, n = dec.decode(pk, fec, size)
        assert not dec.status.any() and not dec.flagged.any(), (key, t)
        T.check_step(rf, key, t, dec, pk, fec, pcm, n, seen=seen)
    return key, rf[key + "_n"].shape[1], seen, time.time() - t0


def main() -> int:
    from tests.test_torch_opus_rates import CASES
    with mp.get_context("spawn").Pool(len(CASES)) as pool:
        for key, steps, seen, sec in pool.imap(run_case, CASES):
            print(f"{key}: {steps} steps held; largest errors "
                  + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
                      seen.items())) + f"; {sec:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
