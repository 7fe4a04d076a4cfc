"""A kernel's device time alone, from ``torch.profiler``'s CUDA records.

CUDA events around back-to-back Python calls time the calls: for a kernel
of a few microseconds the wrapper's host work (checks, allocations, the
ctypes call) is most of that.  The profiler's kernel records hold each
launch's own start and end on the card, so their mean is the kernel's
device time, whatever the host does between launches.  The records are
read from the profiler's raw results: building its ``key_averages`` costs
~0.15 ms of host a record for the same counts and sums (21001 records:
3.2 s against 0.2 s on an NVIDIA H100 80GB HBM3 host, 700.00 W).
"""

from __future__ import annotations

# profiles taken by device_ms before it gives up on the profiler
PROFILE_ATTEMPTS = 3


def card_records(prof):
    """(name, device us) of every card record of a finished
    ``torch.profiler.profile``: kernels, copies and fills."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_ms(fn, kernel: str, reps: int = 50) -> float:
    """Mean device time (ms) of one launch of the kernel whose name
    contains ``kernel``, over ``reps`` calls of ``fn`` after one warm-up
    call.  The profiler may drop a record now and then, and once in a
    while every record of a profile (seen on an H100 after several
    profiles in a row): a profile that kept fewer than half of them is
    taken again, up to PROFILE_ATTEMPTS times in all; raises if none
    kept enough, or if one kept more than one per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [us for name, us in card_records(prof) if kernel in name]
        total_us, count = sum(times), len(times)
        if count > reps:
            break
        if count >= reps // 2:
            return total_us / count / 1e3
    raise RuntimeError(f"device_ms: {count} records of a kernel named "
                       f"'{kernel}' in {reps} calls")


def device_profile(fn, reps: int = 3, warmup: bool = True) -> tuple:
    """(kernel launches per call, device ms per call) of ``fn`` over
    ``reps`` calls after one warm-up call (none with ``warmup=False``, for
    a call already warm): the count and summed device time of every CUDA
    kernel record the profiler kept.  Beside the call's wall time it gives
    the card's busy share.  Only the card is traced: host operator records
    add nothing to these sums and cost the host ~0.25 ms a launch (a SILK
    loss tick of ~10**5 launches: 58.1 s traced with them, 33.7 s without,
    the same count and device time; NVIDIA H100 80GB HBM3, 700.00 W)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [us for _name, us in card_records(prof)]
    return len(times) / reps, sum(times) / reps / 1e3
