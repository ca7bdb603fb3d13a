"""Peaks of the card, the least time of a kernel's work, and the profiler's
device time per launch: frozen here so that no later change to the
program moves the yardstick.

Copied from ``chip_smoke.py`` (``device_ms``, ``bound`` and their
constants), with each constant's source.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3.
HBM_BYTES_PER_S = 3.35e12
# NVIDIA Hopper architecture white paper (H100 SXM5): 132 SMs, 1.98 GHz
# boost clock.
SMS = 132
BOOST_HZ = 1.98e9
# Assumed: 128 int32 lane-operations per clock on each SM, the float32 lane
# count (4 schedulers x 32 lanes), since the data sheet gives no int32 rate.
INT32_LANES_PER_SM = 128
INT32_OPS_PER_S = INT32_LANES_PER_SM * SMS * BOOST_HZ
# One 128-byte shared-memory wavefront per clock per SM (32 banks of 4
# bytes; Hopper tuning guide).
SHARED_WAVEFRONTS_PER_S = SMS * BOOST_HZ
# int32 operations per channel-sample of the synthesis: the stage-B loop
# of csrc/stage_b.cuh counted from its source (code phase 3, window word 2,
# chip sign 4, carrier table offset 5, two accumulating multiply-adds 2).
# It is the work of the job as the smallest known loop does it, and stays
# fixed whatever kernel a later change brings.
OPS_PER_CHANNEL_SAMPLE = 16
# Bytes the synthesis of one active channel-block reads at the least: the
# C/A code packed to bits (128), the 60 nav words of its frame (240) and
# five float64 phase, rate and gain values (40).
INPUT_BYTES_PER_CHANNEL_BLOCK = 128 + 240 + 40


def bound(ops: int, nbytes: int, wavefronts: int = 0) -> dict:
    """The least time of the work: the largest of its floors, and which
    binds (``operations``, ``shared`` or ``bytes``)."""
    floors = {"operations": ops / INT32_OPS_PER_S,
              "shared": wavefronts / SHARED_WAVEFRONTS_PER_S,
              "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(floors, key=floors.get)
    return dict(bound_ms=floors[by] * 1e3, bound_by=by,
                floors_ms={k: v * 1e3 for k, v in floors.items()},
                ops=ops, bytes=nbytes, wavefronts=wavefronts)


def device_ms_per_launch(prof, kernel: str) -> float | None:
    """Device time per launch of the kernel whose name holds ``kernel``,
    read from a finished ``torch.profiler`` run the way ``device_ms``
    reads it: the device events' self time summed over their count."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in events)
    if not n:
        return None
    return sum(e.self_device_time_total for e in events) / n / 1e3


def device_ms(fn, kernel: str, calls: int = 20) -> float | None:
    """Device time per launch of the kernel whose name holds ``kernel``,
    from torch.profiler over ``calls`` calls of ``fn``: the kernel alone,
    however long the host takes per call. A run that records no such
    kernel is profiled once more; None where neither records it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = device_ms_per_launch(prof, kernel)
        if ms is not None:
            return ms
    return None
