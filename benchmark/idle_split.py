"""The card's idle time in a traced run, split by the stage of the pipeline
that the host was in.

Idle time is the part of the profiler's timeline (its first event's start
to its last event's end) that no device event covers, as
``device_idle_share`` counts it. Each stretch of it goes to the innermost
``gpssim.<stage>#<window>`` span (``gpssim_tpu_torch/trace.py``) open on
the host at that moment, the one started last, or to no span. Both sides
come from one profiler run, on its own clock. The ``idle_in_<stage>_share``
metrics and ``idle_unspanned_share`` read it.
"""

import heapq

PREFIX = "gpssim."


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return merged


def split(trace) -> dict | None:
    """% of the idle time under each stage's spans, keyed by the stage's
    name, and under none, keyed None; the shares add up to 100. None
    without a profiler run, device events, idle time or the program's
    spans."""
    if trace is None or trace.prof is None:
        return None
    from torch.autograd import DeviceType

    busy, spans, lo, hi = [], [], None, None
    for e in trace.prof.events():
        s, t = e.time_range.start, e.time_range.end
        lo = s if lo is None else min(lo, s)
        hi = t if hi is None else max(hi, t)
        if e.name.startswith(PREFIX):
            if e.device_type != DeviceType.CUDA:  # not a span's shadow
                spans.append((s, t, e.name[len(PREFIX):].partition("#")[0]))
        elif e.device_type == DeviceType.CUDA:
            busy.append((s, t))
    if not busy or not spans:
        return None
    idle, at = [], lo
    for s, t in _union(busy):
        if s > at:
            idle.append((at, s))
        at = max(at, t)
    if hi > at:
        idle.append((at, hi))
    total = sum(t - s for s, t in idle)
    if total <= 0:
        return None

    spans.sort()
    points = sorted({p for s, t, _ in spans for p in (s, t)}
                    | {p for s, t in idle for p in (s, t)})
    share: dict = {}
    open_: list = []  # heap of (-start, end, stage): the innermost on top
    i = j = 0
    for a, b in zip(points, points[1:]):
        while i < len(spans) and spans[i][0] <= a:
            heapq.heappush(open_, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)  # ended: under a later-started one, or none
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a:
            stage = open_[0][2] if open_ else None
            share[stage] = share.get(stage, 0.0) + (b - a)
    return {k: 100.0 * v / total for k, v in share.items()}


def stage_share(trace, stage) -> float | None:
    """% of the idle time under ``stage``'s spans (``None``: under no
    span); 0 where that stage held none of it."""
    shares = split(trace)
    if shares is None:
        return None
    return shares.get(stage, 0.0)
