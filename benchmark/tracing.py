"""The profiler window of a ``--trace 1`` run and what is read from it.

``torch.profiler`` (CPU and CUDA activities) runs over a steady part of
the measured window: it starts at an on_block tick ``offset`` of the way
in and stops at the first tick ``length_s`` later, both between two
windows of the program's pipeline. The device's events (kernels and
copies, from CUPTI) give the busy time (the union of their intervals),
the time by operation, and the idle gaps, each named by the harness span
(a plan, a sink write) that was open at the gap's middle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    t0: float  # perf_counter when the profiler started
    t1: float  # ... and stopped
    ticks: int  # pipeline windows drained while it ran
    events: list = field(default_factory=list)  # (name, start_s, end_s)
    by_name: dict = field(default_factory=dict)  # name -> device seconds
    prof: object = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        """The union of the device events' intervals within the window."""
        spans = sorted((max(0.0, s), min(self.window_s, e))
                       for _n, s, e in self.events)
        merged: list = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list:
        """(start_s, end_s) of each stretch with no device event."""
        gaps, at = [], 0.0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = e
        if at < self.window_s:
            gaps.append((at, self.window_s))
        return gaps


class Tracer:
    def __init__(self, offset_s: float, length_s: float):
        self.offset_s = offset_s
        self.length_s = length_s
        self._prof = None
        self._t0 = None
        self._ticks = 0
        self.trace: Trace | None = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start the profiler's machinery once in set-up, so that its
        start inside the window costs little."""
        import torch

        with self._profile():
            (torch.zeros(1, device="cuda") + 1).sum().item()
            torch.cuda.synchronize()

    def tick(self, elapsed: float) -> None:
        """Called at each pipeline tick inside the window, ``elapsed``
        seconds after it opened."""
        if self._prof is None and self.trace is None:
            if elapsed >= self.offset_s:
                self._prof = self._profile()
                self._prof.start()
                self._t0 = time.perf_counter()
            return
        if self._prof is not None:
            self._ticks += 1
            if time.perf_counter() - self._t0 >= self.length_s:
                self.finish()

    def finish(self) -> None:
        if self._prof is None:
            return
        t1 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.stop()
        self.trace = Trace(self._t0, t1, self._ticks, prof=prof)

    def reduce(self) -> Trace | None:
        """Read the device events out of the finished profile (after the
        run: the reading costs the host time)."""
        tr = self.trace
        if tr is None or tr.prof is None:
            return tr
        from torch.autograd import DeviceType

        for e in tr.prof.events():
            if e.device_type == DeviceType.CUDA:
                tr.events.append((e.name, e.time_range.start / 1e6,
                                  e.time_range.end / 1e6))
        for e in tr.prof.key_averages():
            if e.device_type == DeviceType.CUDA and \
                    e.self_device_time_total > 0:
                tr.by_name[e.key] = e.self_device_time_total / 1e6
        return tr


def breakdown(tr: Trace, labelled_spans: list, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the harness saw the host doing (``labelled_spans``: (label,
    start, end) on the perf_counter clock)."""
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(labelled_spans, key=lambda x: x[1])
    starts = [a for _n, a, _b in spans]
    by_label: dict = {}
    for s, e in tr.idle_gaps():
        mid = tr.t0 + 0.5 * (s + e)
        label = "host: other (corrections, collation, launch, wait, pacing)"
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and spans[k][2] >= mid:
            label = f"host: {spans[k][0]}"
        by_label[label] = by_label.get(label, 0.0) + (e - s)
    gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
