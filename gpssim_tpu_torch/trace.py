"""Spans of the batched pipeline, on the profiler's own clock.

``span(name, window)`` marks one stage of one launch window (planning,
collation, the launch, the wait, the sink writes, ...) as a profiler
range named ``gpssim.<name>#<window>``, ``window`` being the window's
sequence number in its run. The ranges land in the same trace, and on
the same timeline, as the CUDA kernels and copies that the profiler
records: a reader matches a span to the device work it launched with no
clock offset to guess. The profiler keeps no argument string of a range,
so the window's number is part of its name.

A range is torch's ``_RecordFunctionFast``, which the profiler records as
an operator (``cpu_op``), where ``torch.profiler.record_function`` is a
user annotation: for each of those that launches work on the card the
profiler adds a ``gpu_user_annotation`` event on the card's timeline,
from the first copy to the last, which a reader of the card's events
would count as busy time. It also costs less per span (PERF.md, §6).

A span records only on a thread the profiler sees: the one that started
it, or one started before it. The pipeline's own thread is that thread
in ``--profile-dir`` (``app._maybe_profile``) and in the benchmark's
traced runs; a pipeline on a worker thread (the TUI's) records none.

With no profiler running a span is one shared no-op context: one flag
read per site, and no profiler range entered.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "gpssim."
_NOOP = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str, window: int):
    """A profiler range over one stage of launch window ``window`` while a
    torch profiler records in the process; else a no-op context."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Range(f"{PREFIX}{name}#{window}")

