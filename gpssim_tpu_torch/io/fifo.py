"""Bounded block FIFO with backpressure — the host transport layer.

The producer/consumer pipeline of the reference (fifo.c: 8 preallocated
buffers, blocking acquire when the freelist is empty = real-time pacing,
wait_full as a stream-start barrier, halt for teardown) re-expressed on a
thread-safe deque. On TPU the same role inside a run is played by dispatch
pipelining (device synth of block N+1 overlapped with D2H of block N);
this FIFO feeds the host-side sink (file writer or SDR TX).
"""

from __future__ import annotations

import threading
from collections import deque


class BlockFifo:
    """Fixed-depth FIFO of IQ blocks with producer backpressure."""

    def __init__(self, depth: int = 8):
        self.depth = depth
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._full_once = threading.Condition(self._lock)
        self._halted = False
        self._finished = False

    def enqueue(self, block) -> bool:
        """Producer: blocks while the queue is full (reference fifo.c:128-148
        models this as an empty freelist). Returns False if halted."""
        with self._lock:
            while (len(self._q) >= self.depth and not self._halted
                   and not self._finished):
                self._full_once.notify_all()
                self._not_full.wait()
            if self._halted or self._finished:
                return False
            self._q.append(block)
            self._not_empty.notify()
            if len(self._q) >= self.depth:
                self._full_once.notify_all()
            return True

    def dequeue(self, timeout: float | None = None):
        """Consumer: blocks until a block or halt; None on halt/timeout."""
        with self._lock:
            while not self._q and not self._halted and not self._finished:
                if not self._not_empty.wait(timeout=timeout):
                    return None
            if (self._halted or self._finished) and not self._q:
                return None
            block = self._q.popleft()
            self._not_full.notify()
            return block

    def wait_full(self, timeout: float | None = None) -> bool:
        """Stream-start barrier: wait until the FIFO has filled once
        (reference fifo_wait_full, fifo.c:97-103)."""
        with self._lock:
            if self._halted:
                return False
            if len(self._q) >= self.depth:
                return True
            return self._full_once.wait(timeout=timeout)

    def force_barrier(self) -> None:
        """Release a pending wait_full without halting — end-of-stream
        flush for short runs that never fill the pre-buffer (a TX must
        still transmit what was queued)."""
        with self._lock:
            self._full_once.notify_all()

    def finish(self) -> None:
        """End-of-stream: no more blocks are coming, but everything queued
        still transmits. The paced drain stops counting a drained-out
        tail as underruns (empty_and_live → False), dequeue returns None
        once the queue empties, and a pending start barrier releases so
        short runs transmit what was queued. Unlike halt(), nothing is
        discarded."""
        with self._lock:
            self._finished = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._full_once.notify_all()

    def halt(self) -> None:
        """Drain and wake everyone (reference fifo_halt, fifo.c:105-126)."""
        with self._lock:
            self._halted = True
            self._q.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._full_once.notify_all()

    @property
    def depth_used(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def halted(self) -> bool:
        with self._lock:
            return self._halted

    def empty_and_live(self) -> bool:
        """Queue empty while the stream is still live — the underrun
        condition for a paced consumer (see TcpSink)."""
        with self._lock:
            return not self._q and not self._halted and not self._finished
