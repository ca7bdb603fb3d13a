"""Driving the program through its own entry points, and recording what it
hands out.

Offline cells call ``runner.run_simulation`` (one receiver) or
``fleet.run_fleet`` (a farm) with the port's ``IqFileSink`` writing to
``os.devnull``: its FIFO and writer thread run, and no stream reaches a
disk. The live cell calls ``runner.run_simulation`` paced and
interactive, into the port's ``TcpSink`` (the ``--radio tcp`` sink,
paced at the DAC rate), read by :class:`StreamReader` on loopback, with
keys sent through ``tui.TuiApp.handle_key``.

Around the program the harness keeps only its own records: a tee around
each sink (the time of each ``write`` and a checksum of each block), a
subclass of ``Simulation`` that notes each plan's block-start carrier
phase and, for live edits, the block an edit lands at (public methods
only), and the window's clock.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .fingerprint import fingerprint


def program_config(inputs, member, *, backend: str, device: str,
                   overrides: dict | None = None):
    """The port's SimConfig for one member of the deployment."""
    from gpssim_tpu_torch.config import (CarrierMode, LocationConfig,
                                         SampleFormat, SimConfig,
                                         SynthBackend)
    from gpssim_tpu_torch.core.gpstime import DateTime

    from .workload import data_path

    c, tr = inputs.config, inputs.traffic
    s = member.start
    cfg = SimConfig(
        nav_file=data_path(c["nav_file"]),
        almanac_file=(data_path(c["almanac_file"]) if c["almanac"]
                      else None),
        almanac_enable=c["almanac"],
        ionosphere_enable=c["ionosphere"],
        start=DateTime(s.y, s.m, s.d, s.hh, s.mm, s.sec),
        duration_sec=float(tr["duration_s"]),
        location=LocationConfig(member.lat, member.lon, member.height),
        sample_rate=int(c["sample_rate"]),
        num_channels=int(c["num_channels"]),
        sample_format=SampleFormat(int(c["sample_bits"])),
        carrier_mode=CarrierMode(c["carrier"]),
        parity_exact=bool(c["parity_exact"]),
        fifo_depth=int(c["fifo_depth"]),
        backend=SynthBackend(backend),
        device=device,
        sink="iqfile",
        out_file=os.devnull,
    )
    if tr["mode"] == "live":
        cfg.sink = "tcp"
        cfg.realtime = True
        cfg.interactive = True
    for k, v in (overrides or {}).items():
        setattr(cfg, k, v)
    return cfg


def recorded_simulation(cfg):
    """A ``Simulation`` that records each plan's block-start carrier phase
    and planning span, and queues ``set_motion`` edits (a key thread's)
    until the next ``step``, noting the block each edit lands at."""
    from gpssim_tpu_torch.scenario import Simulation

    class Recorded(Simulation):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.phases: dict = {}  # block index -> f64[C]
            self.active: dict = {}  # block index -> active channels
            self.steps: list = []  # (start, end) of each step
            self.lock = threading.Lock()
            self.queue: list = []
            self.landed: list = []  # (block index, kwargs, key context)
            self.key_context = None

        def set_motion(self, **kw):
            with self.lock:
                self.queue.append((kw, self.key_context))

        def step(self):
            t0 = time.perf_counter()
            with self.lock:
                pending, self.queue = self.queue, []
            index = self.next_block_index
            for kw, ctx in pending:
                super().set_motion(**kw)
                self.landed.append((index, kw, ctx))
            plan = super().step()
            if plan is not None:
                self.phases[index] = plan.carr_phase.copy()
                self.active[index] = int(plan.active.sum())
            self.steps.append((t0, time.perf_counter()))
            return plan

    return Recorded(cfg)


def tee_sink(inner, chosen):
    """The port's sink ``inner`` behind a tee that times each ``write``
    and keeps a checksum of each block that ``chosen(index)`` picks for
    the check (index 1 = the first block handed to the sink)."""
    from gpssim_tpu_torch.io.sinks import Sink

    class Tee(Sink):
        name = inner.name

        def __init__(self):
            self.inner = inner
            self.spans: list = []  # (start, end) of each inner write
            self.sums: dict = {}  # block index -> checksum of its bytes
            self.count = 0  # blocks handed to the sink

        def init(self, cfg=None):
            self.inner.init(cfg)

        def write(self, block):
            t0 = time.perf_counter()
            self.inner.write(block)
            self.spans.append((t0, time.perf_counter()))
            self.count += 1
            if chosen(self.count):
                self.sums[self.count] = fingerprint(block)

        def end_stream(self):
            self.inner.end_stream()

        def close(self):
            self.inner.close()

        def set_gain(self, gain):
            return self.inner.set_gain(gain)

        def __getattr__(self, name):  # underruns, backlogged, started, ...
            return getattr(self.__dict__["inner"], name)

    return Tee()


class StreamReader(threading.Thread):
    """A loopback TCP receiver of a paced stream: the time the first byte
    of each block arrived, and a checksum of each whole block."""

    def __init__(self, block_bytes: int, accept_timeout_s: float = 120.0):
        super().__init__(name="bench-stream-reader", daemon=True)
        self.block_bytes = block_bytes
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(accept_timeout_s)
        self.port = self.srv.getsockname()[1]
        self.first_byte_at: list = []
        self.sums: list = []
        self.error: BaseException | None = None

    def run(self):
        try:
            conn, _ = self.srv.accept()
        except OSError as e:
            self.error = e
            return
        finally:
            self.srv.close()
        buf = bytearray(self.block_bytes)
        view = memoryview(buf)
        fill = 0
        with conn:
            while True:
                n = conn.recv_into(view[fill:])
                if n == 0:
                    break
                if fill == 0:
                    self.first_byte_at.append(time.perf_counter())
                fill += n
                if fill == self.block_bytes:
                    self.sums.append(fingerprint(np.frombuffer(buf,
                                                               np.int8)))
                    fill = 0


@dataclass
class Snapshot:
    t: float
    blocks: int
    samples: int
    plan: float
    synth: float
    fetch: float
    correct: float

    @classmethod
    def of(cls, stats: list):
        st = stats[0]  # a fleet books the host stages on member 0
        return cls(time.perf_counter(), sum(s.blocks for s in stats),
                   sum(s.samples for s in stats), st.plan_seconds,
                   st.synth_seconds, st.fetch_seconds, st.correct_seconds)


@dataclass
class Record:
    """What one run of a cell leaves for the metrics and the check."""

    mode: str
    sims: list
    tees: list
    start: Snapshot | None = None
    end: Snapshot | None = None
    ticks: list = field(default_factory=list)  # on_block times in window
    trace: object = None
    stats: list = field(default_factory=list)
    reader: StreamReader | None = None
    keys_sent: list = field(default_factory=list)  # (due, key, written)
    drained_at: float | None = None


class Window:
    """Opens after the warm-up, closes ``seconds`` later; drives the
    tracer inside it."""

    def __init__(self, seconds: float, tracer=None):
        self.seconds = seconds
        self.tracer = tracer
        self.start: Snapshot | None = None
        self.end: Snapshot | None = None
        self.ticks: list = []
        self.opened = threading.Event()

    def open(self, stats):
        self.start = Snapshot.of(stats)
        self.opened.set()

    def tick(self, stats) -> None:
        if self.start is None or self.end is not None:
            return
        now = time.perf_counter()
        self.ticks.append(now)
        if self.tracer is not None:
            self.tracer.tick(now - self.start.t)
        if now - self.start.t >= self.seconds:
            self.end = Snapshot.of(stats)
            if self.tracer is not None:
                self.tracer.finish()


def run_offline(inputs, cfgs, seconds: float, tracer=None) -> Record:
    from gpssim_tpu_torch.fleet import run_fleet
    from gpssim_tpu_torch.io.sinks import make_configured_sink
    from gpssim_tpu_torch.runner import run_simulation

    from .workload import compare_rule

    sims = [recorded_simulation(c) for c in cfgs]
    tees = [tee_sink(make_configured_sink(c), compare_rule(inputs, m))
            for m, c in enumerate(cfgs)]
    win = Window(seconds, tracer)
    warm = int(inputs.traffic["warmup_blocks"])

    def on_stats(stats):
        if win.start is None and sum(s.blocks for s in stats) >= warm:
            win.open(stats)
        else:
            win.tick(stats)

    def stop():
        return win.end is not None

    if len(cfgs) == 1:
        stats = [run_simulation(cfgs[0], sink=tees[0], sim=sims[0],
                                on_block=lambda st, _s, _p: on_stats([st]),
                                stop=stop)]
    else:
        stats = run_fleet(cfgs, sinks=tees, on_batch=on_stats, stop=stop,
                          sims=sims)
    if win.end is None:
        raise RuntimeError("the scenario ended before the window closed")
    return Record("offline", sims, tees, win.start, win.end, win.ticks,
                  tracer, stats)


def run_live(inputs, cfg, seconds: float, tracer=None) -> Record:
    from gpssim_tpu_torch.io.sinks import make_configured_sink
    from gpssim_tpu_torch.runner import run_simulation
    from gpssim_tpu_torch.tui import TuiApp

    tr = inputs.traffic
    block_bytes = 2 * cfg.samples_per_epoch * cfg.sample_format.value // 8
    reader = StreamReader(block_bytes)
    reader.start()
    cfg.tcp_addr = f"127.0.0.1:{reader.port}"
    from .workload import compare_rule

    sim = recorded_simulation(cfg)
    tee = tee_sink(make_configured_sink(cfg), compare_rule(inputs, 0))
    app = TuiApp(cfg, sim, tee)
    win = Window(seconds, tracer)
    warm = int(tr["warmup_stream_blocks"])
    # The runner's structural bound: the sink FIFO plus two windows of
    # half its depth in flight (runner.dispatch_window).
    bound_s = 0.1 * (cfg.fifo_depth + 2 * max(1, cfg.fifo_depth // 2))
    sent: list = []
    done = threading.Event()
    rec = Record("live", [sim], [tee], reader=reader, keys_sent=sent,
                 trace=tracer)

    def keys():
        if not win.opened.wait(600):
            return
        t0 = win.start.t
        for dt, key in inputs.keys:
            if dt >= seconds:
                break
            due = t0 + dt
            if done.wait(max(0.0, due - time.perf_counter())):
                return
            sim.key_context = (due, tee.count)
            app.handle_key(ord(key))
            sent.append((due, key, tee.count))

    def all_landed() -> bool:
        if len({ctx[0] for _i, _kw, ctx in sim.landed}) < len(sent):
            return False
        # the reader has the first byte of every landing block (1-based)
        need = max((i for i, _kw, _c in sim.landed), default=0)
        return len(reader.first_byte_at) >= need

    def on_block(stats, _sim, _plan):
        if win.start is None:
            if len(reader.first_byte_at) >= warm:
                win.open([stats])
            return
        win.tick([stats])

    def stop():
        if win.end is None:
            return False
        now = time.perf_counter()
        if all_landed() or now - win.end.t > 2 * bound_s:
            rec.drained_at = now
            return True
        return False

    thread = threading.Thread(target=keys, name="bench-keys", daemon=True)
    thread.start()
    try:
        stats = run_simulation(cfg, sink=tee, sim=sim, on_block=on_block,
                               stop=stop)
    finally:
        done.set()
        thread.join(10)
    reader.join(30)
    if win.end is None:
        raise RuntimeError("the scenario ended before the window closed")
    rec.start, rec.end, rec.ticks, rec.stats = (win.start, win.end,
                                                win.ticks, [stats])
    return rec
