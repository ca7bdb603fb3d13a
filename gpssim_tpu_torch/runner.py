"""End-to-end run loop: scenario plans → synth backend → quantize → sink.

Runs on the cuda/torch backends take the window pipeline
(:func:`_run_batched`), one scenario here and N of them from
``fleet.run_fleet``: one kernel launch per window of
``cfg.dispatch_blocks`` blocks, with two windows in flight, so the
device-to-host copy, the strict-parity corrections and the sink write of
one window overlap the next window's kernel. The numpy and native backends
run block by block on the host.

Realtime runs (``cfg.realtime``) pace the written signal to the wall clock
with the sink FIFO's lead, cap the window at half the FIFO depth, keep the
full channel axis (one launch shape for the whole run) and run under the
:class:`RealtimeSupervisor`: a sustained synthesis deficit fails over to
the native sequential engine, whose bytes are the same, and a
:class:`DeviceProbe` fails back to the device path once it holds with
margin.

Interactive runs (``cfg.interactive``: live position edits from the TUI,
``Simulation.set_motion``) take the same window cap and full channel axis,
so an edit reaches the stream within ``fifo_depth`` blocks whatever the
backend; they are paced and supervised only when ``cfg.realtime`` is set
too. The host backends run them block by block.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .config import CarrierMode, SimConfig, SynthBackend
from .io.sinks import Sink, make_configured_sink
from .ops.synth_numpy import quantize_iq, synth_block_numpy
from .scenario import Simulation

logger = logging.getLogger("gpssim_tpu_torch.runner")

#: backends whose synthesis runs as a torch kernel on ``cfg.device``
DEVICE_BACKENDS = (SynthBackend.CUDA, SynthBackend.TORCH)


@dataclass
class RunStats:
    blocks: int = 0
    samples: int = 0
    wall_seconds: float = 0.0
    synth_seconds: float = 0.0
    plan_seconds: float = 0.0
    # batched path only: host time waiting for a window's result, and
    # applying the strict-parity corrections to it
    fetch_seconds: float = 0.0
    correct_seconds: float = 0.0
    # strict parity: candidates the corrections' screen evaluated, samples
    # patched, and blocks with a patch (the sink copies these instead of
    # lending them)
    correct_candidates: int = 0
    correct_samples: int = 0
    correct_blocks: int = 0
    # batched path: (block, channel) pairs whose Q44 gain the collation
    # folded (ops/args._fold_exact); 0 on physical gains
    gain_folds: int = 0
    retries: int = 0  # windows re-dispatched after a device error
    underruns: int = 0  # the sink's count at the end of the run (paced sinks)
    failovers: int = 0  # realtime backend failovers (RealtimeSupervisor)
    failbacks: int = 0  # probed returns to the device path (DeviceProbe)
    events: list = field(default_factory=list)  # attributed runtime events
    #: seconds from the supervisor's failover decision to the first
    #: native-engine block landing at the sink (None until a failover
    #: completes its first native write)
    failover_latency_s: float | None = None

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def realtime_factor(self) -> float:
        # One block = 0.1 s of signal.
        return (self.blocks * 0.1) / self.wall_seconds if self.wall_seconds else 0.0


class RealtimeDeficitError(RuntimeError):
    """A paced realtime run fell durably below 1x and the policy is
    'fail' (or failover was impossible), or its failback probe found the
    device path broken."""


class RealtimeSupervisor:
    """Realtime degradation watchdog.

    The reference's only pacing mechanism is the blocking FIFO
    (fifo.c:97-148): when the producer cannot sustain 1x the radio
    silently starves. Here every paced run is watched for a sustained
    production deficit (wall clock ahead of written signal by more than a
    fraction of the FIFO's pre-render budget) and responds per
    ``cfg.realtime_policy``:

      * ``failover`` (default) — switch synthesis to the native
        sequential C++ engine (sequential-exact, so a strict-parity
        stream continues byte-identically) with a logged, attributed
        event; if that engine is unavailable, escalate to ``fail``.
      * ``fail`` — raise RealtimeDeficitError with the attribution.
      * ``warn`` — log and keep counting (reference behavior, plus
        attribution).

    Deficits caused by the TRANSPORT (sink FIFO full — the consumer is
    below the DAC rate) are attributed separately and never trigger a
    synthesis failover, which could not help.
    """

    #: consecutive over-threshold checks before acting when starvation is
    #: NOT imminent (one transient scheduling hiccup inside the lead band
    #: must not abandon the device path)
    GRACE_CHECKS = 2

    #: act when lag exceeds this FRACTION of the FIFO pre-render budget,
    #: while lead remains to cover the switch. Grace applies to the whole
    #: (ACT_FRACTION*budget, budget) band; only a lag at or beyond the
    #: FULL budget — the sink is starving NOW — skips grace.
    ACT_FRACTION = 0.5

    #: a failback that fails over AGAIN within this much written signal
    #: (blocks of 0.1 s) is a flap: each flap doubles the failback probe
    #: interval (capped); a failback that survives past the window resets
    #: it.
    FLAP_WINDOW_BLOCKS = 300
    PROBE_BACKOFF_CAP = 8

    def __init__(self, cfg: SimConfig, sink: Sink, stats: RunStats):
        self.cfg = cfg
        self.sink = sink
        self.stats = stats
        self.policy = cfg.realtime_policy
        if self.policy not in ("failover", "fail", "warn"):
            raise ValueError(
                f"realtime_policy={self.policy!r}: expected failover, "
                "fail, or warn"
            )
        self.failed_over = False
        self._strikes = 0
        self.probe_backoff = 1
        self._last_failback_blocks: int | None = None

    def note_failback(self) -> None:
        """Record a probe-driven failback (flap accounting: the next
        failover within FLAP_WINDOW_BLOCKS doubles the probe interval)."""
        self.failed_over = False
        self._strikes = 0
        self._last_failback_blocks = self.stats.blocks

    def _event(self, msg: str) -> None:
        logger.warning("realtime: %s", msg)
        self.stats.events.append(msg)

    def check(self, t0: float, now: float | None = None) -> str | None:
        """Call after each written block/window; returns 'failover' when
        the caller must switch synthesis to the native engine. ``now``
        overrides the clock sample for deterministic unit tests."""
        if now is None:
            now = time.perf_counter()
        lag = (now - t0) - self.stats.blocks * 0.1
        budget = 0.1 * self.cfg.fifo_depth
        if lag <= budget * self.ACT_FRACTION:
            self._strikes = 0
            return None
        self._strikes += 1
        # In-band lag (below the full budget) gets the grace window
        # whatever its growth rate; lag >= budget is starving now: act on
        # the first strike.
        if self._strikes < self.GRACE_CHECKS and lag < budget:
            return None
        self._strikes = 0
        underruns = getattr(self.sink, "underruns", 0)
        if getattr(self.sink, "backlogged", False):
            msg = (
                f"sink transport below 1x realtime: production is "
                f"{lag:.2f}s behind wall clock with the sink FIFO full "
                f"(transport cannot sustain the DAC byte rate)"
            )
            self._event(msg)
            if self.policy == "fail":
                raise RealtimeDeficitError(msg)
            return None  # a synthesis failover cannot help a slow sink
        msg = (
            f"synthesis below 1x realtime: {lag:.2f}s behind wall clock"
            + (f", {underruns} sink underruns" if underruns else "")
        )
        if self.policy == "fail":
            self._event(msg)
            raise RealtimeDeficitError(msg)
        if self.policy == "warn" or self.failed_over:
            self._event(msg)
            return None
        # failover
        from .ops.synth_seq import seq_available

        if not seq_available():
            raise RealtimeDeficitError(
                msg + "; native sequential engine unavailable, cannot "
                "fail over (tools/build_native.sh)"
            )
        if self._last_failback_blocks is not None:
            flapped = (self.stats.blocks - self._last_failback_blocks
                       < self.FLAP_WINDOW_BLOCKS)
            self.probe_backoff = (
                min(self.probe_backoff * 2, self.PROBE_BACKOFF_CAP)
                if flapped else 1
            )
        self.failed_over = True
        self.stats.failovers += 1
        self._event(
            msg + " -> failing over to the native sequential backend"
        )
        return "failover"


class DeviceProbe:
    """Failback probe: after a RealtimeSupervisor failover, the native
    engine carries the paced stream while this probe shadow-dispatches ONE
    window of upcoming plans to the device and measures dispatch → result
    wall time in a background thread (the probed plans are also written
    natively, so the stream never depends on the probe). CONFIRM
    consecutive windows at >= MARGIN x realtime prove the device path
    healthy, and the runner fails back to it: block index is the only
    state and every backend writes the same bytes.

    At most one probe is in flight, so a probe never shares the device
    path's CUDA streams with another, and none is running when the caller
    resumes the device path (a verdict is read only once its probe has
    finished). A probe whose dispatch or result raises is "slow", and its
    exception is logged, recorded in ``events`` and kept in ``error``:
    :func:`native_until_failback` ends the run with it, so a kernel that
    fails to launch cannot hide behind the native engine.
    """

    #: a probe window must complete at this multiple of realtime —
    #: failing back at exactly 1.0x would flap straight back into the
    #: supervisor's deficit band
    MARGIN = 2.0

    #: consecutive healthy windows required before failing back (one
    #: window can burst at margin on transport buffer headroom alone)
    CONFIRM = 2

    def __init__(self, dispatch, window_blocks: float,
                 events: list | None = None):
        self._dispatch = dispatch  # plans -> InFlight
        self._window = window_blocks
        self._events = events
        self._done: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._dt: list = []
        self._err: list = []
        self._streak = 0
        #: the exception of the last probe that raised, else None
        self.error: BaseException | None = None

    def start(self, plans, window_blocks: float | None = None) -> None:
        """Probe a window (plans are NOT consumed — the caller still
        writes them natively). ``window_blocks`` (signal time of the
        window in blocks of 0.1 s) replaces the one given at construction.

        All probe work — collate, pack, dispatch and the wait — runs on
        the background thread: the caller is the thread holding the paced
        streams, and the native writers release the GIL inside the C
        engine, so the probe's host work interleaves instead of blocking.
        ``dispatch`` enters its own CUDA stream context, which is per
        thread."""
        if window_blocks is not None:
            self._window = window_blocks
        done = threading.Event()
        dt, err = self._dt, self._err = [], []
        dispatch = self._dispatch

        def run_probe():
            try:
                t0 = time.perf_counter()
                dispatch(plans).result()
                dt.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — recorded by poll()
                err.append(e)
            finally:
                done.set()

        self._done = done
        self._thread = threading.Thread(target=run_probe, daemon=True,
                                        name="gpssim-failback-probe")
        self._thread.start()

    def poll(self) -> str:
        """'idle' (no probe started / previous verdict consumed),
        'pending', 'confirm' (window healthy — start the next probe
        immediately; CONFIRM consecutive windows prove the path),
        'healthy' (confirmed — fail back), or 'slow'."""
        if self._done is None:
            return "idle"
        if not self._done.is_set():
            return "pending"
        dt = self._dt[0] if self._dt else None
        self._done = None
        for e in self._err:
            msg = f"device path probe failed: {type(e).__name__}: {e}"
            logger.warning("realtime: %s", msg, exc_info=e)
            if self._events is not None:
                self._events.append(msg)
            self.error = e
        if dt is not None and dt <= self._window * 0.1 / self.MARGIN:
            self._streak += 1
            if self._streak >= self.CONFIRM:
                self._streak = 0
                return "healthy"
            return "confirm"
        self._streak = 0
        return "slow"

    def join(self, timeout: float | None = None) -> None:
        """Wait for the probe in flight, if any, to finish."""
        if self._thread is not None:
            self._thread.join(timeout)


def pace(blocks: int, t0: float, fifo_depth: int) -> None:
    """Hold written signal at most the FIFO's depth (``fifo_depth`` blocks
    of 0.1 s) ahead of the wall clock since ``t0`` — the reference's
    8-buffer pipeline latency (sdr.h:24). The sink's FIFO handles the
    fine-grained backpressure; this guards the no-consumer case."""
    ahead = blocks * 0.1 - (time.perf_counter() - t0)
    if ahead > 0.1 * fifo_depth:
        time.sleep(ahead - 0.1 * fifo_depth)


def resolve_device(cfg: SimConfig):
    """The torch device for the cuda/torch backends (:func:`torch_device`
    of ``cfg.device``)."""
    return torch_device(cfg.device)


def torch_device(name):
    """``name`` as a torch device. ``cuda`` without a card raises: the
    CPU runs only when the caller asks for it."""
    import torch

    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={name!r}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} but torch finds no CUDA device; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def dispatch_window(cfgs, window: int | None = None) -> int:
    """Blocks per launch of one scenario (a SimConfig) or of a fleet (a
    list of them).

    One scenario: ``cfg.dispatch_blocks``. A realtime or interactive run
    caps it at half the FIFO depth: with two windows in flight the
    producer then runs at most ``fifo_depth`` blocks ahead of written
    output — the reference's pipeline latency (sdr.h:24), so a live
    position edit reaches the stream within the same bound. A fleet:
    ``window`` if given; realtime, that bound for each member whatever
    ``dispatch_blocks`` says; else one round or ``dispatch_blocks``,
    whichever is larger."""
    if isinstance(cfgs, SimConfig):
        window = max(1, cfgs.dispatch_blocks)
        if cfgs.realtime or cfgs.interactive:
            window = max(1, min(window, cfgs.fifo_depth // 2))
        return window
    if window is not None:
        return window
    if cfgs[0].realtime:
        return len(cfgs) * max(1, cfgs[0].fifo_depth // 2)
    return max(cfgs[0].dispatch_blocks, len(cfgs))


def prepare_device(cfg: SimConfig, device, blocks: int,
                   channels: int | None = None) -> None:
    """What a paced run's first window would otherwise pay inside the
    paced clock, done before it starts: the collation engine's load (and
    its build, the first time); on a card also CUDA's start-up on
    ``device``, the kernel library's load (and its build, the first
    time), the K1 grid query its launch makes (which loads the kernel's
    module) for windows of ``blocks`` blocks of ``channels`` channels
    (default ``cfg.num_channels``), and a first pinned-buffer round trip.
    It launches no kernel."""
    from .ops.args import LANES, load_engine, needs_wide_window

    load_engine()
    if device.type != "cuda":
        return
    import torch

    bits = cfg.sample_format.value
    n = cfg.samples_per_epoch
    if cfg.backend is SynthBackend.CUDA:
        from .ops.synth_cuda import prepare

        prepare(device, blocks=blocks,
                channels=channels or cfg.num_channels, n_rows=-(-n // LANES),
                num_samples=n, out_bits=bits,
                wide=needs_wide_window(1.0 / cfg.sample_rate))
    host = torch.empty(blocks * 2 * n * bits // 8, dtype=torch.uint8,
                       pin_memory=True)
    host.copy_(host.to(device, non_blocking=True), non_blocking=True)
    torch.cuda.synchronize(device)


def strict_parity_enabled(cfg: SimConfig) -> bool:
    """Whether output must replay the reference's sequential-f64 phase
    semantics exactly (parity_exact + the native engine present)."""
    if not cfg.parity_exact:
        return False
    from .ops.synth_seq import seq_available

    return seq_available()


def make_synth_fn(cfg: SimConfig):
    """Resolve the block synthesizer of a host backend (numpy, native).

    Under strict parity the closed-form NumPy output is patched with the
    sparse sequential corrections (ops/synth_seq.py); the native hot loop
    is sequential-exact itself. The cuda/torch backends run windows of
    blocks through :func:`_run_batched` instead.
    """
    int_nco = cfg.carrier_mode is CarrierMode.INT_NCO
    strict = strict_parity_enabled(cfg)
    if cfg.backend is SynthBackend.NUMPY:
        if strict:
            from .ops.synth_seq import synth_block_seq

            return lambda plan: synth_block_seq(plan, int_nco=int_nco)
        return lambda plan: synth_block_numpy(plan, int_nco=int_nco)
    if cfg.backend is SynthBackend.NATIVE:
        from .ops.synth_seq import seq_available, synth_block_seq_native

        if not seq_available():
            raise RuntimeError(
                "native backend requires the C++ runtime "
                "(tools/build_native.sh)"
            )
        # The native hot loop IS sequential-exact — no patch layer needed.
        return lambda plan: synth_block_seq_native(plan, int_nco=int_nco)
    raise ValueError(f"unknown backend {cfg.backend}")


def run_simulation(
    cfg: SimConfig,
    sink: Sink | None = None,
    sim: Simulation | None = None,
    on_block=None,
    stop=None,
) -> RunStats:
    """Run a full scenario to the configured sink. Returns throughput stats.

    on_block(stats, sim, plan) is called after each block (or window) is
    written (checkpointing, metrics); stop() → True aborts cleanly between
    blocks. ``sim.consistent_snapshot`` holds the state of the blocks
    written while the planner runs ahead of them (None when the live state
    is that state).

    cuda/torch runs take the window pipeline :func:`_run_batched` as its
    one member, in windows of :func:`dispatch_window` blocks; numpy/native
    runs go block by block."""
    device = None
    if cfg.backend in DEVICE_BACKENDS:
        device = resolve_device(cfg)  # no card for device="cuda" raises
    if sim is None:
        sim = Simulation(cfg)
    if sink is None:
        sink = make_configured_sink(cfg)

    if device is not None:
        from .checkpoint import capture_state

        member = Member(cfg, sim, sink)
        window = dispatch_window(cfg)
        if cfg.realtime:
            prepare_device(cfg, device, window)

        def keep(snap) -> None:
            sim.consistent_snapshot = snap

        hook = None
        if on_block is not None:
            def hook(items, synced: bool) -> None:
                if synced:
                    on_block(member.stats, sim, items[-1][1])

        _run_batched([member], ((0, p) for p in sim.iter_plans()),
                     _packed_dispatch(cfg, device), window,
                     lambda: member.stats.blocks, keep,
                     lambda: capture_state(sim), hook, stop)
        return member.stats

    sink.init(cfg)
    synth_fn = make_synth_fn(cfg)
    bits = cfg.sample_format.value
    base_index = sim.next_block_index  # noise keying (resume-stable)
    if cfg.noise_std_lsb > 0.0:
        from .noise import apply_awgn

    stats = RunStats()
    supervisor = RealtimeSupervisor(cfg, sink, stats) if cfg.realtime else None
    t_act: float | None = None  # failover decision time (latency metric)
    t0 = time.perf_counter()
    try:
        tp = time.perf_counter()
        for plan in sim.iter_plans():
            ts = time.perf_counter()
            stats.plan_seconds += ts - tp
            iq16 = np.asarray(synth_fn(plan))
            te = time.perf_counter()
            stats.synth_seconds += te - ts
            blk = quantize_iq(iq16, bits)
            if cfg.noise_std_lsb > 0.0:
                blk = apply_awgn(blk, bits, cfg.noise_std_lsb,
                                 cfg.noise_seed, 0,
                                 base_index + stats.blocks)
            sink.write(blk)
            if t_act is not None and stats.failover_latency_s is None:
                stats.failover_latency_s = time.perf_counter() - t_act
            stats.blocks += 1
            stats.samples += plan.num_samples
            stats.wall_seconds = te - t0
            if on_block is not None:
                on_block(stats, sim, plan)
            if stop is not None and stop():
                break
            if cfg.realtime:
                pace(stats.blocks, t0, cfg.fifo_depth)
                if supervisor.check(t0) == "failover":
                    t_act = time.perf_counter()
                    synth_fn = _native_synth_fn(cfg)
            tp = time.perf_counter()
    finally:
        sink.close()
    stats.wall_seconds = time.perf_counter() - t0
    stats.underruns = getattr(sink, "underruns", 0)
    return stats


def _native_synth_fn(cfg: SimConfig, bits: int = 16):
    """Per-block native sequential synthesizer (the failover target —
    sequential-exact, so a strict-parity stream continues byte-
    identically). bits=8 quantizes (>>4) inside the native loop."""
    from .ops.synth_seq import synth_block_seq_native

    int_nco = cfg.carrier_mode is CarrierMode.INT_NCO
    return lambda plan: synth_block_seq_native(
        plan, int_nco=int_nco, bits=bits
    )


def resolve_batch_kernel(cfg: SimConfig):
    """Batched kernel + static call facts for a config.

    Returns (kernel, wide, n_rows, bits)."""
    from .ops.args import LANES, needs_wide_window

    if cfg.backend is SynthBackend.CUDA:
        from .ops.synth_cuda import synth_blocks_batch_cuda as kernel
    elif cfg.backend is SynthBackend.TORCH:
        from .ops.synth_torch import synth_blocks_batch_torch as kernel
    else:
        raise ValueError(f"{cfg.backend} has no batched device kernel")

    wide = needs_wide_window(1.0 / cfg.sample_rate)
    n_rows = -(-cfg.samples_per_epoch // LANES)
    bits = cfg.sample_format.value
    return kernel, wide, n_rows, bits


class InFlight:
    """One dispatched window: its host output buffer and, for each CUDA
    device that writes into it, the event recorded after its copy."""

    def __init__(self, host, done=()):
        self.host = host
        self.done = tuple(done)

    def result(self) -> np.ndarray:
        for event in self.done:
            event.synchronize()
        return self.host.numpy()


def make_packed_kernel(kernel, n_rows: int, num_samples: int, bits: int,
                       wide: bool, device):
    """Window dispatch: ``dispatch(packed, spec) -> InFlight``.

    The window's packed int32 args (ops/args.pack_args) go into one pinned
    host buffer and cross in one non-blocking copy; the kernel reads views
    of the device copy (ops/args.unpack_args). Its output comes back by a
    non-blocking copy into a pinned host buffer, followed by an event. The
    windows alternate between two CUDA streams, so one window's copy back
    overlaps the next window's kernel. On the CPU the call is synchronous.

    A window dropped unread (a realtime failover) is safe to drop: the
    caching host allocator records an event for each non-blocking copy of
    a pinned buffer and hands the buffer out again only after it.
    """
    import torch

    from .ops.args import unpack_args

    def launch(args):
        return kernel(args, n_rows=n_rows, num_samples=num_samples,
                      out_bits=bits, wide=wide)

    if device.type != "cuda":
        def dispatch_cpu(packed, spec):
            return InFlight(launch(unpack_args(torch.from_numpy(packed), spec)))

        return dispatch_cpu

    streams = [torch.cuda.Stream(device) for _ in range(2)]
    turn = itertools.count()

    def dispatch(packed, spec):
        stream = streams[next(turn) % len(streams)]
        host_in = torch.from_numpy(packed).pin_memory()
        with torch.cuda.stream(stream):
            dev_in = host_in.to(device, non_blocking=True)
            out = launch(unpack_args(dev_in, spec))
            host_out = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            host_out.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return InFlight(host_out, (done,))

    return dispatch


def fetch_batch(fut: InFlight, redispatch) -> tuple[np.ndarray, bool]:
    """Wait for a window with the transient-failure retry policy.

    Out of memory re-raises at once — a re-run would fail the same way.
    Any other device error re-dispatches the window once, to the same
    kernel: every block is a pure function of its plan. Returns
    (host_array, retried).

    The array is read-only, so a native sink lends its rows instead of
    copying them (``Sink.write``): every dispatch (``make_packed_kernel``
    on the card and on the CPU, ``parallel.shard``'s mesh) allocates the
    window's host output anew, and no one writes into it again."""
    import torch

    try:
        host, retried = fut.result(), False
    except torch.cuda.OutOfMemoryError:
        raise
    except RuntimeError:
        host, retried = redispatch().result(), True
    host.flags.writeable = False
    return host, retried


@dataclass
class Member:
    """One scenario of a batched run: its config, planner, sink and stats.
    ``base_index`` keys its noise (resume-stable: the planner's cursor
    when the run starts)."""

    cfg: SimConfig
    sim: Simulation
    sink: Sink
    stats: RunStats = field(default_factory=RunStats)

    def __post_init__(self):
        self.base_index = self.sim.next_block_index


class _RunView:
    """A batched run as the RealtimeSupervisor and the failback see it,
    passed as both their sink and their stats. ``blocks`` is the pacing
    count, which the loop keeps current. The members' sinks count as one:
    backlogged when any is (that stream's consumer is below the DAC rate;
    a synthesis failover cannot help), their underruns summed. The verdicts
    booked (events, failovers, failbacks, the failover latency) land on
    member 0's RunStats, where callers read them during and after the run.
    """

    def __init__(self, members: list):
        self.__dict__.update(blocks=0, _sinks=[mb.sink for mb in members],
                             _stats=members[0].stats)

    @property
    def backlogged(self) -> bool:
        return any(getattr(s, "backlogged", False) for s in self._sinks)

    @property
    def underruns(self) -> int:
        return sum(getattr(s, "underruns", 0) for s in self._sinks)

    def __getattr__(self, name):
        return getattr(self._stats, name)

    def __setattr__(self, name, value):
        if name == "blocks":
            self.__dict__[name] = value
        else:
            setattr(self._stats, name, value)


def probe_window_blocks(items) -> float:
    """Signal time, in blocks of 0.1 s, of a probe window of (member,
    plan) items: round-robin over the members actually in it, so a fleet
    whose members have finished is not judged by those members."""
    return len(items) / len({member for member, _ in items})


def _window_batch(cfg: SimConfig, plans: list, window: int, pad: bool):
    """Collate a window of plans; with ``pad``, a short tail window is
    padded to ``window`` blocks (synthesized and dropped), so every launch
    has one shape. Compaction trims the channel axis to the window's max
    active count in multiples of 4; a paced or interactive run keeps the
    full axis: one launch shape, whatever a live edit does."""
    from .ops.args import collate_plans

    if pad and len(plans) < window:
        plans = plans + [plans[-1]] * (window - len(plans))
    return collate_plans(plans, int_nco=cfg.carrier_mode is CarrierMode.INT_NCO,
                         compact=not (cfg.realtime or cfg.interactive),
                         compact_multiple=4)


def _packed_dispatch(cfg: SimConfig, device):
    """The window dispatcher on one device: ``batch -> redispatch``, where
    ``redispatch()`` launches the batch's packed window through
    :func:`make_packed_kernel` and returns its :class:`InFlight`."""
    from .ops.args import pack_args

    kernel, wide, n_rows, bits = resolve_batch_kernel(cfg)
    launch = make_packed_kernel(kernel, n_rows, cfg.samples_per_epoch, bits,
                                wide, device)

    def dispatch(batch):
        packed, spec = pack_args(batch)
        return lambda: launch(packed, spec)

    return dispatch


def _run_batched(members: list, items, dispatch, window: int, paced_blocks,
                 keep, snapshot=None, hook=None, stop=None) -> None:
    """The window pipeline of the cuda/torch backends, for one scenario
    (:func:`run_simulation`) and for a fleet (``fleet.run_fleet``).

    ``items`` yields (member index, plan) in write order. Each window of
    ``window`` items is planned, collated (:func:`_window_batch`), packed
    and launched by ``dispatch`` (``batch -> redispatch``, on one device
    or a fleet's mesh), then waited for, corrected under strict parity and
    written to its members' sinks. Two windows are in flight, so one
    window's copy back, corrections and writes overlap the next one's
    kernel. A realtime run paces and is supervised after each window; a
    failover goes on natively (:func:`_native_tail`). Each stage of a
    window is a :func:`trace.span` under the window's number. Host stage
    times, retries and the supervisor's verdicts are booked on member 0;
    blocks, samples, gain folds and corrections on the block's member.

    Besides members, items, dispatcher and window, the callers differ
    only in these callables:

    * ``paced_blocks()``: the written signal, in blocks, that pacing and
      the supervisor follow; None once nothing is left to pace. One
      scenario: its blocks; a fleet: its slowest live member's.
    * ``snapshot()``: the state of every plan handed out so far, taken at
      each launch; ``keep(snap)`` gets it once the window is at the sinks,
      and None when the live state is the written state again (or no
      snapshot is taken). One scenario: ``capture_state`` into
      ``sim.consistent_snapshot``; a fleet: ``capture_fleet_state``, only
      when it checkpoints.
    * ``hook(items, synced)``: after each window (synced), and in the
      native tail once per round of members, synced while no probed plan
      waits. One scenario: ``on_block`` when synced; a fleet:
      ``on_batch``, and its 30 s checkpoint when synced.
    * ``stop()``: True ends the run between windows.
    """
    from .trace import span

    cfg0 = members[0].cfg
    realtime = cfg0.realtime
    int_nco = cfg0.carrier_mode is CarrierMode.INT_NCO
    bits = cfg0.sample_format.value
    strict = strict_parity_enabled(cfg0)
    if strict:
        from .ops.synth_seq import correct_window
    if any(mb.cfg.noise_std_lsb > 0.0 for mb in members):
        from .noise import apply_awgn
    st0 = members[0].stats
    watch = _RunView(members)
    supervisor = None
    if realtime:
        supervisor = RealtimeSupervisor(cfg0, watch, watch)
    # (in_flight, redispatch, items, snapshot, window number)
    pending: deque = deque()
    any_full = False  # a full window has been dispatched

    def taken():
        return snapshot() if snapshot is not None else None

    # Nothing written yet: a stop before the first window drains must keep
    # the pre-run state, not the planner's run-ahead state.
    keep(taken())

    def drain(window: tuple) -> None:
        """Write a window taken from ``pending`` to its sinks."""
        fut, redispatch, done, snap, k = window
        tf = time.perf_counter()
        with span("wait", k):
            host, retried = fetch_batch(fut, redispatch)  # quantized
        tc = time.perf_counter()
        st0.fetch_seconds += tc - tf
        st0.retries += retried  # one re-dispatch, booked once
        blocks = list(host[:len(done)])
        if strict:
            with span("correct", k):
                blocks, cands, patched = correct_window(
                    blocks, [p for _, p in done], bits, int_nco)
            for (m, _), c, n in zip(done, cands.tolist(), patched.tolist()):
                st = members[m].stats
                st.correct_candidates += c
                st.correct_samples += n
                st.correct_blocks += n > 0
        st0.correct_seconds += time.perf_counter() - tc
        with span("sink", k):
            for blk, (m, plan) in zip(blocks, done):
                mb = members[m]
                st, mc = mb.stats, mb.cfg
                if mc.noise_std_lsb > 0.0:
                    # keyed per member stream: a fleet member's noisy
                    # bytes equal its solo run's
                    blk = apply_awgn(blk, bits, mc.noise_std_lsb,
                                     mc.noise_seed, 0,
                                     mb.base_index + st.blocks)
                mb.sink.write(blk)
                st.blocks += 1
                st.samples += plan.num_samples
                st.wall_seconds = time.perf_counter() - t0
        # A snapshot taken at launch: by now the planner has run ahead, and
        # hooks must see the state of the blocks actually written, or a
        # checkpoint would skip the in-flight window on resume.
        keep(snap)
        if hook is not None:
            with span("hook", k):
                hook(done, True)

    inited = 0
    try:
        for mb in members:
            mb.sink.init(mb.cfg)
            inited += 1
        t0 = time.perf_counter()
        for k in itertools.count():
            ts = time.perf_counter()
            with span("plan", k):
                tagged = list(itertools.islice(items, window))
            tp = time.perf_counter()
            st0.plan_seconds += tp - ts
            if tagged:
                with span("collate", k):
                    batch = _window_batch(cfg0, [p for _, p in tagged],
                                          window, pad=any_full)
                    if batch.folds.any():
                        for (m, _), n in zip(tagged, batch.folds):
                            members[m].stats.gain_folds += int(n)
                with span("pack", k):
                    redispatch = dispatch(batch)
                any_full = any_full or len(tagged) == window
                with span("launch", k):
                    fut = redispatch()
                st0.synth_seconds += time.perf_counter() - tp
                snap = None
                if snapshot is not None:
                    with span("snapshot", k):
                        snap = snapshot()
                pending.append((fut, redispatch, tagged, snap, k))
            if (not tagged and pending) or len(pending) >= 2:
                # Held until the next one is taken: freeing its buffers then
                # overlaps the card's work, not its idle time (unspanned).
                drained = pending.popleft()
                drain(drained)
                live = paced_blocks() if realtime else None
                verdict = None
                if live is not None:
                    watch.blocks = live
                    with span("pace", drained[4]):
                        pace(live, t0, cfg0.fifo_depth)
                        verdict = supervisor.check(t0)
                if verdict == "failover":
                    if not _native_tail(members, pending, items, window,
                                        dispatch, supervisor, watch, t0,
                                        paced_blocks, keep, hook, stop):
                        break
                    # Failback: every plan handed out is written, so the
                    # live state matches the stream again; the loop goes
                    # on from the next unwritten plan.
                    keep(taken())
                    continue
            if not tagged and not pending:
                keep(None)  # the live state matches the written blocks
                break
            if stop is not None and stop():
                # Stopped with a window in flight: the last kept snapshot
                # stays, so a final checkpoint skips no unwritten block.
                break
    finally:
        # End-of-stream on every sink first (non-blocking): close() below
        # flushes each paced sink at the DAC rate in turn, and a later
        # sink's pacer must not count that wait as underruns. A caller's
        # sink need not have it (nor any method but init, write, close).
        for mb in members[:inited]:
            getattr(mb.sink, "end_stream", lambda: None)()
        for mb in members[:inited]:
            mb.sink.close()
    wall = time.perf_counter() - t0
    for mb in members:
        if mb.stats.blocks:
            mb.stats.wall_seconds = wall
        mb.stats.underruns = getattr(mb.sink, "underruns", 0)


def _make_native_writer(member: Member, t0: float, t_act: float,
                        latency_stats):
    """A member's per-block native synth→quantize→noise→write→stats
    sequence for the failover paths; records failover_latency_s, decision
    to the first native block at any sink, on ``latency_stats``.

    Clean 8-bit streams quantize inside the native loop (one fewer
    full-block numpy pass per 0.1 s); noisy/16-bit streams keep the
    quantize-then-noise order of the batched path."""
    cfg, sink, stats = member.cfg, member.sink, member.stats
    noisy = cfg.noise_std_lsb > 0.0
    bits = cfg.sample_format.value
    direct8 = bits == 8 and not noisy
    synth_fn = _native_synth_fn(cfg, bits=8 if direct8 else 16)
    if noisy:
        from .noise import apply_awgn

    def write_block(plan) -> None:
        ts = time.perf_counter()
        blk = np.asarray(synth_fn(plan))
        stats.synth_seconds += time.perf_counter() - ts
        if not direct8:
            blk = quantize_iq(blk, bits)
        if noisy:
            blk = apply_awgn(blk, bits, cfg.noise_std_lsb, cfg.noise_seed,
                             0, member.base_index + stats.blocks)
        sink.write(blk)
        if latency_stats.failover_latency_s is None:
            latency_stats.failover_latency_s = time.perf_counter() - t_act
        stats.blocks += 1
        stats.samples += plan.num_samples
        stats.wall_seconds = time.perf_counter() - t0

    return write_block


def _native_tail(members: list, pending, items, window: int, dispatch,
                 supervisor: RealtimeSupervisor, watch: _RunView, t0: float,
                 paced_blocks, keep, hook=None, stop=None) -> bool:
    """Carry a realtime run on the native sequential engine after a
    RealtimeSupervisor failover (the callables as in :func:`_run_batched`).

    First the in-flight windows, each kept and hooked as a drained device
    window is, their device results left unread: the native engine writes
    the same bytes, and restores the sinks' lead in milliseconds. Then the
    rest of ``items`` through :func:`native_until_failback`, hooked once
    per round of members, with ``watch.blocks`` current after every write
    for the supervisor's flap count.

    Returns True once a probe proved the device path healthy and every
    probed item is written (the caller resumes from the next unwritten
    one), and False when the run ended (items done, or stop())."""
    cfg0 = members[0].cfg
    t_act = time.perf_counter()
    writers = [_make_native_writer(mb, t0, t_act, watch) for mb in members]

    def write_item(item) -> None:
        m, plan = item
        writers[m](plan)

    def paced() -> int | None:
        live = paced_blocks()
        if live is not None:
            watch.blocks = live
        return live

    while pending:
        _fut, _redispatch, done, snap, _k = pending.popleft()
        for item in done:
            write_item(item)
        live = paced()
        if live is not None:
            pace(live, t0, cfg0.fifo_depth)
        keep(snap)
        if hook is not None:
            hook(done, True)
        if stop is not None and stop():
            return False
    keep(None)  # every plan handed out is written
    writes = 0

    def after_item(item, synced: bool) -> bool:
        nonlocal writes
        writes += 1
        live = paced()
        if writes % len(members):
            return False  # the rest once per round of members
        if hook is not None:
            hook([item], synced)
        if stop is not None and stop():
            return True
        if live is not None:
            pace(live, t0, cfg0.fifo_depth)
        return False

    probe = None
    if cfg0.failback_probe_sec > 0:
        probe = DeviceProbe(
            lambda plans: dispatch(
                _window_batch(cfg0, plans, window, pad=True))(),
            window / len(members), watch.events)

    def start_probe(probed) -> None:
        probe.start([p for _, p in probed],
                    window_blocks=probe_window_blocks(probed))

    return native_until_failback(
        items, write_item, after_item, supervisor, watch, probe, window,
        start_probe, items_per_tick=len(members))


def native_until_failback(
    it, write_item, after_item, supervisor: RealtimeSupervisor,
    stats: RunStats, probe: DeviceProbe | None, window: int,
    start_probe=None, items_per_tick: int = 1,
) -> bool:
    """Carry a realtime run item by item on the native engine after a
    RealtimeSupervisor failover, probing the device path for failback:
    the one failback policy of the single-scenario runner and of fleets.

    ``it`` yields the unwritten items (plans, or a fleet's (member, plan)
    pairs) and ``write_item(item)`` writes one natively. After each write,
    ``after_item(item, synced)`` does the caller's per-item work — pacing,
    hooks, and checkpoints only when ``synced`` (no probed item waits in
    the buffer, so the live planner state is the written state) — and
    returns True when stop() ends the run.

    Every ``cfg.failback_probe_sec`` of written signal (``items_per_tick``
    items per 0.1 s, times the supervisor's flap backoff),
    ``start_probe(items)`` (default ``probe.start``) shadow-dispatches the
    next ``window`` items to the device; they wait in a buffer and are
    written natively in turn, so the stream never waits on the probe.
    Returns True when a probe proves the device path healthy — after
    writing every buffered item, so the caller resumes from the next
    unwritten one — and False when the scenario finished or stop() ended
    the run. A probe that raised ends the run, once the buffered items
    are written, with RealtimeDeficitError chained from its exception: the
    device path is broken, and a device run does not go on carrying its
    stream on the host's native engine."""
    if start_probe is None and probe is not None:
        start_probe = probe.start
    buf: deque = deque()  # probed items awaiting their native write

    def write_buffered() -> None:
        while buf:
            item = buf.popleft()
            write_item(item)
            after_item(item, not buf)  # drained whether or not stopped

    def launch() -> None:
        items = list(itertools.islice(it, window))
        if items:
            buf.extend(items)
            start_probe(items)

    probe_every = max(1, int(supervisor.cfg.failback_probe_sec * 10
                             * items_per_tick * supervisor.probe_backoff))
    since = 0
    try:
        while True:
            item = buf.popleft() if buf else next(it, None)
            if item is None:
                return False
            write_item(item)
            if after_item(item, not buf):
                write_buffered()
                return False
            if probe is None:
                continue
            since += 1
            verdict = probe.poll()
            if probe.error is not None:
                write_buffered()
                raise RealtimeDeficitError(
                    "device path probe failed "
                    f"({type(probe.error).__name__}: {probe.error}); the "
                    "run ends instead of going on natively"
                ) from probe.error
            if verdict == "healthy":
                write_buffered()
                supervisor.note_failback()
                stats.failbacks += 1
                msg = (
                    f"device path probe held {DeviceProbe.CONFIRM} "
                    f"consecutive windows at >= {DeviceProbe.MARGIN:g}x "
                    "realtime -> failing back to the batched device pipeline"
                )
                logger.info("realtime: %s", msg)
                stats.events.append(msg)
                return True
            if verdict == "confirm":
                # First healthy window: launch the confirmation probe
                # back-to-back so the verdict measures sustained rate, not
                # one burst into drained buffers.
                launch()
                continue
            if verdict == "pending":
                continue  # never stack a probe on a possibly-sick path
            if verdict == "slow":
                since = 0  # full interval before re-probing a sick path
            if since >= probe_every and not buf:
                since = 0
                launch()
    finally:
        if probe is not None:
            probe.join()
