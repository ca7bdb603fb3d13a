"""The PyTorch/CUDA package's realtime TX path against the JAX package.

The supervisor and the failback probe must give the JAX package's
verdicts, events and raises on the same scripted inputs. Paced runs on the
CPU (the kernels' plain versions) are forced below 1x deterministically —
``ops.args.pack_args`` stalls while a throttle is on — never by relying on
the CPU being slow, and must write the bytes of an offline run of either
package through failover, failback and with failback off, single scenario
and fleet. Where the JAX package has a fault on this path (a failback that
drops probed blocks, a checkpoint that runs ahead of the stream in the
native tail, a stale flap count and a probe window in the wrong time base
in fleets), the port is held against an offline run instead.
"""

import dataclasses
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from gpssim_tpu import checkpoint as jcheckpoint
from gpssim_tpu import fleet as jfleet
from gpssim_tpu import runner as jrunner
from gpssim_tpu.config import LocationConfig as JLocationConfig
from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.config import SynthBackend as JSynthBackend
from gpssim_tpu.parallel import blocks as jblocks
from gpssim_tpu_torch import app, checkpoint, cli, fleet, runner
from gpssim_tpu_torch.checkpoint import capture_state
from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
from gpssim_tpu_torch.io.sinks import NullSink, TcpSink
from gpssim_tpu_torch.ops import args as targs
from gpssim_tpu_torch.ops.synth_seq import seq_available
from gpssim_tpu_torch.parallel import shard as tshard
from gpssim_tpu_torch.scenario import Simulation

RATE = 1_030_000  # the lowest rate: the least CPU per paced second
NY = (40.7128, -74.0060, 20.0)
T0 = 1000.0  # a fixed run start for the scripted supervisor clocks
_REFS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _strict_parity():
    assert seq_available(), "the native engine (tools/build_native.sh)"


def _cfg(fixtures_dir, out_file, **kw):
    """A paced port scenario on the CPU at 1.03 Msps."""
    kw.setdefault("duration_sec", 3.0)
    kw.setdefault("backend", SynthBackend.CUDA)
    return SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                     almanac_enable=False, sample_rate=RATE, device="cpu",
                     realtime=True, out_file=str(out_file), **kw)


def _offline(fixtures_dir, tmp_path_factory, duration, location=None,
             pkg="port") -> np.ndarray:
    """Offline bytes of the 1.03 Msps scenario: the port's batched path
    on the CPU, or the JAX package's strict host path (run once each)."""
    key = (pkg, duration, location)
    if key not in _REFS:
        out = tmp_path_factory.mktemp("ref") / "ref.bin"
        kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n",
                  almanac_enable=False, sample_rate=RATE,
                  duration_sec=duration, out_file=str(out))
        if pkg == "port":
            if location is not None:
                kw["location"] = LocationConfig(*location)
            runner.run_simulation(SimConfig(
                **kw, backend=SynthBackend.CUDA, device="cpu"))
        else:
            if location is not None:
                kw["location"] = JLocationConfig(*location)
            jrunner.run_simulation(JSimConfig(
                **kw, backend=JSynthBackend.NUMPY))
        _REFS[key] = np.fromfile(out, dtype=np.int8)
    return _REFS[key]


def _bytes(path) -> np.ndarray:
    return np.fromfile(path, dtype=np.int8)


class Throttle:
    """``ops.args.pack_args`` stalls 0.6 s per window while ``on`` — more
    than the 0.4 s of signal in a paced 4-block window, so the device path
    falls below 1x; the failback probe's windows go through it too, and so
    do the mesh's shards. ``probe_error``, if given, is raised instead in
    the failback probe's thread."""

    def __init__(self, monkeypatch, on_for: float | None = None,
                 probe_error: Exception | None = None):
        self.on = True
        real = targs.pack_args

        def pack(args):
            if (probe_error is not None and threading.current_thread().name
                    == "gpssim-failback-probe"):
                raise probe_error
            if self.on:
                time.sleep(0.6)
            return real(args)

        monkeypatch.setattr(targs, "pack_args", pack)
        monkeypatch.setattr(tshard, "pack_args", pack)
        self._timer = None
        if on_for is not None:
            self._timer = threading.Timer(on_for, self.off)
            self._timer.daemon = True

    def off(self):
        self.on = False

    def __enter__(self):
        if self._timer is not None:
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        self.on = False


def _instant_probe(monkeypatch, throttle: Throttle):
    """Script the port's DeviceProbe: every probe finishes at once in 0 s
    (CONFIRM of them fail back) and ends the throttle."""
    def start(self, plans, window_blocks=None):
        throttle.off()
        self._done = threading.Event()
        self._done.set()
        self._dt, self._err, self._thread = [0.0], [], None

    monkeypatch.setattr(runner.DeviceProbe, "start", start)


# ---------------------------------------------------------------------------
# The supervisor and the probe, scripted, against the JAX package's.
# ---------------------------------------------------------------------------


class _StubSink:
    backlogged = False
    underruns = 0


# Steps: ("check", seconds since T0 beyond the written signal, blocks
# added first, backlogged, underruns) or ("failback", blocks added first).
# fifo_depth 2: budget 0.2 s, grace band (0.1, 0.2).
SUPERVISOR_CASES = {
    "within_budget": [("check", -0.1, 10, False, 0)],
    "grace_then_failover": [("check", 0.15, 0, False, 0)] * 4,
    "starving_no_grace": [("check", 1.0, 0, False, 0),
                          ("check", 1.0, 0, False, 0)],
    "transient_spike": [("check", 0.02, 0, False, 0),
                        ("check", 0.15, 0, False, 0),
                        ("check", 0.05, 0, False, 0),
                        ("check", 0.16, 0, False, 0)],
    "underruns_attributed": [("check", 1.0, 0, False, 3)],
    "transport_starving": [("check", 1.0, 0, True, 0),
                           ("check", 1.0, 0, True, 0)],
    "transport_grace_band": [("check", 0.15, 0, True, 0),
                             ("check", 0.15, 0, True, 0)],
    "flap_backoff": [
        ("check", 1.0, 0, False, 0), ("failback", 0),
        ("check", 1.0, 10, False, 0), ("failback", 0),
        ("check", 1.0, 10, False, 0), ("failback", 0),
        ("check", 1.0, 10, False, 0), ("failback", 0),
        ("check", 1.0, 301, False, 0),
    ],
}


def _script_supervisor(sup_cls, stats_cls, error_cls, policy, steps):
    sink = _StubSink()
    stats = stats_cls()
    cfg = dict(nav_file="unused", fifo_depth=2, realtime=True,
               realtime_policy=policy)
    sup = sup_cls((JSimConfig if sup_cls is jrunner.RealtimeSupervisor
                   else SimConfig)(**cfg), sink, stats)
    trace = []
    for step in steps:
        if step[0] == "failback":
            stats.blocks += step[1]
            sup.note_failback()
            trace.append(("failback",))
            continue
        _, lag, add, backlogged, underruns = step
        stats.blocks += add
        sink.backlogged, sink.underruns = backlogged, underruns
        try:
            out = sup.check(T0, now=T0 + stats.blocks * 0.1 + lag)
        except error_cls as e:
            out = ("raise", str(e))
        trace.append((out, list(stats.events), stats.failovers,
                      sup.probe_backoff, sup.failed_over))
    return trace


@pytest.mark.parametrize("policy", ["failover", "fail", "warn"])
@pytest.mark.parametrize("case", list(SUPERVISOR_CASES))
def test_supervisor_equals_jax(case, policy):
    steps = SUPERVISOR_CASES[case]
    want = _script_supervisor(jrunner.RealtimeSupervisor, jrunner.RunStats,
                              jrunner.RealtimeDeficitError, policy, steps)
    got = _script_supervisor(runner.RealtimeSupervisor, runner.RunStats,
                             runner.RealtimeDeficitError, policy, steps)
    assert got == want
    for name in ("GRACE_CHECKS", "ACT_FRACTION", "FLAP_WINDOW_BLOCKS",
                 "PROBE_BACKOFF_CAP"):
        assert getattr(runner.RealtimeSupervisor, name) == \
            getattr(jrunner.RealtimeSupervisor, name)


def test_supervisor_rejects_unknown_policy():
    for sup, cfg, stats in ((runner.RealtimeSupervisor, SimConfig,
                             runner.RunStats),
                            (jrunner.RealtimeSupervisor, JSimConfig,
                             jrunner.RunStats)):
        with pytest.raises(ValueError, match="realtime_policy"):
            sup(cfg(realtime_policy="nope"), _StubSink(), stats())


# Each entry: the probe's measured window times ([] = the probe died),
# None = poll while the probe is still in flight. Window 4 blocks: a probe
# must finish within 4 * 0.1 / MARGIN = 0.2 s.
PROBE_CASES = {
    "confirm_then_healthy": [[0.1], [0.1]],
    "slow_windows": [[0.5], [0.5]],
    "dead_probe_is_slow": [[], [0.1], [0.1]],
    "slow_resets_streak": [[0.1], [0.5], [0.1], [0.19]],
    "pending_then_verdicts": [None, [0.1], None, [0.2], [0.21]],
}


def _script_probe(probe, script):
    verdicts = [probe.poll()]  # idle: never started
    for dt in script:
        probe._done = threading.Event()
        if dt is not None:
            probe._done.set()
            probe._dt = dt
            probe._err = []
        verdicts.append(probe.poll())
    verdicts.append(probe.poll())
    return verdicts


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_probe_verdicts_equal_jax(case):
    want = _script_probe(jrunner.DeviceProbe(None, 4), PROBE_CASES[case])
    events = []
    got = _script_probe(runner.DeviceProbe(None, 4, events),
                        PROBE_CASES[case])
    assert got == want and events == []
    assert (runner.DeviceProbe.MARGIN, runner.DeviceProbe.CONFIRM) == \
        (jrunner.DeviceProbe.MARGIN, jrunner.DeviceProbe.CONFIRM)


def test_probe_dispatch_error_is_slow_and_recorded():
    """A probe whose dispatch raises is "slow" in both packages; the port
    also records the exception, so a kernel that fails to launch cannot
    hide behind the native engine."""
    def dispatch(plans):
        raise RuntimeError("CUDA error: launch failed")

    events = []
    probe = runner.DeviceProbe(dispatch, 4, events)
    probe.start(["plan"])
    probe.join(10)
    assert probe.poll() == "slow"
    assert events == ["device path probe failed: RuntimeError: CUDA error: "
                      "launch failed"]
    jprobe = jrunner.DeviceProbe(dispatch, 4)
    jprobe.start(["plan"])
    jprobe._done.wait(10)
    assert jprobe.poll() == "slow"


# ---------------------------------------------------------------------------
# Paced runs through a forced deficit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", [SynthBackend.CUDA, SynthBackend.TORCH])
def test_failover_bytes_equal_offline(fixtures_dir, tmp_path,
                                      tmp_path_factory, monkeypatch,
                                      backend):
    cfg = _cfg(fixtures_dir, tmp_path / "rt.bin", backend=backend)
    with Throttle(monkeypatch):
        stats = runner.run_simulation(cfg)
    assert stats.failovers == 1 and stats.failbacks == 0, stats.events
    assert "failing over" in stats.events[0]
    assert stats.blocks == cfg.num_epochs - 1
    got = _bytes(cfg.out_file)
    assert np.array_equal(got, _offline(fixtures_dir, tmp_path_factory, 3.0))
    assert np.array_equal(got, _offline(fixtures_dir, tmp_path_factory, 3.0,
                                        pkg="jax"))


def test_policy_fail_raises(fixtures_dir, tmp_path, monkeypatch):
    cfg = _cfg(fixtures_dir, tmp_path / "fail.bin", realtime_policy="fail")
    with Throttle(monkeypatch), \
            pytest.raises(runner.RealtimeDeficitError, match="below 1x"):
        runner.run_simulation(cfg)


def test_paced_tcp_zero_underruns_across_failover(
        fixtures_dir, tmp_path, tmp_path_factory, monkeypatch):
    """The failover lands before the paced sink starves: no underrun, the
    first native block within half the FIFO budget, every byte received
    and equal to an offline run."""
    from tests.test_sinks import _LoopbackServer

    srv = _LoopbackServer()
    cfg = _cfg(fixtures_dir, tmp_path / "unused.bin", sink="tcp")
    sink = TcpSink(addr=f"127.0.0.1:{srv.port}", fifo_depth=cfg.fifo_depth,
                   pace=True, start_timeout_s=120.0)
    with Throttle(monkeypatch):
        stats = runner.run_simulation(cfg, sink=sink)
    srv.join()
    assert stats.failovers == 1, stats.events
    assert stats.underruns == 0 and sink.underruns == 0
    assert stats.failover_latency_s < 0.5 * 0.1 * cfg.fifo_depth
    assert np.array_equal(np.frombuffer(bytes(srv.received), np.int8),
                          _offline(fixtures_dir, tmp_path_factory, 3.0))


@pytest.mark.parametrize("backend", [SynthBackend.CUDA, SynthBackend.TORCH])
def test_failback_round_trip_bytes_equal(fixtures_dir, tmp_path,
                                         tmp_path_factory, monkeypatch,
                                         backend):
    """Failover, then the probe (its margin relaxed: the plain version on
    one CPU thread is near 1x) fails back once the stall ends; every block
    is written and the bytes equal an offline run."""
    monkeypatch.setattr(runner.DeviceProbe, "MARGIN", 0.02)
    cfg = _cfg(fixtures_dir, tmp_path / "fb.bin", duration_sec=6.0,
               failback_probe_sec=0.2, backend=backend)
    with Throttle(monkeypatch, on_for=1.5):
        stats = runner.run_simulation(cfg)
    assert stats.failovers >= 1 and stats.failbacks >= 1, stats.events
    assert any("failing back" in e for e in stats.events)
    assert stats.blocks == cfg.num_epochs - 1
    assert np.array_equal(_bytes(cfg.out_file),
                          _offline(fixtures_dir, tmp_path_factory, 6.0,
                                   pkg="jax"))


@pytest.mark.parametrize("backend", [SynthBackend.CUDA, SynthBackend.TORCH])
def test_failback_disabled_stays_native(fixtures_dir, tmp_path,
                                        tmp_path_factory, monkeypatch,
                                        backend):
    cfg = _cfg(fixtures_dir, tmp_path / "off.bin", failback_probe_sec=0.0,
               backend=backend)
    with Throttle(monkeypatch, on_for=1.0):
        stats = runner.run_simulation(cfg)
    assert stats.failovers == 1 and stats.failbacks == 0
    assert not any("failing back" in e for e in stats.events)
    assert np.array_equal(_bytes(cfg.out_file),
                          _offline(fixtures_dir, tmp_path_factory, 3.0,
                                   pkg="jax"))


@pytest.fixture(scope="module")
def instant_failback_run(fixtures_dir, tmp_path_factory):
    """A 6 s paced run: failover, then an instantly healthy scripted probe
    every 0.2 s of signal. A spy hook records, at each call, the blocks
    written and the blocks behind the snapshot a checkpoint would take."""
    mp = pytest.MonkeyPatch()
    cfg = _cfg(fixtures_dir, tmp_path_factory.mktemp("fb1") / "fb1.bin",
               duration_sec=6.0, failback_probe_sec=0.2)
    calls = []

    def spy(stats, sim, plan):
        snap = sim.consistent_snapshot
        if snap is None:
            snap = capture_state(sim)
        tail = stats.failovers > stats.failbacks
        calls.append((stats.blocks, int(snap["iumd"]) - 1, tail))

    try:
        with Throttle(mp) as throttle:
            _instant_probe(mp, throttle)
            stats = runner.run_simulation(cfg, on_block=spy)
    finally:
        mp.undo()
    return cfg, stats, calls


def test_failback_writes_probed_blocks(instant_failback_run, fixtures_dir,
                                       tmp_path_factory):
    """The JAX package returns on a healthy verdict with the probed plans
    still buffered and never writes them; the port writes them first."""
    cfg, stats, _ = instant_failback_run
    assert stats.failovers >= 1 and stats.failbacks >= 1, stats.events
    assert stats.blocks == cfg.num_epochs - 1
    assert np.array_equal(_bytes(cfg.out_file),
                          _offline(fixtures_dir, tmp_path_factory, 6.0,
                                   pkg="jax"))


def test_native_tail_snapshot_matches_stream(instant_failback_run):
    """No hook call in the native tail sees a snapshot that runs ahead of
    the blocks at the sink while probed plans wait in the buffer."""
    _, _, calls = instant_failback_run
    assert any(tail for _, _, tail in calls)
    assert all(written == behind for written, behind, _ in calls), calls


@pytest.mark.parametrize("kind", ["single", "fleet"])
def test_probe_error_ends_paced_run(fixtures_dir, tmp_path, tmp_path_factory,
                                    monkeypatch, kind):
    """A failback probe whose dispatch raises mid-run ends the paced run
    with the error, once every probed block is written: the native engine
    never carries a device run whose kernel is broken."""
    boom = RuntimeError("CUDA error: an illegal memory access")
    hooks = []
    if kind == "single":
        cfgs = [_cfg(fixtures_dir, tmp_path / "err.bin",
                     failback_probe_sec=0.2)]

        def run():
            runner.run_simulation(cfgs[0], on_block=lambda st, sim, plan:
                                  hooks.append([st.blocks]))
    else:
        cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (3.0, 3.0),
                           failback_probe_sec=0.2, fifo_depth=4)

        def run():
            fleet.run_fleet(cfgs, on_batch=lambda stats: hooks.append(
                [st.blocks for st in stats]))
    with Throttle(monkeypatch, probe_error=boom), \
            pytest.raises(runner.RealtimeDeficitError,
                          match="probe failed") as err:
        run()
    assert err.value.__cause__ is boom
    block_bytes = 2 * cfgs[0].samples_per_epoch * \
        cfgs[0].sample_format.value // 8
    for i, c in enumerate(cfgs):
        got = _bytes(c.out_file)
        assert len(got) == hooks[-1][i] * block_bytes > 0, (i, hooks[-1])
        ref = _offline(fixtures_dir, tmp_path_factory, 3.0,
                       location=None if i == 0 else NY)
        assert len(got) < len(ref) and np.array_equal(got, ref[:len(got)]), i


# ---------------------------------------------------------------------------
# Realtime fleets.
# ---------------------------------------------------------------------------


def _fleet_cfgs(fixtures_dir, tmp_path, durations, **kw):
    locs = [None, LocationConfig(*NY)]
    return [
        _cfg(fixtures_dir, tmp_path / f"m{i}.bin", duration_sec=d,
             **({"location": locs[i]} if locs[i] else {}), **kw)
        for i, d in enumerate(durations)
    ]


def test_fleet_failback_members_equal_solo_and_jax(
        fixtures_dir, tmp_path, tmp_path_factory, monkeypatch):
    """A 2-member paced fleet fails over as a whole and fails back; each
    member equals its solo offline run and JAX run_fleet's offline
    bytes."""
    monkeypatch.setattr(runner.DeviceProbe, "MARGIN", 0.02)
    # FIFO depth 4: the first stalled window alone passes the 0.4 s budget
    cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (6.0, 6.0),
                       failback_probe_sec=0.1, fifo_depth=4)
    with Throttle(monkeypatch, on_for=0.5):
        stats = fleet.run_fleet(cfgs)
    assert stats[0].failovers >= 1 and stats[0].failbacks >= 1, \
        stats[0].events
    assert [st.blocks for st in stats] == [59, 59]
    jcfgs = [JSimConfig(nav_file=c.nav_file, almanac_enable=False,
                        sample_rate=RATE, duration_sec=6.0,
                        backend=JSynthBackend.JAX,
                        out_file=str(tmp_path / f"j{i}.bin"),
                        location=JLocationConfig(*dataclasses.astuple(
                            c.location)))
             for i, c in enumerate(cfgs)]
    jfleet.run_fleet(jcfgs)
    for i, (c, j) in enumerate(zip(cfgs, jcfgs)):
        got = _bytes(c.out_file)
        loc = None if i == 0 else NY
        assert np.array_equal(got, _offline(fixtures_dir, tmp_path_factory,
                                            6.0, location=loc, pkg="jax")), i
        assert np.array_equal(got, _bytes(j.out_file)), i


def test_fleet_failback_writes_probed_blocks(fixtures_dir, tmp_path,
                                             tmp_path_factory, monkeypatch):
    """Members of unequal duration and an instantly healthy scripted
    probe: every block of every member is written, equal to its solo
    offline run."""
    cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (4.0, 2.5),
                       failback_probe_sec=0.2)
    with Throttle(monkeypatch) as throttle:
        _instant_probe(monkeypatch, throttle)
        stats = fleet.run_fleet(cfgs)
    assert stats[0].failovers >= 1 and stats[0].failbacks >= 1, \
        stats[0].events
    assert [st.blocks for st in stats] == [39, 24]
    for i, (c, d) in enumerate(zip(cfgs, (4.0, 2.5))):
        assert np.array_equal(
            _bytes(c.out_file),
            _offline(fixtures_dir, tmp_path_factory, d,
                     location=None if i == 0 else NY, pkg="jax")), i


def test_fleet_over_mesh_failback(fixtures_dir, tmp_path, tmp_path_factory,
                                  monkeypatch):
    """The mesh branch of a paced fleet: windows and the real failback
    probe's windows sharded over a (2, 1) mesh of the CPU fail over and
    back, every member equal to its solo offline run. The stall ends
    before the failover, and the paced native tail lasts seconds: time for
    the probe's two windows however loaded the CPU is."""
    monkeypatch.setattr(runner.DeviceProbe, "MARGIN", 0.02)
    cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (6.0, 6.0),
                       failback_probe_sec=0.2, fifo_depth=4)
    with Throttle(monkeypatch, on_for=1.0):
        stats = fleet.run_fleet(cfgs, mesh=tshard.make_mesh(
            2, 1, devices=["cpu"] * 2))
    assert stats[0].failovers >= 1 and stats[0].failbacks >= 1, \
        stats[0].events
    for i, c in enumerate(cfgs):
        assert np.array_equal(
            _bytes(c.out_file),
            _offline(fixtures_dir, tmp_path_factory, 6.0,
                     location=None if i == 0 else NY, pkg="jax")), i


@pytest.mark.parametrize("backend", [SynthBackend.NUMPY, SynthBackend.NATIVE])
def test_host_loop_paced_failover(fixtures_dir, tmp_path, tmp_path_factory,
                                  monkeypatch, backend):
    """The block-by-block host loop paces and supervises too: a host
    synthesizer stalled below 1x fails over to the native engine, and the
    bytes stay those of an offline run."""
    real = runner.make_synth_fn

    def slow(cfg):
        fn = real(cfg)

        def synth(plan):
            time.sleep(0.15)  # > the 0.1 s of signal per block
            return fn(plan)
        return synth

    monkeypatch.setattr(runner, "make_synth_fn", slow)
    cfg = _cfg(fixtures_dir, tmp_path / "host.bin", backend=backend,
               duration_sec=2.0, fifo_depth=2)
    stats = runner.run_simulation(cfg)
    assert stats.failovers == 1, stats.events
    assert stats.failover_latency_s is not None
    assert np.array_equal(_bytes(cfg.out_file),
                          _offline(fixtures_dir, tmp_path_factory, 2.0,
                                   pkg="jax"))


def _fleet_tail(cfgs):
    """A paced fleet's members with NullSinks, and the supervisor and its
    view of the run as ``runner._run_batched`` makes them."""
    sims = [Simulation(c) for c in cfgs]
    sinks = [NullSink() for _ in cfgs]
    members = [runner.Member(c, s, k) for c, s, k in zip(cfgs, sims, sinks)]
    agg = runner._RunView(members)
    sup = runner.RealtimeSupervisor(cfgs[0], agg, agg)
    return sims, members, [mb.stats for mb in members], agg, sup


def _run_fleet_tail(sims, members, stats, agg, sup, kept=None) -> bool:
    """The native tail of a fleet failed over with nothing in flight: 8-item
    probe windows, paced on the slowest live member (``run_fleet``'s
    count), its clock far behind so pacing never sleeps."""
    totals = [s.numd - 1 for s in sims]
    t0 = time.perf_counter() - 100.0
    return runner._native_tail(
        members, [], fleet._interleave_plans(sims), 8, None, sup, agg, t0,
        lambda: fleet._live_min_blocks(stats, totals),
        [].append if kept is None else kept.append)


def test_fleet_tail_keeps_flap_count(fixtures_dir, tmp_path, monkeypatch):
    """The native tail keeps the supervisor's block count current, so a
    failback records the real count and a failover soon after it is a
    flap that doubles the probe interval (the JAX package's tail leaves
    the count where the failover found it)."""
    cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (2.0, 2.0),
                       failback_probe_sec=0.2)
    sims, members, stats, agg, sup = _fleet_tail(cfgs)
    assert sup.check(T0, now=T0 + 10.0) == "failover"
    throttle = Throttle(monkeypatch)
    _instant_probe(monkeypatch, throttle)
    kept = []  # the tail's snapshots: None once the live state is written
    failed_back = _run_fleet_tail(sims, members, stats, agg, sup, kept)
    snap = kept[-1]
    assert failed_back and snap is None
    assert agg.failbacks == 1
    written = [st.blocks for st in stats]
    assert min(written) > 0 and agg.blocks == min(written)
    assert sup._last_failback_blocks == agg.blocks
    agg.blocks += 10
    assert sup.check(T0, now=T0 + 100.0) == "failover"
    assert sup.probe_backoff == 2


def test_fleet_tail_probe_window_counts_live_members(fixtures_dir, tmp_path,
                                                     monkeypatch):
    """The fleet's native tail hands each probe the signal time of the
    members in its window: 4 blocks while both members share it, then 8
    once the short member has finished (``W / len(cfgs)`` would give 4)."""
    cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (0.5, 2.0),
                       failback_probe_sec=0.2)
    sims, members, stats, agg, sup = _fleet_tail(cfgs)
    assert sup.check(T0, now=T0 + 10.0) == "failover"
    windows = []

    def start(self, plans, window_blocks=None):
        windows.append((len(plans), window_blocks))
        self._done = threading.Event()
        self._done.set()
        self._dt, self._err, self._thread = [0.0], [], None

    monkeypatch.setattr(runner.DeviceProbe, "start", start)
    failed_back = _run_fleet_tail(sims, members, stats, agg, sup)
    assert failed_back and stats[0].blocks == sims[0].numd - 1
    assert windows == [(8, 4.0), (8, 8.0)]


def test_fleet_probe_window_in_fleet_time(fixtures_dir, tmp_path):
    """Once a member has finished, a probe window's signal time counts the
    members actually in it: 8 blocks of the one live member are 0.8 s,
    not the 0.4 s that ``W / len(cfgs)`` gives."""
    cfgs = _fleet_cfgs(fixtures_dir, tmp_path, (0.5, 2.0))
    it = fleet._interleave_plans([Simulation(c) for c in cfgs])
    first = list(itertools.islice(it, 8))
    assert runner.probe_window_blocks(first) == 4.0
    rest = list(itertools.islice(it, 8))
    assert {m for m, _ in rest} == {1}
    window = runner.probe_window_blocks(rest)
    assert window == 8.0
    probe = runner.DeviceProbe(None, 8 / len(cfgs))
    probe.start = None  # scripted below
    for w, want in ((8 / len(cfgs), "slow"), (window, "confirm")):
        probe._window = w
        probe._done = threading.Event()
        probe._done.set()
        probe._dt, probe._err = [0.39], []
        assert probe.poll() == want


# ---------------------------------------------------------------------------
# Window shape, resume and the CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fifo_depth,dispatch_blocks,W", [
    (8, 25, 4), (2, 25, 1), (60, 6, 6),
])
def test_realtime_window_shape_equal_jax(fixtures_dir, tmp_path, monkeypatch,
                                         fifo_depth, dispatch_blocks, W):
    """Every paced window: W = min(dispatch_blocks, fifo_depth // 2)
    blocks on the full channel axis, key for key the JAX package's
    collate_plans(..., compact=False)."""
    windows = []
    real = targs.collate_plans

    def spy(plans, **kw):
        batch = real(plans, **kw)
        windows.append((list(plans), kw, batch))
        return batch

    monkeypatch.setattr(targs, "collate_plans", spy)
    # policy warn: the device path writes every window, however slow
    cfg = _cfg(fixtures_dir, tmp_path / "w.bin", duration_sec=1.0,
               fifo_depth=fifo_depth, dispatch_blocks=dispatch_blocks,
               realtime_policy="warn")
    assert runner.dispatch_window(cfg) == W
    stats = runner.run_simulation(cfg)
    assert stats.blocks == 9 and stats.failovers == 0
    assert len(windows) == -(-9 // W)
    for plans, kw, batch in windows:
        assert len(plans) == W and kw["compact"] is False
        want = jblocks.collate_plans(plans, int_nco=False, compact=False,
                                     compact_multiple=4).args
        assert sorted(want) == sorted(batch.args)
        for k, v in want.items():
            g = np.asarray(batch.args[k])
            assert g.shape[:2] in ((W, cfg.num_channels),
                                   (W, 4), (W, 3)), k
            assert g.dtype == np.asarray(v).dtype and np.array_equal(g, v), k
        assert batch.args["gain_a"].shape == (W, cfg.num_channels)


@pytest.mark.parametrize("kw, one, fleet1, fleet3", [
    ({}, 25, 25, 25),
    ({"dispatch_blocks": 2}, 2, 2, 3),  # a fleet: at least one full round
    ({"realtime": True}, 4, 4, 12),  # paced: half the FIFO per member
    # a paced fleet ignores dispatch_blocks below fifo_depth // 2
    ({"realtime": True, "dispatch_blocks": 2}, 2, 4, 12),
    ({"interactive": True, "dispatch_blocks": 3}, 3, None, None),
])
def test_dispatch_window_of_one_scenario_and_of_a_fleet(kw, one, fleet1,
                                                        fleet3):
    """One function gives each caller's window: a scenario's (a config)
    and a fleet's (a list of them), which differ where a paced fleet
    takes the FIFO bound whatever dispatch_blocks says; a fleet's explicit
    ``window`` wins."""
    cfg = SimConfig(nav_file="unused", fifo_depth=8, **kw)
    assert runner.dispatch_window(cfg) == one
    if fleet1 is not None:  # fleets refuse interactive members
        assert runner.dispatch_window([cfg]) == fleet1
        assert runner.dispatch_window([cfg] * 3) == fleet3
        assert runner.dispatch_window([cfg] * 3, window=7) == 7


def test_resume_jax_checkpoint_realtime(fixtures_dir, tmp_path):
    """A JAX-written checkpoint taken mid-run, loaded by the port and run
    paced, continues with the bytes of the JAX package's offline resume."""
    jcfg = JSimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                      almanac_enable=False, sample_rate=RATE,
                      duration_sec=2.0, backend=JSynthBackend.NUMPY,
                      sink="null")
    snaps = []
    jrunner.run_simulation(
        jcfg, on_block=lambda st, sim, plan: snaps.append(
            jcheckpoint.capture_state(sim)),
        stop=lambda: len(snaps) >= 7)
    ckpt = str(tmp_path / "state.npz")
    jcheckpoint.write_state(ckpt, snaps[-1])

    jcfg2, jsim = jcheckpoint.load_checkpoint(ckpt)
    jcfg2.sink, jcfg2.out_file = "iqfile", str(tmp_path / "jtail.bin")
    jrunner.run_simulation(jcfg2, sim=jsim)

    cfg, sim = checkpoint.load_checkpoint(ckpt)
    cfg.device, cfg.realtime, cfg.realtime_policy = "cpu", True, "warn"
    cfg.sink, cfg.out_file = "iqfile", str(tmp_path / "tail.bin")
    stats = runner.run_simulation(cfg, sim=sim)
    assert stats.blocks == 19 - 7 and stats.failovers == 0
    assert np.array_equal(_bytes(cfg.out_file), _bytes(jcfg2.out_file))


def test_cli_realtime_and_policy(fixtures_dir, tmp_path, tmp_path_factory,
                                 capsys):
    out = tmp_path / "cli.bin"
    argv = ["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "1",
            "--disable-almanac", "-r", "iqfile", "--sample-rate", str(RATE),
            "--device", "cpu", "--realtime", "--out-file", str(out),
            "-l", "35.681298,139.766247,10.0"]
    rc, stats = cli.run(argv + ["--realtime-policy", "warn"])
    assert rc == 0 and stats.blocks == 9 and stats.failovers == 0
    assert "realtime: 0 sink underruns, 0 failovers" in \
        capsys.readouterr().err
    assert np.array_equal(_bytes(out),
                          _offline(fixtures_dir, tmp_path_factory, 1.0))
    args = cli.build_parser().parse_args(argv)
    assert cli.args_to_config(args).realtime_policy == "failover"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv + ["--realtime-policy", "nope"])


def test_cli_realtime_fleet(fixtures_dir, tmp_path, tmp_path_factory):
    roster = tmp_path / "roster.csv"
    roster.write_text(f"35.681298,139.766247,10.0\n{NY[0]},{NY[1]},{NY[2]}\n")
    rc, stats = cli.run([
        "-e", f"{fixtures_dir}/brdc_test.22n", "-d", "1", "--disable-almanac",
        "-r", "iqfile", "--sample-rate", str(RATE), "--device", "cpu",
        "--realtime", "--fleet", str(roster), "--out-file",
        str(tmp_path / "f.bin")])
    assert rc == 0 and [st.blocks for st in stats] == [9, 9]
    for i, loc in enumerate((None, NY)):
        assert np.array_equal(_bytes(tmp_path / f"f_m{i}.bin"),
                              _offline(fixtures_dir, tmp_path_factory, 1.0,
                                       location=loc)), i


@pytest.mark.parametrize("sink,underruns,warned", [
    ("iqfile", 0, True), ("tcp", 0, False), ("tcp", 2, True),
])
def test_app_warns_when_behind(fixtures_dir, monkeypatch, capsys, sink,
                               underruns, warned):
    """The below-1x warning of a paced run: from the sink's underruns where
    it counts them, else from the realtime factor; it quotes no device
    rate."""
    class Sink(NullSink):
        pass

    if sink == "tcp":
        Sink.underruns = underruns
    monkeypatch.setattr(app, "_make_configured_sink", lambda cfg: Sink())
    monkeypatch.setattr(app, "run_simulation", lambda cfg, **kw:
                        runner.RunStats(blocks=10, wall_seconds=2.0,
                                        underruns=underruns))
    cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                    duration_sec=1.1, realtime=True, device="cpu")
    app.run_app(cfg)
    err = capsys.readouterr().err
    assert ("WARNING: output fell behind real time" in err) == warned
    assert "650" not in err and "device-side" not in err
