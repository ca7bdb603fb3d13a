"""Interactive runs of the PyTorch/CUDA package against the JAX package.

Live position edits (``Simulation.set_motion``, what the TUI's keys call)
are keyed here to planned block indices by a ``Simulation`` subclass in
each package — never to wall time or to ``on_block`` — so the bytes do not
depend on how far the planner runs ahead. With the same edits, the port's
runs (``cuda`` and ``torch`` on the CPU, realtime off and on, and its host
backends) write the JAX package's bytes, with no tolerance; so does a run
resumed from a checkpoint taken mid-run, of either package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpssim_tpu import checkpoint as jcheckpoint
from gpssim_tpu import cli as jcli
from gpssim_tpu import runner as jrunner
from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.config import SynthBackend as JSynthBackend
from gpssim_tpu.parallel import blocks as jblocks
from gpssim_tpu.scenario import Simulation as JSimulation
from gpssim_tpu_torch import checkpoint, cli, runner
from gpssim_tpu_torch.config import SimConfig, SynthBackend
from gpssim_tpu_torch.ops import args as targs
from gpssim_tpu_torch.scenario import Simulation

RATE = 1_030_000  # the lowest rate: the least CPU per paced second
BLOCK = 2 * RATE // 10  # bytes of one 8-bit block
SECONDS = 2.0  # 19 blocks
#: planned block index (``Simulation._iumd``, from 1) -> set_motion kwargs
EDITS = {
    3: dict(bearing_deg=90.0, velocity=40.0),
    6: dict(vertical_speed=5.0),
    10: dict(velocity=150.0, bearing_deg=200.0),
    15: dict(vertical_speed=-3.0, velocity=20.0),
}
_REFS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keyed(sim, edits: dict):
    """Turn ``sim`` (either package's Simulation) into one that applies
    ``edits[i]`` just before it plans block ``i``."""
    base = type(sim)

    class Keyed(base):
        def step(self):
            kw = self.edits.get(self._iumd)
            if kw:
                self.set_motion(**kw)
            return base.step(self)

    sim.__class__ = Keyed
    sim.edits = dict(edits)
    return sim


def _kw(fixtures_dir, out_file, **kw):
    kw.setdefault("duration_sec", SECONDS)
    return dict(nav_file=f"{fixtures_dir}/brdc_test.22n",
                almanac_enable=False, sample_rate=RATE, interactive=True,
                out_file=str(out_file), **kw)


def _bytes(path) -> np.ndarray:
    return np.fromfile(path, dtype=np.int8)


def jax_bytes(fixtures_dir, tmp_path_factory, backend=JSynthBackend.NUMPY,
              **kw) -> np.ndarray:
    """The JAX package's interactive run with EDITS (run once each)."""
    key = (backend, tuple(sorted(kw.items())))
    if key not in _REFS:
        out = tmp_path_factory.mktemp("jref") / "ref.bin"
        cfg = JSimConfig(**_kw(fixtures_dir, out, backend=backend, **kw))
        jrunner.run_simulation(cfg, sim=keyed(JSimulation(cfg), EDITS))
        _REFS[key] = _bytes(out)
    return _REFS[key]


def port_run(fixtures_dir, out, edits=EDITS, **kw):
    kw.setdefault("backend", SynthBackend.CUDA)
    kw.setdefault("device", "cpu")
    cfg = SimConfig(**_kw(fixtures_dir, out, **kw))
    return runner.run_simulation(cfg, sim=keyed(Simulation(cfg), edits))


def test_edits_change_the_stream(fixtures_dir, tmp_path, tmp_path_factory):
    """The edits are seen: without them the bytes differ from the first
    block planned after the first edit on."""
    want = jax_bytes(fixtures_dir, tmp_path_factory)
    port_run(fixtures_dir, tmp_path / "none.bin", edits={})
    got = _bytes(tmp_path / "none.bin")
    assert got.size == want.size == 19 * BLOCK
    first = min(EDITS) - 1  # blocks written before the first edit
    assert np.array_equal(got[:first * BLOCK], want[:first * BLOCK])
    assert not np.array_equal(got[first * BLOCK:(first + 1) * BLOCK],
                              want[first * BLOCK:(first + 1) * BLOCK])


@pytest.mark.parametrize("backend", [SynthBackend.CUDA, SynthBackend.TORCH])
@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "paced"])
def test_interactive_equal_jax(fixtures_dir, tmp_path, tmp_path_factory,
                               backend, realtime):
    """cuda and torch on the CPU, paced and not: the JAX package's bytes
    with the same edits. A paced run keeps the supervisor on; a failover
    on a loaded machine writes the same bytes, so none is required."""
    want = jax_bytes(fixtures_dir, tmp_path_factory)
    stats = port_run(fixtures_dir, tmp_path / "i.bin", backend=backend,
                     realtime=realtime)
    assert stats.blocks == 19
    assert np.array_equal(_bytes(tmp_path / "i.bin"), want)


@pytest.mark.parametrize("backend", [SynthBackend.NUMPY, SynthBackend.NATIVE])
def test_interactive_host_backends_equal_jax(fixtures_dir, tmp_path,
                                             tmp_path_factory, backend):
    """The host loop runs interactive scenarios block by block."""
    want = jax_bytes(fixtures_dir, tmp_path_factory)
    port_run(fixtures_dir, tmp_path / "h.bin", backend=backend)
    assert np.array_equal(_bytes(tmp_path / "h.bin"), want)


def test_interactive_equal_jax_backend(fixtures_dir, tmp_path,
                                       tmp_path_factory):
    """A short case against the JAX package's ``--backend jax`` (its
    batched XLA path at the interactive window of 4 blocks)."""
    want = jax_bytes(fixtures_dir, tmp_path_factory,
                     backend=JSynthBackend.JAX, duration_sec=1.2)
    port_run(fixtures_dir, tmp_path / "j.bin", duration_sec=1.2)
    got = _bytes(tmp_path / "j.bin")
    assert got.size == 11 * BLOCK and np.array_equal(got, want)


def test_interactive_window_shape_equal_jax(fixtures_dir, tmp_path,
                                            monkeypatch):
    """An interactive run that is not paced launches windows of
    ``fifo_depth // 2`` = 4 blocks on the full channel axis, key for key
    the JAX package's ``collate_plans(..., compact=False)``."""
    windows = []
    real = targs.collate_plans

    def spy(plans, **kw):
        batch = real(plans, **kw)
        windows.append((list(plans), kw, batch))
        return batch

    monkeypatch.setattr(targs, "collate_plans", spy)
    cfg = SimConfig(**_kw(fixtures_dir, tmp_path / "w.bin", duration_sec=1.0,
                          backend=SynthBackend.CUDA, device="cpu"))
    assert not cfg.realtime and runner.dispatch_window(cfg) == 4
    stats = runner.run_simulation(cfg, sim=keyed(Simulation(cfg), EDITS))
    assert stats.blocks == 9 and len(windows) == 3
    for plans, kw, batch in windows:
        assert len(plans) == 4 and kw["compact"] is False
        want = jblocks.collate_plans(plans, int_nco=False, compact=False,
                                     compact_multiple=4).args
        assert sorted(want) == sorted(batch.args)
        for k, v in want.items():
            g = np.asarray(batch.args[k])
            assert g.dtype == np.asarray(v).dtype and np.array_equal(g, v), k
        assert batch.args["gain_a"].shape == (4, cfg.num_channels)


def _tail(path, snap) -> np.ndarray:
    """The bytes a run resumed from ``snap`` should write: those after
    the blocks the snapshot had written (its cursor starts at 1)."""
    return _bytes(path)[(int(snap["iumd"]) - 1) * BLOCK:]


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "paced"])
def test_checkpoint_mid_run_resumes_with_remaining_edits(
        fixtures_dir, tmp_path, tmp_path_factory, realtime):
    """A checkpoint taken mid-run — the runner's drain-time snapshot, as
    the app's hook writes it — holds the position and interactive state of
    the last written block, not of the window planned ahead (an edit lands
    inside that window here). Resumed with the remaining edits, it writes
    the rest of the uninterrupted run's bytes. (Policy warn: a failover
    on a loaded machine would move the snapshot to the native tail.)"""
    want = jax_bytes(fixtures_dir, tmp_path_factory)
    snaps = []

    def hook(stats, sim, plan):
        if stats.blocks == 8:  # the second window drained; the third
            # (blocks 9-12, with the edit at 10) is planned
            assert sim._iumd == 13
            snaps.append(sim.consistent_snapshot)

    cfg = SimConfig(**_kw(fixtures_dir, tmp_path / "full.bin",
                          backend=SynthBackend.CUDA, device="cpu",
                          realtime=realtime, realtime_policy="warn"))
    runner.run_simulation(cfg, sim=keyed(Simulation(cfg), EDITS),
                          on_block=hook)
    assert np.array_equal(_bytes(cfg.out_file), want)
    (snap,) = snaps
    assert int(snap["iumd"]) == 9
    path = str(tmp_path / "state.npz")
    checkpoint.write_state(path, snap)

    rcfg, sim = checkpoint.load_checkpoint(path)
    assert rcfg.interactive
    rcfg.device, rcfg.out_file = "cpu", str(tmp_path / "tail.bin")
    stats = runner.run_simulation(rcfg, sim=keyed(sim, EDITS))
    assert stats.blocks == 19 - 8
    assert np.array_equal(_bytes(rcfg.out_file), _tail(cfg.out_file, snap))


def test_resume_jax_interactive_checkpoint(fixtures_dir, tmp_path,
                                           tmp_path_factory):
    """A checkpoint the JAX package wrote mid-way through an interactive
    run resumes in the port, with the remaining edits, to the rest of the
    JAX run's bytes."""
    want_path = tmp_path / "jfull.bin"
    want_path.write_bytes(jax_bytes(fixtures_dir, tmp_path_factory).tobytes())
    jcfg = JSimConfig(**_kw(fixtures_dir, tmp_path / "j.bin",
                            backend=JSynthBackend.NUMPY))
    snaps = []
    jrunner.run_simulation(
        jcfg, sim=keyed(JSimulation(jcfg), EDITS),
        on_block=lambda st, sim, plan: snaps.append(
            jcheckpoint.capture_state(sim)),
        stop=lambda: len(snaps) >= 7)
    path = str(tmp_path / "jstate.npz")
    jcheckpoint.write_state(path, snaps[-1])

    cfg, sim = checkpoint.load_checkpoint(path)
    assert cfg.interactive
    cfg.backend, cfg.device = SynthBackend.CUDA, "cpu"
    cfg.out_file = str(tmp_path / "tail.bin")
    runner.run_simulation(cfg, sim=keyed(sim, EDITS))
    assert np.array_equal(_bytes(cfg.out_file),
                          _tail(want_path, snaps[-1]))


@pytest.mark.parametrize("flag", ["-i", "--tui"])
def test_fleet_refuses_interactive(fixtures_dir, tmp_path, flag, capsys):
    """``--fleet`` with ``-i`` or ``--tui`` is refused, as in the JAX
    package, before anything is written."""
    roster = tmp_path / "roster.csv"
    roster.write_text("35.681298,139.766247,10\n40.7128,-74.0060,20\n")
    argv = ["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "0.3",
            "--disable-almanac", "-r", "iqfile", "--fleet", str(roster),
            "--out-file", str(tmp_path / "f.bin"), flag]
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jcli.main, ["--backend", "numpy"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 2
        assert "--interactive/--tui" in capsys.readouterr().err
    assert not list(tmp_path.glob("f_m*.bin"))


def test_motion_file_clears_interactive(fixtures_dir):
    """A motion file overrides ``-i`` (gps-sim.c:63-68), in both
    packages; the gain, amplifier, Pluto and download flags map onto the
    config as the JAX package maps them."""
    argv = ["-e", f"{fixtures_dir}/brdc_test.22n", "-i", "-r", "iqfile"]
    extra = ["-g", "12", "-a", "-U", "ip:192.0.2.1", "-N", "pluto.example",
             "--station", "zimm", "-f"]
    for with_motion in (False, True):
        motion = ["-m", f"{fixtures_dir}/circle_motion.csv"] * with_motion
        got = cli.args_to_config(cli.build_parser().parse_args(
            argv + extra + motion))
        want = jcli.args_to_config(jcli.build_parser().parse_args(
            argv + extra + motion))
        assert got.interactive is want.interactive is (not with_motion)
        for f in ("tx_gain", "tx_amplifier", "use_ftp", "station_id",
                  "pluto_uri", "pluto_hostname", "motion_file"):
            assert getattr(got, f) == getattr(want, f), f
    for radio, bits, boost in (("hackrf", 8, False), ("plutosdr", 16, True)):
        a = argv[:-1] + [radio]
        got = cli.args_to_config(cli.build_parser().parse_args(a))
        want = jcli.args_to_config(jcli.build_parser().parse_args(a))
        assert got.sample_format.value == want.sample_format.value == bits
        assert got.pluto_gain_boost is want.pluto_gain_boost is boost


def test_run_app_headless_without_tty(fixtures_dir, tmp_path,
                                      tmp_path_factory, capsys):
    """``-i`` asks for the TUI; with stdout not a terminal the app runs
    headless and returns the run's stats, with no edits the bytes of a
    non-interactive run."""
    out = tmp_path / "app.bin"
    rc, stats = cli.run(["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "1",
                         "-l", "35.681298,139.766247,10.0",
                         "--disable-almanac", "-r", "iqfile", "-i",
                         "--sample-rate", str(RATE), "--device", "cpu",
                         "--out-file", str(out)])
    assert rc == 0 and stats.blocks == 9
    assert "done: 9 blocks" in capsys.readouterr().err
    ref = tmp_path / "ref.bin"
    runner.run_simulation(dataclasses.replace(
        SimConfig(**_kw(fixtures_dir, ref, duration_sec=1.0)),
        interactive=False, backend=SynthBackend.NATIVE))
    assert np.array_equal(_bytes(out), _bytes(ref))


#: blocks written when a key arrives (it is sent from inside the sink's
#: write of that block): the first, a middle and the last block of the
#: windows the runner drains
KEYS_AT = (0, 2, 3, 4, 7, 8, 11)


def key_latencies(sim, run) -> list:
    """``run(sink, sim)`` with a key (``set_motion``) sent from inside the
    sink's write of each block in KEYS_AT, on either package's
    Simulation; returns each key's latency in blocks: the planned index
    at which it lands minus the blocks written when it was sent."""
    base = type(sim)
    sent, latencies = [], []

    class Keyed(base):
        def step(self):
            latencies.extend(self._iumd - 1 - w for w in sent)
            sent.clear()
            return base.step(self)

    class KeySink:
        written = 0

        def init(self, cfg):
            pass

        def write(self, blk):
            if self.written in KEYS_AT:
                sim.set_motion(velocity=10.0 + self.written)
                sent.append(self.written)
            self.written += 1

        def close(self):
            pass

    sim.__class__ = Keyed
    run(KeySink(), sim)
    return latencies


def test_key_to_stream_latency_equals_jax_structure(fixtures_dir, tmp_path):
    """Two windows of ``dispatch_window`` = W blocks are in flight, so a
    key sent while window i-1 drains (window i already planned) lands at
    the first block of window i+1: 2W - w % W blocks after the written
    stream. The worst case, 2W = ``fifo_depth`` = 8, is a key sent as the
    first block of a window is written. The JAX package's runner lands
    the same keys at the same blocks."""
    cfg = SimConfig(**_kw(fixtures_dir, tmp_path / "p.bin",
                          backend=SynthBackend.CUDA, device="cpu"))
    W = runner.dispatch_window(cfg)
    port = key_latencies(Simulation(cfg), lambda sink, sim:
                         runner.run_simulation(cfg, sink=sink, sim=sim))
    jcfg = JSimConfig(**_kw(fixtures_dir, tmp_path / "j.bin",
                            backend=JSynthBackend.JAX))
    jax = key_latencies(JSimulation(jcfg), lambda sink, sim:
                        jrunner.run_simulation(jcfg, sink=sink, sim=sim))
    assert port == jax == [2 * W - w % W for w in KEYS_AT]
    assert max(port) == 2 * W == cfg.fifo_depth == 8
