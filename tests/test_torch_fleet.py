"""Fleet mode of the PyTorch/CUDA package against its solo runs and the
JAX package's fleets.

Each member of a fleet must write the bytes of its scenario run alone
(the batch axis is pure stacking; the strict-parity corrections are
per-plan), and the bytes of the JAX package's ``run_fleet`` for the same
roster: with and without a mesh, at 8 and 16 bits, across a checkpoint
and resume, and through the CLI. Every comparison is ``np.array_equal``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpssim_tpu import cli as jcli
from gpssim_tpu import fleet as jfleet
from gpssim_tpu.config import LocationConfig as JLocationConfig
from gpssim_tpu.config import SampleFormat as JSampleFormat
from gpssim_tpu.config import SimConfig as JSimConfig
from gpssim_tpu.config import SynthBackend as JSynthBackend
from gpssim_tpu.io.sinks import NullSink as JNullSink
from gpssim_tpu_torch import cli, fleet, trace
from gpssim_tpu_torch.checkpoint import load_fleet_checkpoint
from gpssim_tpu_torch.config import (
    LocationConfig, SampleFormat, SimConfig, SynthBackend,
)
from gpssim_tpu_torch.io.sinks import NullSink
from gpssim_tpu_torch.ops.synth_seq import seq_available
from gpssim_tpu_torch.parallel.shard import make_mesh
from gpssim_tpu_torch.runner import run_simulation

NY = (40.7128, -74.0060, 20.0)
PARIS = (48.8584, 2.2945, 35.0)
_SOLO: dict = {}


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


class Capture:
    """Keeps every block written (mixed into either package's NullSink)."""

    def __init__(self):
        super().__init__()
        self.data = []

    def write(self, block):
        super().write(block)
        self.data.append(np.array(block))


class CaptureSink(Capture, NullSink):
    pass


class JCaptureSink(Capture, JNullSink):
    pass


def _roster(fixtures_dir, pkg_cfg, loc_cls, **kw):
    """The three members of tests/test_fleet.py: two static locations and
    one dynamic circle, with unequal durations (member 1 ends two rounds
    early)."""
    base = dict(nav_file=f"{fixtures_dir}/brdc_test.22n",
                almanac_enable=False, **kw)
    return [
        pkg_cfg(**base, duration_sec=1.2),
        pkg_cfg(**base, duration_sec=0.9, location=loc_cls(*NY)),
        pkg_cfg(**base, duration_sec=1.2,
                motion_file=f"{fixtures_dir}/circle_motion.csv"),
    ]


def _port_cfgs(fixtures_dir, **kw):
    return _roster(fixtures_dir, SimConfig, LocationConfig,
                   backend=SynthBackend.CUDA, device="cpu", **kw)


def _jax_cfgs(fixtures_dir, **kw):
    return _roster(fixtures_dir, JSimConfig, JLocationConfig,
                   backend=JSynthBackend.JAX, **kw)


def _solo(fixtures_dir):
    """Each member of the roster run alone by the port (once)."""
    if "roster" not in _SOLO:
        out = []
        for cfg in _port_cfgs(fixtures_dir):
            sink = CaptureSink()
            run_simulation(cfg, sink=sink)
            out.append(sink.data)
        _SOLO["roster"] = out
    return _SOLO["roster"]


def _equal(got_members, want_members):
    assert len(got_members) == len(want_members)
    for got, want in zip(got_members, want_members):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert np.array_equal(g, w)


def test_fleet_members_equal_solo_and_jax(fixtures_dir):
    cfgs = _port_cfgs(fixtures_dir)
    sinks = [CaptureSink() for _ in cfgs]
    stats = fleet.run_fleet(cfgs, sinks=sinks, window=6)
    assert [st.blocks for st in stats] == [11, 8, 11]
    assert stats[0].retries == 0
    _equal([s.data for s in sinks], _solo(fixtures_dir))

    jsinks = [JCaptureSink() for _ in cfgs]
    jfleet.run_fleet(_jax_cfgs(fixtures_dir), sinks=jsinks, window=6)
    _equal([s.data for s in sinks], [s.data for s in jsinks])


def test_fleet_16bit_strict_parity(fixtures_dir):
    def members(cfg_cls, loc_cls, **kw):
        base = dict(nav_file=f"{fixtures_dir}/brdc_test.22n",
                    almanac_enable=False, duration_sec=0.6, **kw)
        return [cfg_cls(**base), cfg_cls(**base, location=loc_cls(*PARIS))]

    cfgs = members(SimConfig, LocationConfig, backend=SynthBackend.CUDA,
                   device="cpu", sample_format=SampleFormat.SC16)
    sinks = [CaptureSink() for _ in cfgs]
    fleet.run_fleet(cfgs, sinks=sinks, window=4)
    solo = []
    for cfg in cfgs:
        s = CaptureSink()
        run_simulation(cfg, sink=s)
        solo.append(s.data)
    _equal([s.data for s in sinks], solo)
    assert sinks[0].data[0].dtype == np.int16

    jsinks = [JCaptureSink() for _ in cfgs]
    jfleet.run_fleet(
        members(JSimConfig, JLocationConfig, backend=JSynthBackend.JAX,
                sample_format=JSampleFormat.SC16),
        sinks=jsinks, window=4)
    _equal([s.data for s in sinks], [s.data for s in jsinks])


def test_fleet_over_cpu_mesh(fixtures_dir):
    """Fleet batches over a (4, 2) mesh of the CPU device: blocks split
    four ways, channels two ways and summed, the bytes unchanged."""
    cfgs = _port_cfgs(fixtures_dir)
    sinks = [CaptureSink() for _ in cfgs]
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    fleet.run_fleet(cfgs, sinks=sinks, window=6, mesh=mesh)
    _equal([s.data for s in sinks], _solo(fixtures_dir))


def test_mesh_kernel_follows_backend_and_fuse_a(fixtures_dir, monkeypatch):
    cfg = _port_cfgs(fixtures_dir)[0]
    monkeypatch.delenv("GPSSIM_FUSE_A", raising=False)
    assert fleet.mesh_kernel(cfg) == "cuda-fused"
    monkeypatch.setenv("GPSSIM_FUSE_A", "0")
    assert fleet.mesh_kernel(cfg) == "cuda"
    assert fleet.mesh_kernel(
        dataclasses.replace(cfg, backend=SynthBackend.TORCH)) == "torch"


def test_fleet_checkpoint_and_cli_resume(fixtures_dir, tmp_path):
    """Stop after the first drained batch: the fleet checkpoint holds the
    state of the blocks written, and ``--resume`` of it continues every
    member byte-identically."""
    ckpt = str(tmp_path / "fleet.npz")
    cfgs = [dataclasses.replace(c, out_file=str(tmp_path / f"m{i}.bin"),
                                checkpoint_file=ckpt)
            for i, c in enumerate(_port_cfgs(fixtures_dir))]
    drained = []
    stats = fleet.run_fleet(cfgs, window=6,
                            on_batch=lambda st: drained.append(1),
                            stop=lambda: len(drained) >= 1)
    assert [st.blocks for st in stats] == [2, 2, 2]
    _, _, blocks = load_fleet_checkpoint(ckpt)
    assert list(blocks) == [2, 2, 2]  # the blocks written, per member
    heads = []
    for c in cfgs:
        heads.append(np.fromfile(c.out_file, dtype=np.int8))
        os.remove(c.out_file)

    rc, tail_stats = cli.run(["--resume", ckpt, "--device", "cpu"])
    assert rc == 0
    assert [st.blocks for st in tail_stats] == [9, 6, 9]
    for c, head, want in zip(cfgs, heads, _solo(fixtures_dir)):
        tail = np.fromfile(c.out_file, dtype=np.int8)
        assert np.array_equal(np.concatenate([head, tail]),
                              np.concatenate(want))


def test_cli_fleet_equal_jax_cli(fixtures_dir, tmp_path, capsys):
    """``--fleet`` on the CPU writes the member files of the JAX
    package's ``--fleet --backend jax``."""
    roster = tmp_path / "roster.csv"
    roster.write_text(
        "# lat,lon,height[,out_file]\n"
        "35.681298,139.766247,10\n"
        f"{NY[0]},{NY[1]},{NY[2]}\n"
        f"{PARIS[0]},{PARIS[1]},{PARIS[2]},"
        f"{tmp_path / 'paris_port.bin'}\n"
    )
    common = ["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "0.5",
              "--disable-almanac", "-r", "iqfile", "--fleet", str(roster)]
    rc, stats = cli.run(common + ["--device", "cpu", "--out-file",
                                  str(tmp_path / "port.bin")])
    assert rc == 0 and [st.blocks for st in stats] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "fleet member 2: 0.4 s of signal" in out
    assert "fleet aggregate" in out
    port = [tmp_path / "port_m0.bin", tmp_path / "port_m1.bin",
            tmp_path / "paris_port.bin"]

    roster.write_text(roster.read_text().replace("paris_port", "paris_jax"))
    assert jcli.main(common + ["--backend", "jax", "--out-file",
                               str(tmp_path / "jax.bin")]) == 0
    jax = [tmp_path / "jax_m0.bin", tmp_path / "jax_m1.bin",
           tmp_path / "paris_jax.bin"]
    for p, j in zip(port, jax):
        got = np.fromfile(p, dtype=np.int8)
        assert got.size == 4 * 2 * 300_000
        assert np.array_equal(got, np.fromfile(j, dtype=np.int8))


def test_cli_fleet_refusals(fixtures_dir, tmp_path):
    base = ["-e", f"{fixtures_dir}/brdc_test.22n", "-d", "0.3",
            "--device", "cpu", "-r", "iqfile", "--fleet", "roster.csv"]
    for extra in (["--resume", "x.npz"], ["--metrics-file", "m.jsonl"],
                  ["--profile-dir", "p"]):
        with pytest.raises(SystemExit):
            cli.run(base + extra)
    bad = tmp_path / "bad.csv"
    bad.write_text("1.0, x, 3.0\n")
    with pytest.raises(SystemExit):
        cli.run(base[:-1] + [str(bad)])


def test_member_configs_equal_jax(fixtures_dir, tmp_path):
    roster = tmp_path / "r.csv"
    roster.write_text("# comment\n1.0, 2.0, 3.0\n\n4.0, 5.0, 6.0, custom.bin\n")
    rows = fleet.parse_fleet_file(str(roster))
    jrows = jfleet.parse_fleet_file(str(roster))
    assert [(dataclasses.asdict(loc), out) for loc, out in rows] == \
        [(dataclasses.asdict(loc), out) for loc, out in jrows]
    kw = dict(nav_file=f"{fixtures_dir}/brdc_test.22n", out_file="fleet.bin",
              noise_std_lsb=2.0, noise_seed=40)
    for extra in ({}, {"sink": "tcp", "tcp_addr": "127.0.0.1:5000"},
                  {"sink": "null"}):
        cfgs = fleet.member_configs(SimConfig(**kw, **extra), rows)
        jcfgs = jfleet.member_configs(JSimConfig(**kw, **extra), jrows)
        for c, j in zip(cfgs, jcfgs):
            for f in ("out_file", "tcp_addr", "noise_seed", "noise_std_lsb",
                      "sink", "duration_sec"):
                assert getattr(c, f) == getattr(j, f), f
            assert dataclasses.asdict(c.location) == \
                dataclasses.asdict(j.location)
    for bad, match in (({"sink": "tcp", "tcp_addr": "badaddr"}, "host:port"),
                       ({"sink": "hackrf"}, "iqfile, null, and tcp")):
        with pytest.raises(ValueError, match=match):
            fleet.member_configs(SimConfig(**kw, **bad), rows)
    for text, match in (("1.0, x, 3.0\n", "non-numeric"),
                        ("1.0, 2.0\n", "expected lat,lon,height"),
                        ("# nothing\n", "no fleet members")):
        path = tmp_path / "bad.csv"
        path.write_text(text)
        with pytest.raises(ValueError, match=match):
            fleet.parse_fleet_file(str(path))


def test_fleet_refusals(fixtures_dir, tmp_path):
    def cfg(**kw):
        kw.setdefault("backend", SynthBackend.CUDA)
        kw.setdefault("device", "cpu")
        return SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                         almanac_enable=False, duration_sec=0.3, **kw)

    other = dict(location=LocationConfig(1.0, 2.0, 3.0),
                 out_file=str(tmp_path / "b.bin"))
    with pytest.raises(ValueError, match="sample_format"):
        fleet.run_fleet([cfg(), cfg(sample_format=SampleFormat.SC16,
                                    **other)])
    with pytest.raises(ValueError, match="device"):
        fleet.run_fleet([cfg(), cfg(device="cuda", **other)])
    with pytest.raises(ValueError, match="cuda or torch"):
        fleet.run_fleet([cfg(backend=SynthBackend.NUMPY)])
    with pytest.raises(ValueError, match="share the same iqfile target"):
        fleet.run_fleet([cfg(), cfg(location=other["location"])])
    with pytest.raises(ValueError, match="interactive"):
        fleet.run_fleet([cfg(interactive=True)])
    with pytest.raises(ValueError, match="realtime"):
        fleet.run_fleet([cfg(realtime=True), cfg(**other)])
    with pytest.raises(ValueError, match="checkpoint_file"):
        fleet.run_fleet([cfg(checkpoint_file="x.npz"), cfg(**other)])
    with pytest.raises(ValueError, match="noise_seed"):
        fleet.run_fleet([cfg(noise_std_lsb=1.0),
                         cfg(noise_std_lsb=1.0, **other)])
    with pytest.raises(ValueError, match="metrics_file"):
        fleet.run_fleet([cfg(metrics_file="m.jsonl")])
    with pytest.raises(ValueError, match="at least one"):
        fleet.run_fleet([])
    assert not (tmp_path / "b.bin").exists()


@pytest.mark.parametrize("parity_exact", [False, True],
                         ids=["closed_form", "strict"])
def test_one_scenario_alone_and_as_a_fleet_of_one(fixtures_dir,
                                                  parity_exact):
    """``run_simulation`` and ``run_fleet([cfg])`` run the one window
    pipeline: the same bytes, counters and (stage, window) spans, but for
    the snapshot that only the single scenario takes."""
    cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                    almanac_enable=False, duration_sec=0.8,
                    backend=SynthBackend.CUDA,
                    device="cpu", dispatch_blocks=4,
                    parity_exact=parity_exact)
    runs = []
    for alone in (True, False):
        sink = CaptureSink()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if alone:
                st = run_simulation(cfg, sink=sink,
                                    on_block=lambda *a: None)
            else:
                [st] = fleet.run_fleet([cfg], sinks=[sink],
                                       on_batch=lambda s: None)
        spans = sorted(
            (int(k), stage) for stage, _, k in (
                e.name[len(trace.PREFIX):].partition("#")
                for e in prof.events() if e.name.startswith(trace.PREFIX))
            if stage != "snapshot")
        runs.append((sink.data, st, spans))
    (alone, sa, spans_a), (member, sb, spans_b) = runs
    _equal([member], [alone])
    for name in ("blocks", "samples", "gain_folds", "correct_candidates",
                 "correct_samples", "correct_blocks"):
        assert getattr(sb, name) == getattr(sa, name), name
    assert sa.blocks == 7 and (sa.correct_candidates > 0) == parity_exact
    assert spans_b == spans_a
    assert {s for _, s in spans_a} == (
        {"plan", "collate", "pack", "launch", "wait", "sink", "hook"}
        | ({"correct"} if parity_exact else set()))
