"""The port's own measurement: the pipeline's spans and the native FIFO's
counters.

Spans (``gpssim_tpu_torch.trace``): with no profiler no span site enters
a profiler range; under ``torch.profiler`` every stage of every window
of a CPU run (``run_simulation`` and ``run_fleet``, offline and paced) is
a ``gpssim.<stage>#<window>`` range, and the plain kernel's aten ops lie
inside their window's ``gpssim.launch`` on the profiler's timeline.
Counters (``io/native``, ``io/fifo.cc``): the port's own native FIFO
counts what it was handed and sent, the Python FIFO has none, and the
shared host runtime of ``native/`` keeps the symbols it had.
"""

import dataclasses
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from gpssim_tpu_torch import fleet, runner, trace
from gpssim_tpu_torch.config import LocationConfig, SimConfig, SynthBackend
from gpssim_tpu_torch.io import native
from gpssim_tpu_torch.io.sinks import IqFileSink, TcpSink
from gpssim_tpu_torch.ops import synth_torch

RATE = 1_030_000  # the lowest rate: the least CPU per block
OFFLINE = {"plan", "collate", "pack", "launch", "snapshot", "wait",
           "correct", "sink", "hook"}
PACED = OFFLINE - {"correct"} | {"pace"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    intra-op threads would oversubscribe the cores and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(fixtures_dir, tmp_path, **kw):
    """A 1.2 s scenario on the CPU (the kernel's plain version), windows
    of 4 blocks; paced runs only warn on a deficit, so the device path
    (and its spans) carries the whole run."""
    kw.setdefault("duration_sec", 1.2)
    return SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                     almanac_enable=False, sample_rate=RATE,
                     backend=SynthBackend.TORCH, device="cpu",
                     dispatch_blocks=4, realtime_policy="warn",
                     out_file=os.devnull, **kw)


def _run(kind, fixtures_dir, tmp_path, hook=lambda *a: None):
    """Run ``kind`` (single or fleet, offline or paced); returns the
    number of windows written."""
    paced = kind.endswith("paced")
    parity = {"parity_exact": False} if paced else {}
    if kind.startswith("single"):
        cfg = _cfg(fixtures_dir, tmp_path, realtime=paced, **parity)
        stats = runner.run_simulation(cfg, on_block=hook)
        return -(-stats.blocks // runner.dispatch_window(cfg))
    base = _cfg(fixtures_dir, tmp_path, realtime=paced,
                checkpoint_file=str(tmp_path / "fleet.npz"), **parity)
    cfgs = [base, dataclasses.replace(
        base, location=LocationConfig(40.7128, -74.0060, 20.0))]
    sinks = [IqFileSink(os.devnull) for _ in cfgs]
    stats = fleet.run_fleet(cfgs, sinks=sinks, on_batch=hook)
    width = 2 * (base.fifo_depth // 2) if paced else 4
    return -(-sum(st.blocks for st in stats) // width)


def _parse(event_name: str) -> tuple[str, int] | None:
    """(stage, window) of a span's name, e.g. ``("launch", 12)`` for
    ``gpssim.launch#12``; None for any other event."""
    if not event_name.startswith(trace.PREFIX):
        return None
    stage, sep, window = event_name[len(trace.PREFIX):].partition("#")
    if not sep or not window.isdigit():
        return None
    return stage, int(window)


def _spans(prof) -> dict:
    """window -> {stage: (start_us, end_us)} of the run's spans."""
    out: dict = {}
    for e in prof.events():
        parsed = _parse(e.name)
        if parsed is not None:
            stage, k = parsed
            assert stage not in out.setdefault(k, {}), (stage, k)
            out[k][stage] = (e.time_range.start, e.time_range.end)
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("plan", 0) is trace.span("sink", 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rf = trace.span("launch", 3)
        assert isinstance(rf, trace._Range)
        with rf:
            pass
    [e] = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "gpssim.launch#3"]
    # an operator, not a user annotation: no gpu_user_annotation on a card
    assert not e.is_user_annotation()


@pytest.mark.parametrize("name, parsed", [
    ("gpssim.launch#12", ("launch", 12)),
    ("gpssim.sink#0", ("sink", 0)),
    ("gpssim.launch", None),
    ("aten::add", None),
    ("gpssim.plan#x", None),
])
def test_parse_span_names(name, parsed):
    assert _parse(name) == parsed
    if parsed is not None:  # the name a span of that stage and window has
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span(*parsed):
                pass
        assert [e.name for e in prof.events()] == [name]


@pytest.mark.parametrize("kind", ["single", "fleet"])
def test_no_record_function_without_a_profiler(kind, fixtures_dir, tmp_path,
                                               monkeypatch):
    entered = []

    def counting(real):
        def enter(*a, **kw):
            entered.append(a)
            return real(*a, **kw)

        return enter

    monkeypatch.setattr(trace, "_Range", counting(trace._Range))
    monkeypatch.setattr(autograd_profiler, "record_function",
                        counting(autograd_profiler.record_function))
    assert _run(kind, fixtures_dir, tmp_path) > 1
    assert entered == []


@pytest.mark.parametrize("kind, stages", [
    ("single", OFFLINE), ("fleet", OFFLINE),
    ("single-paced", PACED), ("fleet-paced", PACED),
])
def test_every_stage_of_every_window_is_spanned(kind, stages, fixtures_dir,
                                                tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        windows = _run(kind, fixtures_dir, tmp_path)
    spans = _spans(prof)
    assert windows > 1
    # each written window has every stage; the last number plans nothing
    assert sorted(spans) == list(range(windows + 1))
    for k in range(windows):
        want = stages
        if kind == "fleet-paced" and k == windows - 1:
            # a fleet paces only while a member has blocks left to write
            want = stages - {"pace"}
        assert set(spans[k]) == want, k
    assert set(spans[windows]) == {"plan"}
    for k in range(windows):
        s = spans[k]
        # within a window: plan, collate, pack, launch, snapshot in turn;
        # its drain (wait, ..., sink, hook) after its launch
        order = ["plan", "collate", "pack", "launch", "snapshot"]
        for a, b in zip(order, order[1:]):
            assert s[a][1] <= s[b][0], (k, a, b)
        assert s["launch"][1] <= s["wait"][0] <= s["sink"][0] \
            <= s["hook"][0], k


def test_kernel_ops_lie_inside_their_launch_span(fixtures_dir, tmp_path,
                                                 monkeypatch):
    """The shared clock: the profiler records the plain kernel's aten ops
    on the timeline of the spans, each inside its window's launch."""
    real = synth_torch.synth_blocks_batch_torch

    def kernel(*a, **kw):
        with torch.profiler.record_function("test.kernel"):
            return real(*a, **kw)

    monkeypatch.setattr(synth_torch, "synth_blocks_batch_torch", kernel)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        windows = _run("single", fixtures_dir, tmp_path)
    spans = _spans(prof)
    calls = sorted((e for e in prof.events() if e.name == "test.kernel"),
                   key=lambda e: e.time_range.start)
    assert len(calls) == windows
    for k, call in enumerate(calls):
        start, end = spans[k]["launch"]
        ops = []
        stack = list(call.cpu_children)
        while stack:
            e = stack.pop()
            ops.append(e)
            stack.extend(e.cpu_children)
        assert any(e.name.startswith("aten::") for e in ops)
        for e in ops + [call]:
            assert start <= e.time_range.start <= e.time_range.end <= end, \
                (k, e.name)


@pytest.mark.parametrize("depth, blocks", [(2, 9), (8, 20)])
def test_iqfile_fifo_stats_count_what_was_written(depth, blocks):
    block = np.arange(600_000, dtype=np.int64).astype(np.int8)
    sink = IqFileSink(os.devnull, fifo_depth=depth, engine="native")
    sink.init()
    assert sink.fifo_stats is None
    for _ in range(blocks):
        sink.write(block)
    sink.close()
    st = sink.fifo_stats
    assert set(st) == set(native.FIFO_STATS) | {"bytes"}
    assert st["dequeued"] == blocks
    assert st["bytes"] == blocks * block.nbytes
    assert st["copy_ns"] > 0 and st["acquire_wait_ns"] >= 0
    assert blocks <= st["depth_sum"] <= blocks * depth


def test_paced_tcp_fifo_stats(fixtures_dir):
    """A paced native TcpSink to a loopback reader: every block sent
    whole, the mean depth at each send within the FIFO."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = bytearray()

    def read():
        conn, _ = srv.accept()
        with conn:
            while chunk := conn.recv(1 << 16):
                got.extend(chunk)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    cfg = SimConfig(nav_file=f"{fixtures_dir}/brdc_test.22n",
                    sample_rate=RATE, realtime=True)
    block_bytes = 2 * cfg.samples_per_epoch
    sink = TcpSink(f"127.0.0.1:{srv.getsockname()[1]}", fifo_depth=4,
                   engine="native")
    sink.init(cfg)
    blocks = 12
    t0 = time.perf_counter()
    for k in range(blocks):
        sink.write(np.full(block_bytes, k, dtype=np.int8))
    sink.close()
    reader.join(10)
    srv.close()
    assert not reader.is_alive()
    st = sink.fifo_stats
    assert st["dequeued"] == blocks
    assert st["bytes"] == len(got) == blocks * block_bytes
    assert np.array_equal(np.frombuffer(bytes(got), np.int8)[::block_bytes],
                          np.arange(blocks))
    assert 0 <= st["depth_sum"] / st["dequeued"] <= 4
    assert st["copy_ns"] > 0
    # paced at 2.06 MB/s: 12 blocks of 0.1 s take at least 1.1 s
    assert time.perf_counter() - t0 >= 1.0


@pytest.mark.parametrize("sink_cls", [IqFileSink, TcpSink])
def test_python_fifo_has_no_stats(sink_cls, tmp_path):
    if sink_cls is IqFileSink:
        sink = IqFileSink(str(tmp_path / "out.bin"), engine="python")
        sink.init()
    else:
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        sink = TcpSink(f"127.0.0.1:{srv.getsockname()[1]}", pace=False,
                       engine="python")
        sink.init()
    sink.write(np.ones(1000, dtype=np.int8))
    sink.close()
    if sink_cls is TcpSink:
        srv.close()
    assert sink.fifo_stats is None


@pytest.mark.parametrize("edit, rebuilt", [
    (None, False),  # the same source: the same library
    ("// edited\n", True),  # an edited source: a library of its own
    ("static int unused_after_edit = 0;\n", True),
])
def test_stale_library_is_rebuilt(edit, rebuilt, tmp_path, monkeypatch):
    """The sink runtime's name hashes its source, so a library built from
    an older source is never the one that loads."""
    before = native.fifo_lib_path()
    src = tmp_path / "fifo.cc"
    src.write_text(open(native._FIFO_SRC).read() + (edit or ""))
    monkeypatch.setattr(native, "_FIFO_SRC", str(src))
    monkeypatch.setattr(native, "_FIFO_DIR", str(tmp_path / "build"))
    after = native.fifo_lib_path()
    assert (os.path.basename(after) != os.path.basename(before)) is rebuilt
    if rebuilt:
        assert native._build_fifo() == after and os.path.exists(after)


def test_stats_bound_in_the_library():
    lib = native._load_fifo()
    assert lib is not None, native.load_error()
    bound = ("gwriter_stats", "gwriter_finish", "gstream_stats",
             "gwriter_lend", "gstream_lend")
    for name in bound:
        assert hasattr(lib, name), name
    assert len(native.FIFO_STATS) == 6
    # the shared host runtime, which the JAX package loads too, is as it was
    shared = native._load()
    assert shared is not None
    for name in bound:
        assert not hasattr(shared, name), name
