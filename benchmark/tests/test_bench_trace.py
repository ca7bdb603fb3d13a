"""The readers of the program's own spans and FIFO counters.

On the CPU (the port's plain PyTorch kernels at 1.03 Msps, as in
``test_bench_harness.py``): a traced run of each cell reads every such
metric that the CPU can give (the counters and the host spans; the card's
idle time needs device events and reads nothing here); each reader is
silent, not raising, on a program without the spans and counters; and the
idle split gives each stretch of idle time to the innermost open span.

On the card (skipped without one; ``python -m pytest -s
benchmark/tests/test_bench_trace.py``), a traced ``farm8.static`` run at
the cell's own size: every K1 kernel starts after the ``gpssim.launch``
span whose launch call (matched by the runtime's correlation id) started
it, and the harness's tee places each window's first write within 1 ms
of the program's ``gpssim.sink`` span, the error of ``Tracer``'s
"t0 = perf_counter after start" alignment. Both print their readings.
"""

import statistics
from types import SimpleNamespace

import pytest

from benchmark import harness

SMALL = dict(config_overrides={"sample_rate": 1_030_000},
             overrides={"dispatch_blocks": 4},
             traffic_overrides={"warmup_blocks": 8,
                                "warmup_stream_blocks": 3})
ON_CPU = {"farm8.static": {"sink_copy_ms_per_block",
                           "sink_wait_ms_per_block", "collate_ms_per_block",
                           "launch_ms_per_block"},
          "live.keys": {"sink_fifo_depth_mean.live"}}
IDLE = ["idle_unspanned_share"] + [
    f"idle_in_{stage}_share"
    for stage in ("plan", "collate", "pack", "launch", "wait", "sink", "hook")]
NEW = sorted(set().union(*ON_CPU.values()) | set(IDLE))


@pytest.mark.parametrize("cell", sorted(ON_CPU))
def test_a_traced_run_reads_the_programs_spans_and_counters(cell):
    # two members of the farm: several windows inside the profiler's 1.6 s
    small = {**SMALL, "config_overrides": {
        **SMALL["config_overrides"],
        **({"members": 2} if cell == "farm8.static" else {})}}
    res, _ = harness.run_cell(cell, 20261019, 4.0, True, device="cpu",
                              **small)
    assert res["correct"], res["compared"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert ON_CPU[cell] <= set(got)
    assert not set(IDLE) & set(got)  # no device events here
    for name in ON_CPU[cell]:
        assert got[name] >= 0.0, name
    if cell == "live.keys":
        assert 0.0 < got["sink_fifo_depth_mean.live"] <= 8.0
    else:
        assert got["sink_copy_ms_per_block"] > 0.0
        assert got["collate_ms_per_block"] > 0.0
        assert got["launch_ms_per_block"] > 0.0


class _Event(SimpleNamespace):
    def __init__(self, name, start, end, device_type=None):
        from torch.autograd import DeviceType

        super().__init__(
            name=name, device_type=device_type or DeviceType.CPU,
            time_range=SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))


def _ctx(events, fifo_stats="absent"):
    tee = SimpleNamespace(count=10, spans=[])
    if fifo_stats != "absent":
        tee.fifo_stats = fifo_stats
    rec = SimpleNamespace(tees=[tee], sims=[SimpleNamespace(active={})])
    trace = SimpleNamespace(prof=SimpleNamespace(events=lambda: events),
                            t0=0.0, t1=1.0, ticks=3)
    return SimpleNamespace(rec=rec, trace=trace,
                           written_in_trace=lambda: (0, 0))


@pytest.mark.parametrize("fifo_stats", ["absent", None])
@pytest.mark.parametrize("name", NEW)
def test_silent_on_a_program_without_them(name, fifo_stats):
    """The parent's program: no ``fifo_stats`` (or None, the Python FIFO)
    and no ``gpssim.*`` span in the trace, only an aten op."""
    ctx = _ctx([_Event("aten::add", 0.0, 5.0)], fifo_stats)
    assert harness.load_reader(name)(ctx) is None


@pytest.mark.parametrize("name, share", [
    ("idle_unspanned_share", 45.0), ("idle_in_sink_share", 15.0),
    ("idle_in_plan_share", 10.0), ("idle_in_launch_share", 10.0),
    ("idle_in_wait_share", 0.0),
])
def test_idle_split_by_the_innermost_span(name, share):
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    events = [
        _Event("aten::empty", 0.0, 1.0),  # the timeline: 0 to 100 us
        _Event("k1", 10.0, 20.0, cuda),
        _Event("memcpy", 50.0, 60.0, cuda),
        _Event("gpssim.sink#3", 20.0, 40.0),
        _Event("gpssim.plan#4", 35.0, 45.0),  # innermost from 35
        _Event("gpssim.launch#4", 55.0, 70.0),  # 60-70 idle
        _Event("other", 90.0, 100.0),
    ]
    # idle: 0-10, 20-50, 60-100 (80 us): sink 20-35, plan 35-45,
    # launch 60-70, none 0-10, 45-50, 70-100
    got = harness.load_reader(name)(_ctx(events))
    assert got == pytest.approx(100.0 * share / 80.0)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")


LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"}


def test_on_the_card_k1_and_the_sinks_follow_their_spans(card, monkeypatch):
    from torch.autograd import DeviceType

    from benchmark import drive

    bench = harness.load_benchmark()
    got = {}
    real = drive.run_offline

    def run_offline(inputs, cfgs, seconds, tracer):
        rec = real(inputs, cfgs, seconds, tracer)
        got.update(tees=rec.tees, tracer=tracer, window=max(
            cfgs[0].dispatch_blocks, len(cfgs)))
        return rec

    monkeypatch.setattr(drive, "run_offline", run_offline)
    res, _ = harness.run_cell("farm8.static", 4100014, bench["run_seconds"],
                              True)
    assert res["correct"], res["compared"]
    tr = got["tracer"].trace
    evs = list(tr.prof.events())

    # K1 against its launch span: kernel -> launch call (the runtime's
    # correlation id) -> the gpssim.launch span open at the call
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in evs if e.name.startswith("gpssim.launch#"))
    calls = {e.id: e for e in evs if e.device_type == DeviceType.CPU
             and e.name in LAUNCH_CALLS}
    slack = []
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and "synth_k1" in e.name]
    assert kernels
    for k in kernels:
        call = calls[k.id]
        start, end = max(s for s in spans if s[0] <= call.time_range.start)
        assert call.time_range.start <= end, k.id
        slack.append(k.time_range.start - start)
    print(f"K1 kernels {len(kernels)}: start less launch span's start, us: "
          f"least {min(slack)}, median {statistics.median(slack)}")
    assert min(slack) > 0

    # the tee's first write of each window against its gpssim.sink span
    sinks = sorted(e.time_range.start / 1e6 for e in evs
                   if e.name.startswith("gpssim.sink#"))
    writes = sorted(s for tee in got["tees"] for s, _e in tee.spans
                    if tr.t0 < s <= tr.t1)
    d = [1e3 * ((w - tr.t0) - s)
         for w, s in zip(writes[::got["window"]], sinks)]
    print(f"tee's first write less gpssim.sink's start, ms, {len(d)} "
          f"windows: least {min(d)}, median {statistics.median(d)}, "
          f"most {max(d)}")
    assert len(d) > 10 and max(map(abs, d)) < 1.0
