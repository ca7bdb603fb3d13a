"""The readers of the strict cell ``record.strict``: the corrections'
counters and their share of the idle card.

On hand-made records ``correct_candidates_per_block`` and
``patched_block_share`` read the program's ``RunStats`` counters summed
over the members, and all three new readers are silent, not raising, on a
program that keeps no such counter or span. On the CPU (the port's plain
PyTorch kernels at 1.03 Msps, as in ``test_bench_trace.py``), a traced
``record.strict`` run is correct and reads the counters (the idle share
needs device events and reads nothing here).
"""

from types import SimpleNamespace

import pytest

from benchmark import harness

COUNTERS = ("correct_candidates_per_block", "patched_block_share")


def _ctx(stats):
    rec = SimpleNamespace(stats=stats, tees=[], sims=[])
    trace = SimpleNamespace(prof=SimpleNamespace(events=lambda: []),
                            t0=0.0, t1=1.0, ticks=3)
    return SimpleNamespace(rec=rec, trace=trace)


def _stats(blocks, candidates=None, patched=None):
    s = SimpleNamespace(blocks=blocks)
    if candidates is not None:
        s.correct_candidates = candidates
        s.correct_blocks = patched
    return s


@pytest.mark.parametrize("name", COUNTERS + ("idle_in_correct_share",))
def test_silent_on_a_program_without_them(name):
    ctx = _ctx([_stats(40)])
    ctx.trace = None
    assert harness.load_reader(name)(ctx) is None


@pytest.mark.parametrize("name", COUNTERS)
def test_silent_without_blocks(name):
    assert harness.load_reader(name)(_ctx([_stats(0, 0, 0)])) is None


@pytest.mark.parametrize("members, want", [
    ([(40, 52, 1)], {"correct_candidates_per_block": 1.3,
                     "patched_block_share": 2.5}),
    ([(30, 30, 0), (10, 22, 2)], {"correct_candidates_per_block": 1.3,
                                  "patched_block_share": 5.0}),
    ([(25, 0, 0)], {"correct_candidates_per_block": 0.0,
                    "patched_block_share": 0.0}),
])
def test_reads_the_counters(members, want):
    ctx = _ctx([_stats(*m) for m in members])
    for name, value in want.items():
        assert harness.load_reader(name)(ctx) == pytest.approx(value), name


def test_a_traced_cpu_run_reads_the_counters():
    res, numbers = harness.run_cell(
        "record.strict", 20261019, 4.0, True, device="cpu",
        config_overrides={"sample_rate": 1_030_000},
        overrides={"dispatch_blocks": 4},
        traffic_overrides={"warmup_blocks": 8})
    assert res["correct"], res["compared"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(COUNTERS) | {"corrections_ms_per_block"} <= set(got)
    assert "idle_in_correct_share" not in got  # no device events here
    assert got["corrections_ms_per_block"] > 0.0
    assert got["correct_candidates_per_block"] >= 0.0
    assert 0.0 <= got["patched_block_share"] <= 100.0
