"""The reader of ``sink_lent_share``: the share of the blocks handed to the
sinks that their native FIFO lent (queued by pointer) instead of copying.

On hand-made tees it reads 100 where every block was lent, a part where
some were, and nothing, without raising, on a program whose sinks keep no
counters or only the four that came before ``lent``. On the CPU (the port's
plain PyTorch kernels at 1.03 Msps, as in ``test_bench_trace.py``), a
traced ``farm8.static`` run of two members reads 100: every block is a
read-only window of ``runner.fetch_batch``, so none is copied.
"""

from types import SimpleNamespace

import pytest

from benchmark import harness

PARENT_STATS = {"acquire_wait_ns": 0, "copy_ns": 5, "depth_sum": 10,
                "dequeued": 10}


def _ctx(fifo_stats="absent", count=10, members=1):
    tees = []
    for _ in range(members):
        tee = SimpleNamespace(count=count, spans=[])
        if fifo_stats != "absent":
            tee.fifo_stats = fifo_stats
        tees.append(tee)
    rec = SimpleNamespace(tees=tees, sims=[SimpleNamespace(active={})])
    trace = SimpleNamespace(prof=SimpleNamespace(events=lambda: []),
                            t0=0.0, t1=1.0, ticks=3)
    return SimpleNamespace(rec=rec, trace=trace,
                           written_in_trace=lambda: (0, 0))


@pytest.mark.parametrize("fifo_stats", ["absent", None, PARENT_STATS],
                         ids=["absent", "python-fifo", "four-counters"])
def test_silent_on_a_program_without_the_counter(fifo_stats):
    assert harness.load_reader("sink_lent_share")(_ctx(fifo_stats)) is None


@pytest.mark.parametrize("lent, members, share", [
    (10, 1, 100.0),  # every block handed to the tee lent
    (10, 8, 100.0),  # summed over the farm's tees
    (4, 1, 40.0),
    (0, 2, 0.0),  # writable blocks: all copied
])
def test_reads_the_lent_counter(lent, members, share):
    stats = {**PARENT_STATS, "lent": lent, "lent_done": lent}
    got = harness.load_reader("sink_lent_share")(
        _ctx(stats, count=10, members=members))
    assert got == share


def test_a_traced_cpu_farm_lends_every_block():
    res, _ = harness.run_cell(
        "farm8.static", 20261019, 4.0, True, device="cpu",
        config_overrides={"sample_rate": 1_030_000, "members": 2},
        overrides={"dispatch_blocks": 4},
        traffic_overrides={"warmup_blocks": 8, "warmup_stream_blocks": 3})
    assert res["correct"], res["compared"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["sink_lent_share"] == 100.0
    assert got["sink_copy_ms_per_block"] == 0.0
