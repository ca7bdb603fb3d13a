"""The share of the blocks handed to the sinks that their native FIFO
queued by pointer instead of copying into its ring (``gpssim_tpu_torch/
io/fifo.cc`` ``Fifo::lend``; a read-only window from ``runner.
fetch_batch`` is lent): 100 times every tee's ``fifo_stats["lent"]``, the
counters the sink keeps at ``close()``, summed over the members' sinks,
over the blocks the tees were handed in the whole run, warm-up included.
None where a sink keeps no such counter."""


def read(ctx):
    tees = ctx.rec.tees
    stats = [getattr(tee, "fifo_stats", None) for tee in tees]
    blocks = sum(tee.count for tee in tees)
    if not blocks or any(s is None or "lent" not in s for s in stats):
        return None
    return 100.0 * sum(s["lent"] for s in stats) / blocks
