"""The sinks' copy of each block into their native FIFO's ring, per block
handed to them (``gpssim_tpu_torch/io/fifo.cc`` ``Fifo::put``, on the
pipeline's thread inside ``Sink.write``): every tee's
``fifo_stats["copy_ns"]``, the counters the sink keeps at ``close()``,
summed over the members' sinks, over the blocks the tees were handed in
the whole run, warm-up included. None where a sink keeps no counters."""


def read(ctx):
    tees = ctx.rec.tees
    stats = [getattr(tee, "fifo_stats", None) for tee in tees]
    blocks = sum(tee.count for tee in tees)
    if not blocks or any(s is None for s in stats):
        return None
    return sum(s["copy_ns"] for s in stats) / 1e6 / blocks
