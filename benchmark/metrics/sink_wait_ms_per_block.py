"""The sinks' wait for a free buffer of their native FIFO, per block
handed to them (``gpssim_tpu_torch/io/fifo.cc`` ``Fifo::acquire``, on the
pipeline's thread inside ``Sink.write``; a wait means the writer thread
fell 8 blocks behind): every tee's ``fifo_stats["acquire_wait_ns"]``, the
counters the sink keeps at ``close()``, summed over the members' sinks,
over the blocks the tees were handed in the whole run, warm-up included.
None where a sink keeps no counters."""


def read(ctx):
    tees = ctx.rec.tees
    stats = [getattr(tee, "fifo_stats", None) for tee in tees]
    blocks = sum(tee.count for tee in tees)
    if not blocks or any(s is None for s in stats):
        return None
    return sum(s["acquire_wait_ns"] for s in stats) / 1e6 / blocks
