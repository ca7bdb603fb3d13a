"""The paced sink's queue at each send: the blocks in the native FIFO of
the ``TcpSink`` (the one taken included) at each dequeue of its paced
drain thread, averaged over the whole run (``gpssim_tpu_torch/io/fifo.cc``
``Fifo::dequeue``; ``fifo_stats`` ``depth_sum`` over ``dequeued``, the
counters the sink keeps at ``close()``). Each queued block is 0.1 s of
signal between the producer and the stream. None where the sink keeps no
counters."""


def read(ctx):
    stats = getattr(ctx.rec.tees[0], "fifo_stats", None)
    if stats is None or not stats["dequeued"]:
        return None
    return stats["depth_sum"] / stats["dequeued"]
