"""Kernel K1's share of its roofline in the traced part of the window: the
least time of one launch's work over K1's device time per launch.

Device time: the profiler's K1 events (``synth_k1``), self time over their
count (``yardstick.device_ms_per_launch``). Work: the blocks the tee saw
written between the profiler's start and stop, which in the pipeline's
steady state are the blocks of the windows launched in between (one launch
and one drain per tick), per tick: ``OPS_PER_CHANNEL_SAMPLE`` int32
operations per active channel-sample at ``INT32_OPS_PER_S``, or the bytes
(the 8- or 16-bit output once, and each active channel-block's inputs) at
``HBM_BYTES_PER_S``, whichever takes longer."""

from benchmark import yardstick


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.prof is None or not tr.ticks:
        return None
    dev_ms = yardstick.device_ms_per_launch(tr.prof, "synth_k1")
    if not dev_ms:
        return None
    blocks, chan_blocks = ctx.written_in_trace()
    if not blocks:
        return None
    n = ctx.samples_per_block
    ops = yardstick.OPS_PER_CHANNEL_SAMPLE * chan_blocks * n / tr.ticks
    nbytes = (blocks * 2 * n * ctx.sample_bits // 8 + chan_blocks
              * yardstick.INPUT_BYTES_PER_CHANNEL_BLOCK) / tr.ticks
    return 100.0 * yardstick.bound(ops, nbytes)["bound_ms"] / dev_ms
