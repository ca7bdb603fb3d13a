"""The sinks' ``write`` per block written in the window (``io/sinks``
``IqFileSink``): the harness's own span around each call, summed over the
members' sinks. The writer thread's time is not in it."""


def read(ctx):
    n = ctx.window_blocks()
    if not n:
        return None
    return 1e3 * ctx.sink_seconds() / n
