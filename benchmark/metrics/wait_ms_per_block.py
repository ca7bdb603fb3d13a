"""The host's wait for a window's result, per block written in the window:
the window's growth of ``RunStats.fetch_seconds`` (``runner.fetch_batch``)."""


def read(ctx):
    return ctx.stage_ms_per_block("fetch")
