"""The 95th percentile (nearest rank) over the keys sent in the window of
the blocks between the written stream and the edit: the block a key's
edit landed at (the first plan after ``tui.TuiApp.handle_key`` ->
``Simulation.set_motion``) less the blocks the sink had been handed when
the key went out."""


def read(ctx):
    lags = ctx.edit_lags()
    if not lags:
        return None
    return float(ctx.p95(lags))
