"""Host planning per block written in the window: the window's growth of
``RunStats.plan_seconds`` (``scenario.Simulation.iter_plans`` inside the
runner; a fleet books all members' planning on member 0)."""


def read(ctx):
    return ctx.stage_ms_per_block("plan")
