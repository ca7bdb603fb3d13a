"""The share of the card's idle time in the traced part of the window spent
under the program's ``gpssim.plan`` spans: planning
(``Simulation.iter_plans``, the ``islice`` over the planner), the
innermost span open on the host while no kernel or copy ran on the card,
both on the profiler's own clock (``benchmark/idle_split.py``). None
without device events or without the program's spans."""

from benchmark.idle_split import stage_share


def read(ctx):
    return stage_share(ctx.trace, "plan")
