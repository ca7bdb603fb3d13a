"""The share of the card's idle time in the traced part of the window spent
under the program's ``gpssim.launch`` spans: the launch
(``runner.make_packed_kernel``'s dispatch: pinning, the copy to the card,
K1's launch, the copy back's enqueue), the innermost span open on the
host while no kernel or copy ran on the card, both on the profiler's own
clock (``benchmark/idle_split.py``). None without device events or
without the program's spans."""

from benchmark.idle_split import stage_share


def read(ctx):
    return stage_share(ctx.trace, "launch")
