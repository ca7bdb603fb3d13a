"""The share of the card's idle time in the traced part of the window spent
under the program's ``gpssim.correct`` spans: the strict-parity
corrections of a drained window (``ops/synth_seq.correct_window``, native
C++), the innermost span open on the host while no kernel or copy ran on
the card, both on the profiler's own clock (``benchmark/idle_split.py``).
None without device events or without the program's spans."""

from benchmark.idle_split import stage_share


def read(ctx):
    return stage_share(ctx.trace, "correct")
