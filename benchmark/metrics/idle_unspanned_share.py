"""The share of the card's idle time in the traced part of the window
during which the program had no span open: no kernel or copy ran on the
card and no ``gpssim.<stage>#<window>`` span of the pipeline
(``gpssim_tpu_torch/trace.py``) was open on the host, both on the
profiler's own clock (``benchmark/idle_split.py``). It is what the
``idle_in_<stage>_share`` metrics leave over: idle time that no stage of
the program accounts for. None without device events or without the
program's spans."""

from benchmark.idle_split import stage_share


def read(ctx):
    return stage_share(ctx.trace, None)
