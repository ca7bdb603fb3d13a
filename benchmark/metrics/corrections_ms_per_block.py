"""The strict-parity corrections per block written in the window: the
window's growth of ``RunStats.correct_seconds`` (``ops/synth_seq``,
native C++)."""


def read(ctx):
    return ctx.stage_ms_per_block("correct")
