"""The share of the blocks written that the strict-parity corrections
patched: 100 times every member's ``RunStats.correct_blocks`` (blocks with
at least one corrected sample, which the sink copies instead of lending)
over the blocks written, summed over the members, for the whole run,
warm-up included (the harness keeps no such counter at the window's
edges). None where the program keeps no such counter."""


def read(ctx):
    stats = ctx.rec.stats
    blocks = sum(s.blocks for s in stats)
    if not blocks or not all(hasattr(s, "correct_blocks") for s in stats):
        return None
    return 100.0 * sum(s.correct_blocks for s in stats) / blocks
