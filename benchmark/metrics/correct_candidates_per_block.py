"""The candidates the strict-parity corrections' screen evaluated per block
written: every member's ``RunStats.correct_candidates`` (``ops/
synth_seq``, native C++; one per channel and flagged sample the screen
walks to) over the blocks written, summed over the members, for the whole
run, warm-up included (the harness keeps no such counter at the window's
edges). None where the program keeps no such counter."""


def read(ctx):
    stats = ctx.rec.stats
    blocks = sum(s.blocks for s in stats)
    if not blocks or not all(hasattr(s, "correct_candidates")
                             for s in stats):
        return None
    return sum(s.correct_candidates for s in stats) / blocks
