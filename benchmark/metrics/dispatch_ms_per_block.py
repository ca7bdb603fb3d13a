"""Collation, packing, the copy to the card and the launch, per block
written in the window: the window's growth of ``RunStats.synth_seconds``
(``ops/args.collate_plans`` and ``pack_args``, ``runner.make_packed_kernel``).
It also holds the runner's ``checkpoint.capture_state`` of each window."""


def read(ctx):
    return ctx.stage_ms_per_block("synth")
