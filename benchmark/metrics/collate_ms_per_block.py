"""The collation of each window's plans into the kernel's arguments
(``ops/args.collate_plans``), per block written in the traced part of the
window: the program's ``gpssim.collate#<window>`` spans
(``gpssim_tpu_torch/trace.py``, around the call in ``fleet.run_fleet`` and
``runner._run_batched``) in the profiler's run, their durations summed,
over the blocks the tees saw written while it ran (as ``k1_roofline``
counts them). None where the program has no such span."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.prof is None:
        return None
    us = sum(e.time_range.elapsed_us() for e in tr.prof.events()
             if e.name.startswith("gpssim.collate#"))
    blocks, _ = ctx.written_in_trace()
    if not us or not blocks:
        return None
    return us / 1e3 / blocks
