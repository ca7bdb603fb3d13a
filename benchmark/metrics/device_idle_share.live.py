"""The share of the traced part of the window in which no kernel or copy
ran on the card (1 - busy / wall, busy the union of the device events'
intervals), in a paced live run."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.events or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
