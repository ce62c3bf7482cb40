"""Milliseconds per frame: the window over the frames completed in it."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.seconds / w.units if w.units else None
