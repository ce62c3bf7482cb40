"""Milliseconds per fit step: the window over the steps completed in it."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.seconds / w.units if w.units else None
