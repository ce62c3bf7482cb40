"""Peak device memory allocated during the window (reset at its start)."""


def read(ctx):
    return ctx.window.window_peak / 2 ** 30 if ctx.window.window_peak else None
