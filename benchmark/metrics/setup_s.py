"""Seconds from the start of the process to the first timed unit."""


def read(ctx):
    return ctx.window.setup_s
