"""Set-up: process start to the first timed call (host clock)."""


def read(ctx):
    return ctx.run.setup_s
