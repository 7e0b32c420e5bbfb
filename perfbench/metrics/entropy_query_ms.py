"""The window's wall time over the entropy queries completed (host
clock)."""


def read(ctx):
    return ctx.per_op("query_entropy", ctx.run.window_s * 1e3)
