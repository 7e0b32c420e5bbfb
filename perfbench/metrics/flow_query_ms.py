"""The window's wall time over the flow queries completed (host clock)."""


def read(ctx):
    return ctx.per_op("query_flows", ctx.run.window_s * 1e3)
