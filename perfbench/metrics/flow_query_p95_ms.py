"""The 95th percentile of the window's flow-query latencies (host clock
around each ``query_flows``, ms)."""


def read(ctx):
    return ctx.p95_ms("query_flows")
