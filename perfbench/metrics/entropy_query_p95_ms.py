"""The 95th percentile of the window's entropy-query latencies (host
clock around each ``query_entropy``, ms)."""


def read(ctx):
    return ctx.p95_ms("query_entropy")
