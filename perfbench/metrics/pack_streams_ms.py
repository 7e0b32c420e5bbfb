"""Packing (``core/fleet.py::pack_streams``): the benchmark's spans around
each call, summed and taken per dispatched window (ms)."""


def read(ctx):
    d = ctx.spans.durations("pack_streams")
    windows = len(ctx.spans.durations("run_window"))
    return 1e3 * sum(d) / windows if d and windows else None
