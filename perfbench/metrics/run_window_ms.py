"""System and fleet dispatch (``DiSketchSystem.run_window``): the mean of
the benchmark's spans around each call (ms, host clock)."""


def read(ctx):
    d = ctx.spans.durations("run_window")
    return 1e3 * sum(d) / len(d) if d else None
