"""B1 dispatch: launches of ``fleet_update_ragged``'s kernel in the window
(the wrapper's own counter) per dispatched window."""


def read(ctx):
    if not ctx.run.windows:
        return None
    return ctx.run.counters["b1_launches"] / ctx.run.windows
