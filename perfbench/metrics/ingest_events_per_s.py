"""Packet-switch events handed to the system in the window over the
window's wall time (host clock; the window ends in a device synchronize)."""


def read(ctx):
    if not ctx.run.events or not ctx.run.window_s:
        return None
    return ctx.run.events / ctx.run.window_s
