"""The churn cell's readings of the program's spans (``program_spans``):
the steps of a dispatched window that only churn opens, and the parity
recovery the adapter calls after a pass's last window, inside the
benchmark's ``recover`` span, whose root the program names
``fleet.recover``.

Each reader returns None where no call holds a span of the name: a
program without the span.
"""
from __future__ import annotations

from typing import Optional

from perfbench import program_spans

program_spans.ROOTS.setdefault("recover", "fleet.recover")


def _seen(ctx, op: str, name: str) -> bool:
    cs = program_spans.calls(ctx, op)
    return bool(cs) and any(s.name == name for c in cs
                            for s in [c.root] + c.spans)


def step_ms(ctx, name: str) -> Optional[float]:
    """Mean ms a dispatched window spends in the spans called ``name``."""
    if not _seen(ctx, "run_window", name):
        return None
    return program_spans.step_ms(ctx, "run_window", name)


def counted(ctx, name: str, key: str) -> Optional[float]:
    """Mean count ``key`` of the spans called ``name`` a dispatched
    window."""
    if not _seen(ctx, "run_window", name):
        return None
    return program_spans.counted(ctx, "run_window", key, name=name)


def recover_ms(ctx) -> Optional[float]:
    """Mean ms of a ``fleet.recover`` call."""
    cs = program_spans.calls(ctx, "recover")
    return sum(c.ms for c in cs) / len(cs) if cs else None


def recovered(ctx) -> Optional[float]:
    """Mean cells a ``fleet.recover`` call rebuilt."""
    if not program_spans.calls(ctx, "recover"):
        return None
    return program_spans.counted(ctx, "recover", "cells")
