"""Opt-in runtime sanitizers for the device data plane (port of
``repro/sanitize.py``).

Two invariants back the port's performance story, and both are easy to
break silently:

  * **Device residency** — the window counter groups never cross to the
    host; only the ``(K,)`` (UnivMon: ``(L, K)``) estimates do.  A stray
    ``.item()``, a boolean-mask index or an upload in the middle of the
    compute still *works*; it just makes the host wait for the card at
    every such op.
  * **Load stability** — the port compiles nothing per shape (eager
    PyTorch); its one compile-like event is loading a kernel library
    (``kernels.build.load``, built with ``nvcc`` on a cache miss).  A
    steady-state replay must load nothing.

Arm the sanitizers with ``REPRO_SANITIZE=1`` (read on every call, so a
test can flip it per case):

  * ``transfer_guard()`` — a context manager the query-plane entry points
    (``repro_torch.kernels.sketch_query.engine``) wrap around their device
    compute.  Armed, it has two parts: on a card,
    ``torch.cuda.set_sync_debug_mode("error")``, so every synchronising
    CUDA call raises (a pageable copy either way, a stream or device
    synchronise); and on every device a dispatch mode that raises on the
    aten ops that make the host wait for a card (``_local_scalar_dense``
    behind ``.item()``, ``float(t)`` and ``bool(t)``; ``nonzero``,
    ``masked_select``, ``unique``; a boolean-mask index; a copy from a
    card to the host).  The dispatch mode is what lets the CPU tests hold
    the invariant.  The sync debug mode cannot tell an explicit crossing
    from an implicit one, so the entry points stage their host inputs on
    the device *before* entering the guard and copy the estimates out
    *after* leaving it.  The previous sync debug mode is put back on exit
    (an exception's too), and guards nest.  Disarmed it is a null context.
  * ``note_trace()`` / ``trace_snapshot()`` / ``traces_since()`` — the
    counter.  ``kernels.build.load`` calls ``note_trace("build.<name>")``
    in its body, which runs only on a cache miss, so the count bumps once
    per library load.  ``tests/test_torch_sanitize.py`` replays a window
    twice and asserts that the second pass loads nothing.

The counter is always on (a dict increment per load); only the transfer
guard is gated behind the environment variable, because it changes error
behaviour and costs Python time on every op while armed.
"""
from __future__ import annotations

import contextlib
import functools
import os
from collections import Counter
from typing import Dict

#: Cumulative per-callsite load counts (name -> times loaded).
TRACE_COUNTS: Counter = Counter()

_ENV = "REPRO_SANITIZE"


def enabled() -> bool:
    """Whether the sanitizers are armed (``REPRO_SANITIZE=1``).

    Read on every call so tests can arm/disarm per case via
    ``monkeypatch.setenv`` without reimporting anything.
    """
    return os.environ.get(_ENV, "").strip() not in ("", "0")


class HostSyncError(RuntimeError):
    """An op inside an armed ``transfer_guard`` would make the host wait
    for the device."""


@functools.lru_cache(maxsize=None)
def _host_sync_mode():
    """The dispatch-mode class of the armed guard (built on first use, so
    importing this module imports no torch internals)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    syncing = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
               aten._unique2, aten.unique_consecutive, aten.unique_dim}
    indexing = {aten.index, aten.index_put, aten.index_put_,
                aten._index_put_impl_}
    mask_dtypes = (torch.bool, torch.uint8)

    def on_card(x) -> bool:
        return isinstance(x, torch.Tensor) and x.device.type != "cpu"

    def to_host(device) -> bool:
        return device is not None and torch.device(device).type == "cpu"

    class _HostSync(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = func.overloadpacket
            why = None
            if packet in syncing:
                why = "reads a device value on the host"
            elif packet in indexing and any(
                    isinstance(i, torch.Tensor) and i.dtype in mask_dtypes
                    for i in args[1] or ()):
                why = "indexes with a boolean mask (a nonzero)"
            elif packet is aten._to_copy and on_card(args[0]) \
                    and to_host(kwargs.get("device")):
                why = "copies a device tensor to the host"
            elif packet is aten.copy_ and on_card(args[1]) \
                    and not on_card(args[0]):
                why = "copies a device tensor to the host"
            if why is not None:
                raise HostSyncError(
                    f"{func} {why} inside an armed transfer_guard; stage "
                    "inputs before the guard and copy results out after it")
            return func(*args, **kwargs)

    return _HostSync


@contextlib.contextmanager
def _armed():
    import torch

    card = torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if card else None
    if card:
        torch.cuda.set_sync_debug_mode("error")
        if torch.cuda.get_sync_debug_mode() != 2:
            raise RuntimeError("transfer_guard: the CUDA sync debug mode "
                               "could not be set to 'error'")
    try:
        with _host_sync_mode()():
            yield
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(prev)


def transfer_guard():
    """Context manager for the device query plane's compute section.

    Armed: the CUDA sync debug mode at ``"error"`` (on a card) and the
    host-sync dispatch mode — an op that makes the host wait for the
    device raises.  Disarmed: a null context.
    """
    if not enabled():
        return contextlib.nullcontext()
    return _armed()


def note_trace(name: str) -> None:
    """Record one load of ``name``.

    Call this in the body of a cached loader: it runs only on a cache
    miss, never on a cached call — which makes the counter a direct probe
    of loads in steady state.
    """
    TRACE_COUNTS[name] += 1


def trace_snapshot() -> Dict[str, int]:
    """Immutable snapshot of the current counts."""
    return dict(TRACE_COUNTS)


def traces_since(snapshot: Dict[str, int]) -> Dict[str, int]:
    """Counts recorded after ``snapshot`` (name -> new count); empty when
    every cached call since hit its cache."""
    return {k: v - snapshot.get(k, 0) for k, v in TRACE_COUNTS.items()
            if v - snapshot.get(k, 0) > 0}
