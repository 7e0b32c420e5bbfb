"""The system under test: the port's DiSketch fleet (``repro_torch``).

The only module of the benchmark that imports the program.  It hands the
program the benchmark's streams, runs its window path and its queries,
and reads back what the comparison and the per-layer metrics need: the
resident counters of every (epoch, fragment[, level]) cell, the PEBs and
the Eq. 6 trajectory, the B1 launch counter and the library-load counter.
Every loop in ``perfbench/loops/`` drives the program through it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class DiSketchUnderTest:
    def __init__(self, cfg: dict, trace, device: str):
        import torch

        from repro_torch.core.disketch import SwitchStream

        self.torch = torch
        self.cfg = cfg
        self.device = torch.device(device)
        self.mems = {sw: int(m) for sw, m in enumerate(cfg["memories_bytes"])}
        self.order = tuple(sorted(self.mems))
        self.n_frags = len(self.mems)
        self.n_levels = int(cfg.get("n_levels", 16))
        self.n_epochs = trace.n_epochs
        self.window = int(cfg["window"])
        self.streams: List[Dict[int, object]] = [
            {sw: SwitchStream(keys=k, values=np.ones(len(k), np.int64),
                              ts=ts, single_hop=sh)
             for sw, (k, ts, sh) in epoch.items()}
            for epoch in trace.streams]

    # -- the window path ------------------------------------------------

    def new_system(self):
        from repro_torch.core.disketch import DiSketchSystem

        return DiSketchSystem(self.mems, self.cfg["kind"],
                              rho_target=float(self.cfg["rho_target"]),
                              log2_te=int(self.cfg["log2_te"]),
                              counter_bytes=int(self.cfg["counter_bytes"]),
                              n_levels=self.n_levels, backend="fleet",
                              device=self.device)

    def pack(self, epoch: int):
        from repro_torch.core import fleet

        return fleet.pack_streams(self.streams[epoch], self.order)

    def run_window(self, system, epoch0: int, packets: Sequence) -> None:
        system.run_window(epoch0, [self.streams[epoch0 + i]
                                   for i in range(len(packets))],
                          packets=list(packets))

    def ingest_pass(self, system, tracer) -> int:
        """One pass of the inputs through ``system``, window by window,
        each call inside the benchmark's span; returns the windows
        dispatched."""
        n = 0
        for e0 in range(0, self.n_epochs, self.window):
            packets = []
            for e in range(e0, min(e0 + self.window, self.n_epochs)):
                with tracer.span("pack_streams"):
                    packets.append(self.pack(e))
            with tracer.span("run_window"):
                self.run_window(system, e0, packets)
            n += 1
        return n

    def param_rows_per_epoch(self) -> int:
        """Parameter rows B1 reads an epoch: a fragment's levels each."""
        return self.n_frags * (self.n_levels if self.cfg["kind"] == "um"
                               else 1)

    # -- the query planes -----------------------------------------------

    def query_flows(self, system, keys, paths, epochs) -> np.ndarray:
        return system.query_flows(keys, paths, list(epochs),
                                  merge="fragment")

    def query_entropy(self, system, keys, paths, epochs, total: float,
                      k_heavy: int) -> float:
        return system.query_entropy(
            keys, paths, list(epochs), total, n_levels=self.n_levels,
            level_seed=int(self.cfg.get("level_seed", 7777)),
            k_heavy=k_heavy, merge="fragment")

    # -- what the comparison reads --------------------------------------

    def cell(self, system, epoch: int, sw: int) -> Optional[np.ndarray]:
        """The resident ``(L, n, w)`` counters of one cell, or None when
        the program holds no window for it."""
        try:
            return system.fleet.cell_counters(epoch, sw)
        except KeyError:
            return None

    @staticmethod
    def n_log(system) -> List[Dict[int, int]]:
        return list(system.n_log)

    @staticmethod
    def peb_log(system) -> List[Dict[int, float]]:
        return list(system.peb_log)

    # -- counters and the device ----------------------------------------

    @staticmethod
    def counters() -> Dict[str, int]:
        """The program's own counters: B1's launches."""
        from repro_torch.kernels.sketch_update import fleet as FK

        return {"b1_launches": int(FK.fleet_update_ragged.launches)}

    @staticmethod
    def library_loads() -> Dict[str, int]:
        from repro_torch import sanitize

        return sanitize.trace_snapshot()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0

    def release(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


UnderTest = DiSketchUnderTest
