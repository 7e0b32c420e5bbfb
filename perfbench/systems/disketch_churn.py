"""The system under test under §6 churn: the port's DiSketch fleet
(``repro_torch``) with XOR parity groups, fed the configuration's failure
schedule.

As ``disketch.py``, whose adapter it extends, plus: the fleet is built
with ``parity_groups_chunked(frag_order, parity_group)``; a pass advances
a fresh ``net.simulator.FailureSchedule`` epoch by epoch, as
``Replayer.run`` does, and hands each window its events; after the last
window the controller rebuilds what parity can (``fleet.recover``); and
the comparison reads each cell's liveness and queries with
``failures="recover"``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .disketch import DiSketchUnderTest


class DiSketchChurnUnderTest(DiSketchUnderTest):
    def __init__(self, cfg: dict, trace, device: str):
        super().__init__(cfg, trace, device)
        self.downs: Dict[int, Tuple[int, Optional[int]]] = {
            int(sw): (int(d), None if u is None else int(u))
            for sw, (d, u) in cfg["failures"]["downs"].items()}

    def new_system(self):
        from repro_torch.core.disketch import DiSketchSystem
        from repro_torch.core.fleet import parity_groups_chunked

        groups = parity_groups_chunked(self.order,
                                       int(self.cfg["parity_group"]))
        return DiSketchSystem(self.mems, self.cfg["kind"],
                              rho_target=float(self.cfg["rho_target"]),
                              log2_te=int(self.cfg["log2_te"]),
                              counter_bytes=int(self.cfg["counter_bytes"]),
                              n_levels=self.n_levels, backend="fleet",
                              fleet_kwargs={"parity_groups": groups},
                              device=self.device)

    def ingest_pass(self, system, tracer) -> int:
        """One pass under a fresh failure schedule, each call inside the
        benchmark's span, then the parity recovery inside ``recover``;
        returns the windows dispatched."""
        from repro_torch.net.simulator import FailureSchedule

        schedule = FailureSchedule(int(self.cfg["n_switches"]), self.downs)
        n = 0
        for e0 in range(0, self.n_epochs, self.window):
            eps = range(e0, min(e0 + self.window, self.n_epochs))
            packets, events = [], []
            for e in eps:
                events.append(schedule.advance(e))
                with tracer.span("pack_streams"):
                    packets.append(self.pack(e))
            with tracer.span("run_window"):
                system.run_window(e0, [self.streams[e] for e in eps],
                                  packets=packets, events_by_epoch=events)
            n += 1
        with tracer.span("recover"):
            system.fleet.recover()
        return n

    def query_flows(self, system, keys, paths, epochs) -> np.ndarray:
        return system.query_flows(keys, paths, list(epochs),
                                  merge="fragment", failures="recover")

    @staticmethod
    def is_live(system, epoch: int, sw: int) -> bool:
        return bool(system.fleet.is_live(sw, epoch))


UnderTest = DiSketchChurnUnderTest
