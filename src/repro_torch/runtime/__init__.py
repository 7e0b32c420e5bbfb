"""Runtime services: failure detection for the churn schedules, the
versioned control plane over a lossy channel, the durable export plane,
and the chaos harness that composes them under invariant checks."""
from .chaos import ChaosHarness, ChaosInvariantError, cells_equal
from .control import (ConfigAck, ConfigDirective, SwitchConfigAgent,
                      VersionedControlPlane)
from .export import (AckMsg, Collector, DurableExportPlane, ExportMsg,
                     SwitchExporter)
from .fault_tolerance import HeartbeatMonitor

__all__ = ["AckMsg", "ChaosHarness", "ChaosInvariantError", "Collector",
           "ConfigAck", "ConfigDirective", "DurableExportPlane", "ExportMsg",
           "HeartbeatMonitor", "SwitchConfigAgent", "SwitchExporter",
           "VersionedControlPlane", "cells_equal"]
