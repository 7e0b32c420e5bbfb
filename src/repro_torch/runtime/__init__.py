"""Runtime services: failure detection for the churn schedules, the
versioned control plane over a lossy channel, and the durable export
plane."""
from .control import (ConfigAck, ConfigDirective, SwitchConfigAgent,
                      VersionedControlPlane)
from .export import (AckMsg, Collector, DurableExportPlane, ExportMsg,
                     SwitchExporter)
from .fault_tolerance import HeartbeatMonitor

__all__ = ["AckMsg", "Collector", "ConfigAck", "ConfigDirective",
           "DurableExportPlane", "ExportMsg", "HeartbeatMonitor",
           "SwitchConfigAgent", "SwitchExporter", "VersionedControlPlane"]
