"""Runtime services: failure detection for the churn schedules, and the
versioned control plane over a lossy channel."""
from .control import (ConfigAck, ConfigDirective, SwitchConfigAgent,
                      VersionedControlPlane)
from .fault_tolerance import HeartbeatMonitor

__all__ = ["ConfigAck", "ConfigDirective", "HeartbeatMonitor",
           "SwitchConfigAgent", "VersionedControlPlane"]
