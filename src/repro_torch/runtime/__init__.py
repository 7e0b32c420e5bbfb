"""Runtime services: failure detection for the churn schedules, the
versioned control plane over a lossy channel, the durable export plane,
the chaos harness that composes them under invariant checks, and the
training side of fault tolerance (elastic re-meshing, stragglers, the
restart loop)."""
from .chaos import ChaosHarness, ChaosInvariantError, cells_equal
from .control import (ConfigAck, ConfigDirective, SwitchConfigAgent,
                      VersionedControlPlane)
from .export import (AckMsg, Collector, DurableExportPlane, ExportMsg,
                     SwitchExporter)
from .fault_tolerance import (ElasticMesh, HeartbeatMonitor, MeshPlan,
                              StragglerPolicy, SupervisorReport,
                              TrainingSupervisor)

__all__ = ["AckMsg", "ChaosHarness", "ChaosInvariantError", "Collector",
           "ConfigAck", "ConfigDirective", "DurableExportPlane", "ElasticMesh",
           "ExportMsg", "HeartbeatMonitor", "MeshPlan", "StragglerPolicy",
           "SupervisorReport", "SwitchConfigAgent", "SwitchExporter",
           "TrainingSupervisor", "VersionedControlPlane", "cells_equal"]
