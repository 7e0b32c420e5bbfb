"""Sketch update kernels."""
from .fleet import fleet_update_ragged, fleet_update_ragged_ref  # noqa: F401
