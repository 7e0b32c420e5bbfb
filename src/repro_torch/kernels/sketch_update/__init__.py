"""Sketch update kernels."""
from .fleet import (fleet_update, fleet_update_loop,  # noqa: F401
                    fleet_update_ragged, fleet_update_ragged_ref,
                    fleet_update_ref)
from .ops import sketch_update  # noqa: F401
from .ref import sketch_update_ref  # noqa: F401
