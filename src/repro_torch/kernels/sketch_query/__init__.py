"""Device-resident query plane: batched gather/merge over window stacks."""
from .engine import (fleet_window_query_device, um_gsum_device,  # noqa: F401
                     um_window_query_device, um_window_query_groups_device)
