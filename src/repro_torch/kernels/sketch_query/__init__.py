"""Device-resident query plane: batched gather/merge over window stacks."""
from .engine import fleet_window_query_device  # noqa: F401
