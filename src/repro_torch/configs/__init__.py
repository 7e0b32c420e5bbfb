"""Model configurations: the port's own copy of ``src/repro/configs``
(shapes only, pure Python; fields and values identical to the reference's)."""
from .base import (ModelConfig, ShapeConfig, SHAPES, LONG_CONTEXT_OK,
                   get_config, list_configs, reduced, register)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "LONG_CONTEXT_OK",
           "get_config", "list_configs", "reduced", "register"]
