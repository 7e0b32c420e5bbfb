"""Import side-effect module: registers every assigned architecture.

One import per line so the per-line ``# noqa: F401`` suppressions match
ruff's (and tools.analysis's) physical-line semantics.
"""
from . import codeqwen15_7b  # noqa: F401
from . import deepseek_moe_16b  # noqa: F401
from . import falcon_mamba_7b  # noqa: F401
from . import gemma2_2b  # noqa: F401
from . import granite_8b  # noqa: F401
from . import internvl2_76b  # noqa: F401
from . import minicpm_2b  # noqa: F401
from . import musicgen_medium  # noqa: F401
from . import olmoe_1b_7b  # noqa: F401
from . import zamba2_2_7b  # noqa: F401

ALL_ARCHS = [
    "granite-8b", "minicpm-2b", "codeqwen1.5-7b", "gemma2-2b",
    "internvl2-76b", "musicgen-medium", "deepseek-moe-16b", "olmoe-1b-7b",
    "zamba2-2.7b", "falcon-mamba-7b",
]
