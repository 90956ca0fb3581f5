"""Skew-aware matmul planning, the planned-matmul primitive, context-scoped
matmul configuration, structured epilogues and the chip registry."""

from repro_torch.core import (config, costmodel, epilogue, hw, planner,
                              skewmm)
from repro_torch.core.config import MatmulConfig, mm_config
from repro_torch.core.epilogue import Epilogue

__all__ = ["config", "costmodel", "epilogue", "hw", "planner", "skewmm",
           "MatmulConfig", "mm_config", "Epilogue"]
