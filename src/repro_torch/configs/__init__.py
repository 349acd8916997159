"""The LM substrate's architecture configs: ten ``ArchConfig``s and the
SNN workload's ``SNNConfig``, copies of ``repro/configs`` value for value."""
from .base import ArchConfig, ShapeCell, SHAPES, cells_for  # noqa: F401
from .registry import ARCHS, get_config, all_cells  # noqa: F401
