"""Arch registry: ``--arch <id>`` resolution for launchers/benchmarks."""
from __future__ import annotations

from typing import Dict

from .base import ArchConfig, ShapeCell, SHAPES, cells_for
from .recurrentgemma_2b import CONFIG as _rg
from .smollm_135m import CONFIG as _sm
from .command_r_35b import CONFIG as _cr
from .stablelm_12b import CONFIG as _sl
from .phi3_medium_14b import CONFIG as _p3
from .paligemma_3b import CONFIG as _pg
from .xlstm_350m import CONFIG as _xl
from .granite_moe_3b_a800m import CONFIG as _gr
from .kimi_k2_1t_a32b import CONFIG as _k2
from .whisper_small import CONFIG as _wh

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (_rg, _sm, _cr, _sl, _p3, _pg, _xl, _gr, _k2, _wh)
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}"
        )
    return ARCHS[name]


def all_cells():
    """Every assigned (arch, shape) pair."""
    for name, cfg in ARCHS.items():
        for cell in cells_for(cfg):
            yield cfg, cell
