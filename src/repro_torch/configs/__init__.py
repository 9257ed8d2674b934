"""Assigned-architecture configs + the paper's own workload (pgf_tpch),
ported from ``repro.configs`` as data (each ``CONFIG``, ``reduced()`` and
``source`` unchanged).

Select with ``get_config("<arch_id>")`` or ``--arch <id>`` on the
launchers.  Each module exports CONFIG (full published scale) and
``reduced()`` (smoke-test scale, same family).
"""
from .base import (ARCH_IDS, SHAPES, ModelConfig, get_config, get_reduced,
                   input_specs, runnable_cells)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "get_config", "get_reduced",
           "input_specs", "runnable_cells"]
