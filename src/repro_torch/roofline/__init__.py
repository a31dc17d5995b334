"""Roofline terms of the port (port of ``repro.roofline``): op-level
costs counted in eager execution (:mod:`.op_cost`, the counterpart of the
JAX package's HLO walker ``hlo_cost``) and the three-term analysis on the
H100's peaks (:mod:`.analysis`)."""
from .analysis import (HW, CellReport, analyze, apply_flash_substitution,  # noqa: F401
                       format_report_table, wire_bytes)
from .op_cost import OpCost, count_costs, kernel, named_scope  # noqa: F401
