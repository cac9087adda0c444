"""Assigned-architecture registry: ``get_config(name)``, reduced smoke
configs, and ``(shape, dtype)`` input specs per (arch x shape) cell."""

from .base import (
    ARCHS,
    SHAPES,
    cell_supported,
    cells,
    get_config,
    input_specs,
    reduced_config,
    step_kind,
)

__all__ = ["ARCHS", "SHAPES", "cell_supported", "cells", "get_config",
           "input_specs", "reduced_config", "step_kind"]
