"""MADlib methods in PyTorch.  Ported so far: ordinary least squares,
solo and grouped (``linregr``, ``linregr_grouped``).  Method wrappers
are declarative: they emit logical plan nodes and ``core.plan``
executes them."""

from . import linregr  # noqa: F401
