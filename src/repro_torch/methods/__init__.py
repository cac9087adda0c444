"""MADlib methods in PyTorch.  Ported so far: ordinary least squares,
solo and grouped (``linregr``, ``linregr_grouped``), and the descriptive
statistics: Count-Min and Flajolet-Martin sketches, solo and grouped
(``sketches``), and ``profile``.  Method wrappers are declarative: they
emit logical plan nodes and ``core.plan`` executes them."""

from . import linregr, profile, sketches  # noqa: F401
