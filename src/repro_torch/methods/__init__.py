"""MADlib methods in PyTorch.  Ported so far: ordinary least squares,
solo and grouped (``linregr``, ``linregr_grouped``), and the descriptive
statistics: Count-Min and Flajolet-Martin sketches, solo and grouped
(``sketches``), and ``profile`` (and ``profile_stream`` out of core);
the multipass methods under the iterative executor: k-means
(``kmeans``, fused and two-pass Lloyd, k-means++ seeding, GROUP BY) and
logistic regression by IRLS (``logregr``, solo, streamed as
``logregr_stream`` and GROUP BY).  Method wrappers are declarative: they
emit logical plan nodes and ``core.plan`` executes them."""

from . import kmeans, linregr, logregr, profile, sketches  # noqa: F401
