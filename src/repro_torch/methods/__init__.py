"""MADlib method library (paper Table 1), in PyTorch.

Supervised:   linregr, logregr (IRLS), naive_bayes, decision_tree
Unsupervised: kmeans, svd (power and randomized), lda, assoc_rules
Descriptive:  sketches (Count-Min, Flajolet-Martin), quantiles, profile
Support:      sparse_vector (RLE), array_ops
Text (§5.2):  string_match (q-grams)

Still to port (ROADMAP Queue 1 item 9, the convex half): the convex
solver layer ``core/convex.py`` and what runs on it, ``svm``,
``sgd_models``, ``crf``, ``svd.lowrank_sgd`` and the SGD path of
``logregr``; the names that exist raise ``NotImplementedError`` naming
the item.

Execution conventions: method wrappers are DECLARATIVE: they emit
logical plan nodes (``core.plan``: ``ScanAgg`` / ``GroupedScanAgg`` /
``IterativeFit`` / ``StreamAgg``) and never call an engine directly; the
planner picks the grouped method, fuses compatible statements into
shared scans (batch several through ``core.session.Session``) and
dedups partitioning sorts.  Methods with a kernel (linregr, sketches,
kmeans) take ``use_kernel`` (True = the CUDA kernel on the card and the
plain version on the CPU, "cuda"/"ref" force one).  Iterative methods
(logregr IRLS, kmeans Lloyd, lda EM) register an ``IterativeTask`` and
run under ``core.iterative.fit``.  One-pass grouped forms:
``linregr_grouped``, ``naive_bayes_grouped``, ``quantiles_grouped``,
``countmin_sketch_grouped``, ``fm_distinct_count_grouped``; grouped
fits: ``kmeans_grouped``, ``logregr_grouped``.
"""

from . import (  # noqa: F401
    array_ops,
    assoc_rules,
    decision_tree,
    kmeans,
    lda,
    linregr,
    logregr,
    naive_bayes,
    profile,
    quantiles,
    sketches,
    sparse_vector,
    string_match,
    svd,
)
