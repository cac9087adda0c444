"""MADlib method library (paper Table 1), in PyTorch.

Supervised:   linregr, logregr (IRLS and SGD), naive_bayes, svm,
              decision_tree
Unsupervised: kmeans, svd (power, randomized, low-rank SGD), lda,
              assoc_rules
Descriptive:  sketches (Count-Min, Flajolet-Martin), quantiles, profile
Support:      sparse_vector (RLE), array_ops
Table 2:      sgd_models (every §5.1 model under the one SGD solver of
              ``core.convex``)
Text (§5.2):  crf (features, training, Viterbi, Gibbs, MH), string_match
              (q-grams)

Execution conventions: method wrappers are DECLARATIVE: they emit
logical plan nodes (``core.plan``: ``ScanAgg`` / ``GroupedScanAgg`` /
``IterativeFit`` / ``StreamAgg``) and never call an engine directly; the
planner picks the grouped method, fuses compatible statements into
shared scans (batch several through ``core.session.Session``) and
dedups partitioning sorts.  Methods with a kernel (linregr, sketches,
kmeans) take ``use_kernel`` (True = the CUDA kernel on the card and the
plain version on the CPU, "cuda"/"ref" force one).  Iterative methods
(logregr IRLS, kmeans Lloyd, lda EM, the convex solvers) register an
``IterativeTask`` and run under ``core.iterative.fit``.  One-pass grouped forms:
``linregr_grouped``, ``naive_bayes_grouped``, ``quantiles_grouped``,
``countmin_sketch_grouped``, ``fm_distinct_count_grouped``; grouped
fits: ``kmeans_grouped``, ``logregr_grouped``, and any task through
``fit_grouped`` (``linregr.LinregrTask``).
"""

from . import (  # noqa: F401
    array_ops,
    assoc_rules,
    crf,
    decision_tree,
    kmeans,
    lda,
    linregr,
    logregr,
    naive_bayes,
    profile,
    quantiles,
    sgd_models,
    sketches,
    sparse_vector,
    string_match,
    svd,
    svm,
)
