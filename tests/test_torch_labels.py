"""Every ported method hands the planner a statement node carrying the
reference's label.

Each method is called in both packages on the same small table with
``execute`` replaced by a stub that records the node and stops the
statement: the labels (and the node types) must agree.  ``explain()``
and the analytics server print these labels.
"""

import numpy as np
import pytest

import repro.methods.assoc_rules as jassoc
import repro.methods.decision_tree as jdtree
import repro.methods.kmeans as jkmeans
import repro.methods.lda as jlda
import repro.methods.linregr as jlinregr
import repro.methods.logregr as jlogregr
import repro.methods.naive_bayes as jnb
import repro.methods.quantiles as jquant
import repro.methods.sketches as jsketches
import repro.methods.svd as jsvd
import repro_torch.methods.assoc_rules as tassoc
import repro_torch.methods.decision_tree as tdtree
import repro_torch.methods.kmeans as tkmeans
import repro_torch.methods.lda as tlda
import repro_torch.methods.linregr as tlinregr
import repro_torch.methods.logregr as tlogregr
import repro_torch.methods.naive_bayes as tnb
import repro_torch.methods.quantiles as tquant
import repro_torch.methods.sketches as tsketches
import repro_torch.methods.svd as tsvd
from repro.core.table import Table as JTable
from repro_torch.core.table import Table as TTable
from strategies import Draw


class _Stop(Exception):
    pass


def _capture(monkeypatch, module):
    nodes = []

    def stub(node):
        nodes.append(node)
        raise _Stop

    monkeypatch.setattr(module, "execute", stub)
    return nodes


def _cols():
    draw = Draw(16)
    n = 64
    return {"x": draw.dyadic((n, 3)), "y": draw.bools((n,)).astype(np.float32),
            "g": draw.ints((n,), 0, 3), "item": draw.ints((n,), 0, 9),
            "v": draw.normal((n,)), "counts": draw.ints((n, 5), 0, 3),
            "items": draw.bools((n, 4)).astype(np.float32)}


_DIM_COLS = {"key": np.arange(10, dtype=np.int32),
             "region": (np.arange(10) % 3).astype(np.int32)}
# the dimension of the joined case: [reference, port]
DIM = [JTable.from_columns(_DIM_COLS),
       TTable.from_columns(_DIM_COLS, device="cpu")]
CENTS = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
# (name, module, call) for each ported method; call(method, table)
CASES = [
    ("linregr", "linregr", lambda m, t: m.linregr(t)),
    ("linregr_grouped", "linregr", lambda m, t: m.linregr_grouped(t, "g", 4)),
    ("countmin_sketch", "sketches", lambda m, t: m.countmin_sketch(t)),
    ("fm_distinct_count", "sketches", lambda m, t: m.fm_distinct_count(t)),
    ("countmin_sketch_grouped", "sketches",
     lambda m, t: m.countmin_sketch_grouped(t, "g", 4)),
    ("fm_distinct_count_grouped", "sketches",
     lambda m, t: m.fm_distinct_count_grouped(t, "g", 4)),
    ("kmeans_fit", "kmeans",
     lambda m, t: m.kmeans_fit(t, 2, init_centroids=CENTS)),
    ("kmeans_grouped", "kmeans",
     lambda m, t: m.kmeans_grouped(t, "g", 2, 4, init_centroids=CENTS)),
    ("logregr", "logregr", lambda m, t: m.logregr(t)),
    ("logregr_grouped", "logregr", lambda m, t: m.logregr_grouped(t, "g", 4)),
    ("linregr_joined", "linregr",
     lambda m, t: m.linregr_joined(t, DIM[m.__name__.startswith("repro_torch")],
                                   fact_key="item", dim_key="key",
                                   attr_col="region")),
    ("naive_bayes_fit", "naive_bayes", lambda m, t: m.naive_bayes_fit(t, 2)),
    ("naive_bayes_grouped", "naive_bayes",
     lambda m, t: m.naive_bayes_grouped(t, "g", 2, 4)),
    ("quantiles", "quantiles", lambda m, t: m.quantiles(t, [0.5])),
    ("quantiles_grouped", "quantiles",
     lambda m, t: m.quantiles_grouped(t, "g", [0.5], num_groups=4)),
    ("decision_tree_fit", "decision_tree",
     lambda m, t: m.decision_tree_fit(t, num_classes=2, max_depth=2)),
    ("apriori", "assoc_rules", lambda m, t: m.apriori(t)),
    ("svd_power", "svd", lambda m, t: m.svd_power(t, 2, a_col="x")),
    ("svd_randomized", "svd", lambda m, t: m.svd_randomized(t, 2, a_col="x")),
    ("lda_fit", "lda", lambda m, t: m.lda_fit(t, 2, 5)),
]
MODULES = {"linregr": (jlinregr, tlinregr), "sketches": (jsketches, tsketches),
           "kmeans": (jkmeans, tkmeans), "logregr": (jlogregr, tlogregr),
           "naive_bayes": (jnb, tnb), "quantiles": (jquant, tquant),
           "decision_tree": (jdtree, tdtree), "assoc_rules": (jassoc, tassoc),
           "svd": (jsvd, tsvd), "lda": (jlda, tlda)}


@pytest.mark.parametrize("name,module,call", CASES,
                         ids=[c[0] for c in CASES])
def test_statement_labels_match_the_reference(monkeypatch, name, module,
                                              call):
    jmod, tmod = MODULES[module]
    cols = _cols()
    got_nodes = _capture(monkeypatch, tmod)
    want_nodes = _capture(monkeypatch, jmod)
    with pytest.raises(_Stop):
        call(tmod, TTable.from_columns(cols, device="cpu"))
    with pytest.raises(_Stop):
        call(jmod, JTable.from_columns(cols))
    (got,), (want,) = got_nodes, want_nodes
    assert want.label is not None
    assert got.label == want.label, name
    assert type(got).__name__ == type(want).__name__
