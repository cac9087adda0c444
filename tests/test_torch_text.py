"""The port's approximate string matching (q-gram index) against the JAX
package's.

Both packages get the same strings.  Everything here is exact: the
uint32 trigram hash (computed by the port in int64 masked to 32 bits),
signatures and the index are 0/1 floats, and Jaccard scores divide
integer counts, so every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.methods.string_match as jsm
from repro_torch.core import Table, run_local
from repro_torch.methods import string_match as sm
from strategies import Draw

CORPUS = ["tim tebow", "tom brady", "tim duncan", "peyton manning",
          "tim tebow jr", "aaron rodgers"]


def _strings(seed: int, n: int) -> list[str]:
    """Random words over a small alphabet, some accented, some longer
    than the row width."""
    draw = Draw(seed)
    alphabet = list("abcdeéfgh ijk") + ["ü", "ß", "z"]
    return ["".join(draw.sample(alphabet)
                    for _ in range(draw.integers(0, 80)))
            for _ in range(n)]


@pytest.mark.parametrize("width", [8, 64])
def test_encode_strings_equal(width):
    strs = _strings(1, 40) + CORPUS + ["", "ABC"]
    got = sm.encode_strings(strs, width, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (len(strs), width)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsm.encode_strings(strs, width)))


@pytest.mark.parametrize("n_buckets", [7, 512, 1000])
def test_trigram_signature_bitwise(n_buckets):
    chars = Draw(2).ints((64, 32), 0, 255).astype(np.uint8)
    chars[::5, 10:] = 0                        # short strings
    got = sm.trigram_signature(torch.from_numpy(chars), n_buckets)
    want = jsm.trigram_signature(jnp.asarray(chars), n_buckets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block_size", [None, 7])
def test_trigram_index_bitwise(block_size):
    strs = _strings(3, 50) + CORPUS
    cols = {"chars": np.asarray(jsm.encode_strings(strs)),
            "doc_id": np.arange(len(strs), dtype=np.int32)}
    t = Table.from_columns(cols, device="cpu")
    j = jcore.Table.from_columns(cols)
    got = run_local(sm.TrigramIndexAggregate(len(strs), 256), t,
                    block_size=block_size)
    want = jcore.run_local(jsm.TrigramIndexAggregate(len(strs), 256), j,
                           block_size=block_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = sm.trigram_signature(sm.encode_strings(["tim tebow"], device="cpu"),
                             256)[0]
    np.testing.assert_array_equal(
        sm.jaccard_scores(got, q).numpy(),
        np.asarray(jsm.jaccard_scores(want, jnp.asarray(q.numpy()))))


def test_approx_match_finds_the_reference_hits():
    """The reference's ``tests/test_text.py`` case, in both packages."""
    chars = sm.encode_strings(CORPUS, device="cpu")
    t = Table.from_columns({"chars": chars,
                            "doc_id": np.arange(len(CORPUS))}, device="cpu")
    index = run_local(sm.TrigramIndexAggregate(len(CORPUS), 512), t)
    idx, scores = sm.approx_match(index, "tim tebow", threshold=0.4)
    j = jcore.Table.from_columns({"chars": jsm.encode_strings(CORPUS),
                                  "doc_id": jnp.arange(len(CORPUS))})
    jindex = jcore.run_local(jsm.TrigramIndexAggregate(len(CORPUS), 512), j)
    jidx, jscores = jsm.approx_match(jindex, "tim tebow", threshold=0.4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    matched = {CORPUS[i] for i in idx.tolist() if i >= 0}
    assert matched == {"tim tebow", "tim tebow jr"}
    assert float(scores[0]) == 1.0 and float(scores[1]) < 0.1


def test_encode_strings_goes_to_the_card_by_default():
    if torch.cuda.is_available():
        assert sm.encode_strings(["a"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            sm.encode_strings(["a"])
