"""The port's LM data pipeline (``repro_torch.data``) against the JAX
package, on the CPU.

Everything here is exact: the token stream is numpy in both packages
(bitwise), the Count-Min and FM states are integer counts and bitmaps
(bitwise), the histogram holds counts of whole tokens (equal), and the
pipeline moves batches without changing them.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.methods import sketches as jsk
from repro_torch.configs import base as tbase
from repro_torch.data import TokenStream, corpus_profile, make_lm_batches, \
    synthetic_batch


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 2, 0),
                                                  (100_352, 64, 3, 5)])
def test_token_stream_bitwise_equal_to_jax(vocab, seq, batch, seed):
    mine = TokenStream(vocab=vocab, seq_len=seq, batch=batch, seed=seed)
    ref = jpipe.TokenStream(vocab=vocab, seq_len=seq, batch=batch, seed=seed)
    for got, want in itertools.islice(zip(mine, ref), 3):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_corpus_profile_matches_jax():
    vocab = 1000
    stream = TokenStream(vocab=vocab, seq_len=64, batch=4, seed=3)
    prof = corpus_profile(iter(stream), vocab=vocab, n_batches=3,
                          cm_width=256, device="cpu")
    want = jpipe.corpus_profile(iter(jpipe.TokenStream(
        vocab=vocab, seq_len=64, batch=4, seed=3)), vocab=vocab,
        n_batches=3, cm_width=256)
    # the reference's states, folded as its corpus_profile folds them
    cm = jsk.CountMinAggregate(depth=4, width=256, item_col="tokens")
    fm = jsk.FMAggregate(item_col="tokens")
    cm_s = fm_s = None
    for b in itertools.islice(jpipe.TokenStream(vocab=vocab, seq_len=64,
                                                batch=4, seed=3), 3):
        tbl = {"tokens": jnp.asarray(b["tokens"]).reshape(-1)}
        mask = jnp.ones(tbl["tokens"].shape, jnp.bool_)
        cm_s = cm.transition(cm_s if cm_s is not None else cm.init(tbl),
                             tbl, mask)
        fm_s = fm.transition(fm_s if fm_s is not None else fm.init(tbl),
                             tbl, mask)
    assert np.array_equal(prof["countmin"].numpy(), np.asarray(cm_s))
    assert np.array_equal(prof["fm"].numpy(), np.asarray(fm_s))
    assert np.array_equal(prof["heavy_hitters"].numpy(),
                          np.asarray(want["heavy_hitters"]))
    assert float(prof["distinct_estimate"]) == float(
        want["distinct_estimate"])
    assert np.array_equal(prof["token_histogram"].numpy(),
                          np.asarray(want["token_histogram"]))


def test_corpus_profile_takes_tensor_batches():
    stream = TokenStream(vocab=300, seq_len=16, batch=2, seed=1)
    from_np = corpus_profile(iter(stream), vocab=300, n_batches=2,
                             cm_width=64, device="cpu")
    as_t = ({k: torch.from_numpy(v) for k, v in b.items()} for b in stream)
    from_t = corpus_profile(as_t, vocab=300, n_batches=2, cm_width=64)
    for k in ("countmin", "fm", "token_histogram"):
        assert torch.equal(from_np[k], from_t[k])


def test_corpus_profile_defaults_to_the_card(monkeypatch):
    # numpy batches go to the card unless the caller asks for the CPU: on a
    # machine without one, that is a refusal that names device="cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = TokenStream(vocab=300, seq_len=16, batch=2, seed=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        corpus_profile(iter(stream), vocab=300, n_batches=2, cm_width=64)


def test_make_lm_batches_keeps_order_and_device():
    stream = TokenStream(vocab=200, seq_len=8, batch=2, seed=4)
    got = list(itertools.islice(make_lm_batches(stream, device="cpu",
                                                prefetch=2), 5))
    for g, want in zip(got, itertools.islice(iter(stream), 5)):
        assert set(g) == set(want)
        for k in want:
            assert g[k].device.type == "cpu"
            assert np.array_equal(g[k].numpy(), want[k])


def test_make_lm_batches_ends_with_a_finite_stream():
    batches = [{"x": np.full((2,), i, np.int32)} for i in range(3)]
    got = [int(b["x"][0]) for b in make_lm_batches(batches, device="cpu")]
    assert got == [0, 1, 2]


def test_producer_error_reaches_the_consumer():
    def broken():
        yield {"x": np.zeros((2,), np.int32)}
        raise OSError("disk gone")

    it = make_lm_batches(broken(), device="cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_synthetic_batch_shapes():
    cfg = tbase.reduced_config("stablelm-1.6b")
    b = synthetic_batch(cfg, 3, 10, generator=torch.Generator().manual_seed(0))
    assert b["tokens"].shape == (3, 10) and b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < cfg.vocab
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, dims=1))
    assert torch.equal(b["mask"], torch.ones((3, 10)))
