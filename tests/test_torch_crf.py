"""The port's linear-chain CRF (§5.2) against the JAX package's.

The same numpy draws go through ``repro.methods.crf`` and
``repro_torch.methods.crf``.  Tolerances:

* ``extract_features``: bitwise (the uint32 hashes in int64 masked to
  32 bits), with and without a dictionary;
* ``emissions`` and ``crf_log_likelihood``: rtol 1e-5 (atol 1e-5);
  the ``crf_program`` gradient rtol 1e-4 (atol 1e-5);
* ``viterbi_decode``: labels equal (int32), padded positions included;
* ``sgd`` on ``crf_program`` with ``batch == n_rows`` (the shuffle only
  reorders a sum): rtol 1e-4, atol 1e-5 over 3 epochs.

The samplers draw from torch's random streams, which cannot reproduce
``jax.random``, so they are held statistically: on a chain small enough
to enumerate (L = 3, T = 4: 81 paths) the Gibbs marginals of many
sweeps lie within 0.05 mean absolute error of the exact marginals, and
MH's acceptance rate lies in (0, 1].  Training with small batches is
held to the reference's own property: the log-likelihood rises.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convex as jcvx
from repro.core.aggregates import run_local as jrun_local
from repro.core.table import Table as JTable
from repro.methods import crf as jcrf
from repro_torch.core import GradientAggregate, run_local, sgd
from repro_torch.core.table import Table
from repro_torch.methods import crf
from strategies import Draw

B, T, V, L, F = 40, 7, 30, 3, 64


def _chain(seed: int, b: int = B, t: int = T, padded: bool = True):
    """Tokens, labels and a length mask (every sequence at least one
    token long when ``padded``)."""
    draw = Draw(seed)
    toks = draw.ints((b, t), 0, V - 1)
    labels = draw.ints((b, t), 0, L - 1)
    if padded:
        lengths = draw.ints((b,), 1, t)
        mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    else:
        mask = np.ones((b, t), np.float32)
    return toks, labels, mask


def _params(seed: int, f: int = F, scale: float = 0.5):
    draw = Draw(seed)
    return {"emit": draw.normal((f, L)) * scale,
            "trans": draw.normal((L, L)) * scale}


def _t(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("n_features", [64, 1000, 1 << 18, (1 << 31) - 1])
@pytest.mark.parametrize("with_dict", [False, True])
def test_extract_features_bitwise(n_features, with_dict):
    draw = Draw(n_features % 997)
    toks = draw.ints((6, 11), 0, 5000)
    toks[0, :3] = [-1, -(2 ** 31), 2 ** 31 - 1]   # wraps as uint32
    dictionary = draw.ints((4096,), 0, 1) if with_dict else None
    got = crf.extract_features(
        torch.from_numpy(toks), n_features,
        None if dictionary is None else torch.from_numpy(dictionary))
    want = np.asarray(jcrf.extract_features(
        jnp.asarray(toks), n_features,
        None if dictionary is None else jnp.asarray(dictionary)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.shape == (6, 11, 4 if with_dict else 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_features_single_position():
    toks = np.array([[5], [7]], np.int32)
    got = crf.extract_features(torch.from_numpy(toks), 128)
    want = jcrf.extract_features(jnp.asarray(toks), 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("padded", [False, True])
def test_emissions_and_log_likelihood_match_jax(padded):
    toks, labels, mask = _chain(1, padded=padded)
    feats = np.array(jcrf.extract_features(jnp.asarray(toks), F))
    params = _params(2)
    got = crf.emissions(_t(params), torch.from_numpy(feats))
    want = jcrf.emissions(_j(params), jnp.asarray(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got_ll = crf.crf_log_likelihood(_t(params), torch.from_numpy(feats),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask))
    want_ll = jcrf.crf_log_likelihood(_j(params), jnp.asarray(feats),
                                      jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5,
                               atol=1e-5)
    per = crf._per_seq_ll(_t(params), torch.from_numpy(feats),
                          torch.from_numpy(labels), torch.from_numpy(mask))
    jper = jcrf._per_seq_ll(_j(params), jnp.asarray(feats),
                            jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-5,
                               atol=1e-5)
    assert bool((per < 0).all())            # log-probabilities


def _crf_tables(seed: int, b: int = B):
    toks, labels, mask = _chain(seed, b)
    feats = np.array(jcrf.extract_features(jnp.asarray(toks), F))
    cols = {"feats": feats, "labels": labels, "mask": mask}
    return (Table.from_columns(cols, device="cpu"),
            JTable.from_columns(cols), cols)


@pytest.mark.parametrize("block_size", [None, 16])
def test_crf_program_gradient_matches_jax(block_size):
    t, jt, _ = _crf_tables(3)
    params = _params(4)
    row_mask = Draw(5).bools((B,), p=0.7)
    got = run_local(GradientAggregate(crf.crf_program(F, L), _t(params)), t,
                    block_size=block_size, mask=torch.from_numpy(row_mask))
    want = jrun_local(jcvx.GradientAggregate(jcrf.crf_program(F, L),
                                             _j(params)), jt,
                      block_size=block_size, mask=jnp.asarray(row_mask))
    for k in ("emit", "trans"):
        np.testing.assert_allclose(got["grad"][k].numpy(),
                                   np.asarray(want["grad"][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert int(got["n"]) == int(row_mask.sum())


@pytest.mark.parametrize("padded", [False, True])
def test_viterbi_matches_jax(padded):
    toks, _, mask = _chain(6, b=64, padded=padded)
    feats = np.array(jcrf.extract_features(jnp.asarray(toks), F))
    params = _params(7, scale=1.0)
    got = crf.viterbi_decode(_t(params), torch.from_numpy(feats),
                             torch.from_numpy(mask))
    want = jcrf.viterbi_decode(_j(params), jnp.asarray(feats),
                               jnp.asarray(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_viterbi_is_the_best_path_on_an_enumerable_chain():
    params, feats, mask = _enumerable(8)
    got = crf.viterbi_decode(params, feats, mask)
    paths, logp = _exact_paths(params, feats)
    best = paths[torch.argmax(logp, dim=1)]          # (B, T)
    assert torch.equal(got.long(), best)


@pytest.mark.parametrize("anneal", [True, False])
def test_crf_sgd_full_batch_matches_jax(anneal):
    t, jt, _ = _crf_tables(9)
    params = _params(10, scale=0.1)
    got = sgd(crf.crf_program(F, L, mu=1e-3), t, _t(params), stepsize=0.05,
              epochs=3, batch=B, seed=1, anneal=anneal)
    want = jcvx.sgd(jcrf.crf_program(F, L, mu=1e-3), jt, _j(params),
                    stepsize=0.05, epochs=3, batch=B, anneal=anneal)
    for k in ("emit", "trans"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_crf_training_raises_the_log_likelihood():
    """tests/test_text.py's setting: labels a function of the token."""
    draw = Draw(11)
    toks = draw.ints((64, 12), 0, V - 1)
    labels = (toks % L).astype(np.int32)
    mask = np.ones((64, 12), np.float32)
    feats = crf.extract_features(torch.from_numpy(toks), F)
    t = Table.from_columns({"feats": feats, "labels": labels, "mask": mask},
                           device="cpu")
    init = crf.crf_init_params(F, L, seed=2, device="cpu")
    trained = sgd(crf.crf_program(F, L, mu=1e-4), t, init, stepsize=0.3,
                  epochs=20, batch=16, seed=3, anneal=False)
    args = (feats, torch.from_numpy(labels), torch.from_numpy(mask))
    assert float(crf.crf_log_likelihood(trained, *args)) \
        > float(crf.crf_log_likelihood(init, *args))
    pred = crf.viterbi_decode(trained, feats, torch.from_numpy(mask))
    assert float((pred == torch.from_numpy(labels)).float().mean()) > 0.9


def test_crf_init_params_shapes_and_seed():
    a = crf.crf_init_params(F, L, seed=4, device="cpu")
    b = crf.crf_init_params(F, L, seed=torch.Generator().manual_seed(4))
    assert a["emit"].shape == (F, L) and a["trans"].shape == (L, L)
    assert torch.equal(a["emit"], b["emit"])
    assert 0.005 < float(a["emit"].std()) < 0.02


# ---------------------------------------------------------------------------
# MCMC, held statistically.
# ---------------------------------------------------------------------------

def _enumerable(seed: int, copies: int = 200, t: int = 4):
    """``copies`` chains over two sequences of length ``t`` (fully
    valid), with strong enough weights that marginals are far from
    uniform."""
    draw = Draw(seed)
    toks = np.repeat(draw.ints((2, t), 0, V - 1), copies // 2, axis=0)
    feats = crf.extract_features(torch.from_numpy(toks), F)
    params = _t(_params(seed + 1, scale=1.0))
    mask = torch.ones((copies, t))
    return params, feats, mask


def _exact_paths(params, feats):
    """Every label path (L^T, T) and its log-probability per row (B, L^T)."""
    emit = crf.emissions(params, feats).double()
    trans = params["trans"].double()
    t = emit.shape[1]
    paths = torch.tensor(list(itertools.product(range(L), repeat=t)))
    score = emit[:, torch.arange(t)[None, :], paths].sum(-1)    # (B, P)
    score = score + trans[paths[:, :-1], paths[:, 1:]].sum(-1)[None]
    return paths, score - torch.logsumexp(score, dim=1, keepdim=True)


def test_gibbs_marginals_match_exact_enumeration():
    params, feats, mask = _enumerable(12)
    paths, logp = _exact_paths(params, feats)
    onehot = torch.nn.functional.one_hot(paths, L).double()     # (P, T, L)
    exact = torch.einsum("bp,ptl->btl", logp.exp(), onehot)
    labels, marg = crf.gibbs_sample(params, feats, mask, seed=5,
                                    n_sweeps=400)
    assert labels.dtype == torch.int32 and marg.shape == exact.shape
    np.testing.assert_allclose(marg.sum(-1).numpy(), 1.0, atol=1e-5)
    # average the copies of each sequence: 200 sweeps x 100 chains each
    got = marg.reshape(2, -1, *marg.shape[1:]).mean(1).double()
    want = exact.reshape(2, -1, *exact.shape[1:])[:, 0]
    mae = float((got - want).abs().mean())
    assert mae < 0.05, mae
    assert float((want.max(-1).values).min()) < 0.9   # not all certain


def test_gibbs_respects_the_mask():
    toks, _, mask = _chain(13, b=16)
    feats = crf.extract_features(torch.from_numpy(toks), F)
    params = _t(_params(14))
    m = torch.from_numpy(mask)
    labels, marg = crf.gibbs_sample(params, feats, m, seed=6, n_sweeps=6)
    start = torch.argmax(crf.emissions(params, feats), -1).to(torch.int32)
    assert torch.equal(labels[m == 0], start[m == 0])
    np.testing.assert_allclose(marg.sum(-1).numpy(), 1.0, atol=1e-5)


def test_mh_acceptance_rate_and_mask():
    params, feats, mask = _enumerable(15, copies=64, t=5)
    mask[:, -1] = 0                                  # a padded position
    labels, rate = crf.mh_sample(params, feats, mask, seed=7, n_steps=300)
    assert labels.dtype == torch.int32 and labels.shape == (64, 5)
    assert 0.0 < float(rate) <= 1.0
    start = torch.argmax(crf.emissions(params, feats), -1).to(torch.int32)
    assert torch.equal(labels[:, -1], start[:, -1])
    again, rate2 = crf.mh_sample(params, feats, mask, seed=7, n_steps=300)
    assert torch.equal(labels, again) and float(rate) == float(rate2)


def test_mh_chain_approaches_exact_marginals():
    """Single-site MH with uniform proposals leaves p(y|z) invariant: over
    many independent chains its end state follows the exact marginals."""
    params, feats, mask = _enumerable(16, copies=2000, t=3)
    paths, logp = _exact_paths(params, feats)
    onehot = torch.nn.functional.one_hot(paths, L).double()
    exact = torch.einsum("bp,ptl->btl", logp.exp(), onehot)
    labels, _ = crf.mh_sample(params, feats, mask, seed=8, n_steps=150)
    got = torch.nn.functional.one_hot(labels.long(), L).double()
    got = got.reshape(2, -1, *got.shape[1:]).mean(1)
    want = exact.reshape(2, -1, *exact.shape[1:])[:, 0]
    assert float((got - want).abs().mean()) < 0.05
