"""The port's Count-Min and Flajolet-Martin sketches against the JAX
package's, solo and GROUP BY.

The same numpy draws go through both packages.  Sketch states are
integers, so they compare bit for bit on any data: negative items, items
near +-2^31 and int64 columns that wrap into int32 included.  FM
estimates go through ``2 ** mean`` in f32, which the two libraries may
round differently in the last place: allclose, rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregates as jagg
from repro.core.table import Table as JTable
from repro.methods import sketches as jsk
from repro_torch.core import run_grouped, run_local, trace_execution
from repro_torch.core.table import Table
from repro_torch.interop import state_from_numpy, state_to_numpy
from repro_torch.methods import sketches as sk
from strategies import GROUP_PATTERNS, Draw, group_layout

EDGE_ITEMS = np.array([0, 1, -1, 2, -2, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2,
                       -2 ** 31 + 1, 12345, -77, 0x9E3779B1 - 2 ** 32],
                      np.int32)


def _items(seed: int, n: int) -> np.ndarray:
    """Zipf-skewed keys, a share of them negated, plus the edge items."""
    draw = Draw(seed)
    keys = draw.rng.zipf(1.3, size=n).astype(np.int64) % 5000
    sign = np.where(draw.bools((n,), p=0.2), -1, 1)
    items = (keys * sign).astype(np.int32)
    items[:len(EDGE_ITEMS)] = EDGE_ITEMS[:n]
    return items


def _u32(a):
    return jnp.asarray(np.asarray(a, np.int32)).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Hash helpers.
# ---------------------------------------------------------------------------

def test_fmix32_matches_jax_at_the_edges():
    draw = Draw(2)
    words = np.concatenate([EDGE_ITEMS, draw.ints((500,), -2 ** 31,
                                                  2 ** 31 - 1)])
    got = sk._fmix32(sk.as_u32(torch.from_numpy(words)))
    want = np.asarray(jsk._fmix32(_u32(words))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,width", [(1, 7), (4, 1024), (8, 1000),
                                         (3, 1)])
def test_hash_rows_match_jax(depth, width):
    items = _items(depth * 100 + width, 600)
    got = sk._hash_rows(torch.from_numpy(items), depth, width)
    want = jsk._hash_rows(jnp.asarray(items), depth, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int64_items_wrap_into_int32_as_in_jax():
    big = np.array([2 ** 40 + 5, -(2 ** 33) - 3, 2 ** 31, -1], np.int64)
    got = sk._hash_rows(torch.from_numpy(big), 4, 1024)
    want = jsk._hash_rows(jnp.asarray(big.astype(np.int32)), 4, 1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [3, 16, 32, 40])
def test_lowest_set_bit_matches_jax(bits):
    draw = Draw(bits)
    words = np.concatenate([EDGE_ITEMS, draw.ints((400,), -2 ** 31,
                                                  2 ** 31 - 1),
                            np.array([0, -2 ** 31, 1 << 20], np.int32)])
    got = sk._lowest_set_bit(sk.as_u32(torch.from_numpy(words)), bits)
    want = jsk._lowest_set_bit(_u32(words), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if bits > 32:  # positions 32 .. bits-2 are never set
        assert not ((got >= 32) & (got < bits - 1)).any()


# ---------------------------------------------------------------------------
# Solo folds, states bit for bit.
# ---------------------------------------------------------------------------

def _tables(items, extra=None):
    cols = {"item": items, **(extra or {})}
    return Table.from_columns(cols, device="cpu"), JTable.from_columns(cols)


@pytest.mark.parametrize("block_size", [None, 97])
@pytest.mark.parametrize("use_kernel", [False, True, "ref"])
def test_countmin_state_matches_jax(use_kernel, block_size):
    items = _items(11, 700)
    mask = Draw(12).bools((700,), p=0.8)
    t, jt = _tables(items)
    with trace_execution() as tr:
        got = run_local(sk.CountMinAggregate(4, 1024, use_kernel=use_kernel),
                        t, block_size=block_size,
                        mask=torch.from_numpy(mask), finalize=False)
    want = jagg.run_local(jsk.CountMinAggregate(4, 1024), jt,
                          block_size=block_size, mask=jnp.asarray(mask),
                          finalize=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    nblocks = 1 if block_size is None else -(-700 // block_size)
    expected = [] if use_kernel is False else ["ref"] * nblocks
    assert [e.engine for e in tr.kernels] == expected


@pytest.mark.parametrize("bits", [16, 32, 40])
@pytest.mark.parametrize("block_size", [None, 97])
def test_fm_state_and_estimate_match_jax(block_size, bits):
    items = _items(21 + bits, 700)
    t, jt = _tables(items)
    agg, jagg_ = sk.FMAggregate(8, bits), jsk.FMAggregate(8, bits)
    got = run_local(agg, t, block_size=block_size, finalize=False)
    want = jagg.run_local(jagg_, jt, block_size=block_size, finalize=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    est = run_local(agg, t, block_size=block_size)
    jest = jagg.run_local(jagg_, jt, block_size=block_size)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-6)


def test_method_wrappers_match_jax():
    items = _items(31, 500)
    t, jt = _tables(items, {"x": Draw(31).normal((500, 2))})
    np.testing.assert_array_equal(
        sk.countmin_sketch(t, depth=5, width=300).numpy(),
        np.asarray(jsk.countmin_sketch(jt, depth=5, width=300)))
    np.testing.assert_allclose(
        sk.fm_distinct_count(t, block_size=64).numpy(),
        np.asarray(jsk.fm_distinct_count(jt, block_size=64)), rtol=1e-6)


def test_countmin_query_matches_jax_and_never_underestimates():
    items = _items(41, 2000)
    t, jt = _tables(items)
    sketch = sk.countmin_sketch(t, depth=4, width=256)
    jsketch = jsk.countmin_sketch(jt, depth=4, width=256)
    probe = np.concatenate([np.unique(items)[:300], EDGE_ITEMS])
    got = sk.countmin_query(sketch, torch.from_numpy(probe))
    want = jsk.countmin_query(jsketch, jnp.asarray(probe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = np.array([(items == v).sum() for v in probe])
    assert (got.numpy() >= exact).all()


def test_fm_final_over_a_stack_matches_jax():
    draw = Draw(51)
    states = draw.bools((5, 8, 32), p=0.6).astype(np.int32)
    states[0] = 1                               # every bit set
    states[1] = 0                               # none set
    agg, jagg_ = sk.FMAggregate(8, 32), jsk.FMAggregate(8, 32)
    got = agg.final_grouped(torch.from_numpy(states))
    want = [np.asarray(jagg_.final(jnp.asarray(s))) for s in states]
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-6)
    np.testing.assert_allclose(agg.final(torch.from_numpy(states[2])).numpy(),
                               want[2], rtol=1e-6)


def test_jax_state_carries_over_and_merges_with_a_port_fold():
    items = _items(61, 900)
    head, tail = items[:400], items[400:]
    jstate = jagg.run_local(jsk.CountMinAggregate(4, 512),
                            JTable.from_columns({"item": head}),
                            finalize=False)
    agg = sk.CountMinAggregate(4, 512, use_kernel=True)
    carried = state_from_numpy(np.asarray(jstate), device="cpu")
    tail_state = run_local(agg, Table.from_columns({"item": tail},
                                                   device="cpu"),
                           finalize=False)
    merged = agg.merge(carried, tail_state)
    whole = run_local(agg, Table.from_columns({"item": items}, device="cpu"),
                      finalize=False)
    assert torch.equal(merged, whole)
    np.testing.assert_array_equal(state_to_numpy(merged), np.asarray(
        jagg.run_local(jsk.CountMinAggregate(4, 512),
                       JTable.from_columns({"item": items}),
                       finalize=False)))


# ---------------------------------------------------------------------------
# GROUP BY, states bit for bit on every layout.
# ---------------------------------------------------------------------------

G = 6


def _grouped_tables(pattern: str, n: int = 403):
    draw = Draw(sum(map(ord, pattern)) + 7)
    gids, _ = group_layout(draw, n, G, pattern)
    return _tables(_items(n + len(pattern), n), {"g": gids})


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("pattern", GROUP_PATTERNS)
def test_grouped_sketch_states_match_jax(pattern, use_kernel):
    t, jt = _grouped_tables(pattern)
    mask = Draw(3).bools((t.n_rows,), p=0.75)
    for agg, jagg_ in ((sk.CountMinAggregate(4, 256, use_kernel=use_kernel),
                        jsk.CountMinAggregate(4, 256)),
                       (sk.FMAggregate(8, 32, use_kernel=use_kernel),
                        jsk.FMAggregate(8, 32))):
        with trace_execution() as tr:
            got = run_grouped(agg, t, "g", G, block_size=32,
                              mask=torch.from_numpy(mask), finalize=False)
        want = jagg.run_grouped(jagg_, jt, "g", G, block_size=32,
                                mask=jnp.asarray(mask), finalize=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        expected = ["ref"] if use_kernel else []
        assert [e.engine for e in tr.kernels] == expected


@pytest.mark.parametrize("pattern", ["skewed", "empty"])
def test_grouped_wrappers_match_jax(pattern):
    t, jt = _grouped_tables(pattern)
    got = sk.countmin_sketch_grouped(t, "g", G, width=128, use_kernel=True)
    want = jsk.countmin_sketch_grouped(jt, "g", G, width=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    est = sk.fm_distinct_count_grouped(t, "g", G, use_kernel=True, bits=16)
    jest = jsk.fm_distinct_count_grouped(jt, "g", G, bits=16)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-6)


def test_grouped_countmin_equals_each_group_alone():
    t, _ = _grouped_tables("skewed")
    stack = sk.countmin_sketch_grouped(t, "g", G, use_kernel=True)
    for g in range(G):
        rows = t["g"] == g
        solo = sk.countmin_sketch(Table({"item": t["item"][rows]}))
        assert torch.equal(stack[g], solo)


def test_aggregates_reject_too_many_hash_rows():
    with pytest.raises(ValueError, match="depth"):
        sk.CountMinAggregate(depth=9)
    with pytest.raises(ValueError, match="num_hashes"):
        sk.FMAggregate(num_hashes=0)
