"""The port's int8 gradient compression (``distributed/compression.py``)
against the JAX package.

JAX's key stream cannot be drawn in torch, so the port's quantizers take
JAX's uniforms (``uniforms=``) where they are compared with it; the
merge over 8 shards comes from the shared 8-device subprocess
(``torch_dist_reference``).  Tolerances:

* ``quantize_int8``, ``compress_grads`` and ``compressed_psum`` fed JAX's
  uniforms: bitwise (the same elementwise f32 operations, and an int32
  sum that is exact in any order);
* statistics with the port's own ``torch.Generator`` draws: the
  reference's own rules (``tests/test_distributed.py``): mean error under
  2e-3 over 16 draws, every error within one scale, dequantized value
  plus new error equal to the corrected gradient within 1e-5, and the
  merged mean within 3 scales of the f32 mean.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_reference as R
from repro.distributed import compression as JC
from repro_torch.distributed import compression as C


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.load(tmp_path_factory)


@pytest.mark.parametrize("seed,shape,spread", [(0, (4096,), 1.0),
                                               (1, (33, 17), 1e-3),
                                               (2, (8,), 1e4)])
def test_quantize_int8_fed_jax_uniforms_is_bitwise_jax(seed, shape, spread):
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 9), shape)
                   ) * spread
    jq, js = JC.quantize_int8(x, key)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, shape)))
    q, s = C.quantize_int8(torch.from_numpy(x), uniforms=u)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))


def test_compress_grads_fed_jax_uniforms_is_bitwise_jax():
    key = jax.random.PRNGKey(3)
    g = {"a": np.asarray(jax.random.normal(key, (64,))),
         "b": np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                           (4, 8))) * 5.0}
    e = {k: np.full(v.shape, 0.01, np.float32) for k, v in g.items()}
    jq, js, je = JC.compress_grads(g, e, key)
    keys = jax.random.split(key, 2)
    us = {k: torch.from_numpy(np.asarray(jax.random.uniform(kk, g[k].shape)))
          for k, kk in zip(sorted(g), keys)}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    te = {k: torch.from_numpy(v) for k, v in e.items()}
    q, s, ne = C.compress_grads(tg, te, uniforms=us)
    for k in g:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        assert float(s[k]) == float(js[k])
        np.testing.assert_array_equal(ne[k].numpy(), np.asarray(je[k]))


def test_compressed_psum_fed_jax_uniforms_is_bitwise_jax(ref):
    names = ("b", "w")
    grads = [{k: torch.from_numpy(ref[f"psum/g/{k}"][s]) for k in names}
             for s in range(8)]
    errors = [{k: torch.from_numpy(ref[f"psum/e/{k}"][s]) for k in names}
              for s in range(8)]
    us = {k: torch.from_numpy(ref[f"psum/u/{k}"]) for k in names}
    out, new_e = C.compressed_psum(grads, errors, uniforms=us)
    for k in names:
        for s in range(8):        # every shard holds the same mean
            np.testing.assert_array_equal(out[k].numpy(),
                                          ref[f"psum/out/{k}"][s])
            np.testing.assert_array_equal(new_e[s][k].numpy(),
                                          ref[f"psum/new_e/{k}"][s])


def test_quantize_int8_is_unbiased():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g)
    errs = []
    for _ in range(16):
        q, s = C.quantize_int8(x, g)
        errs.append((C.dequantize_int8(q, s) - x).numpy())
    assert abs(np.mean(errs)) < 2e-3
    assert np.max(np.abs(errs[0])) <= float(s) + 1e-6


def test_error_feedback_accumulates():
    g = torch.Generator().manual_seed(1)
    grads = {"w": torch.randn(256, generator=g)}
    e = C.init_error_feedback(grads)
    assert e["w"].dtype == torch.float32 and not e["w"].any()
    q, s, e2 = C.compress_grads(grads, e, g)
    np.testing.assert_allclose(
        (C.dequantize_int8(q["w"], s["w"]) + e2["w"]).numpy(),
        grads["w"].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        C.compress_grads(grads, e)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_compressed_psum_is_within_three_scales_of_the_mean(n):
    g = torch.Generator().manual_seed(n)
    shards = [{"w": torch.randn(1024, generator=g)} for _ in range(n)]
    errs = [C.init_error_feedback(s) for s in shards]
    out, new_e = C.compressed_psum(shards, errs, g)
    mean = torch.stack([s["w"] for s in shards]).mean(0)
    scale = max(float(s["w"].abs().max()) for s in shards) / 127.0
    assert float((out["w"] - mean).abs().max()) < 3 * scale
    assert len(new_e) == n
