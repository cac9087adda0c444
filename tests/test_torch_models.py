"""The port's LM serving path (``repro_torch.models``, ``configs``) against
the JAX package, on the reduced dense configs, on the CPU.

Weights come from the reference's ``init_model`` and cross with
``interop.model_params_from_numpy``; tokens and activations are numpy
draws.  Everything is f32 unless a test says otherwise.  Tolerances:

* layers and logits against JAX: rtol 1e-5, atol 1e-5.  The two
  libraries sum the same f32 products in other orders (matmuls,
  einsums, softmax); logits of these models reach about 5 and differ by
  about 2e-6.
* bf16 layers against JAX in bf16: one bf16 rounding step (rtol 2^-7 of
  the value, atol 2^-7 of the largest value), since an f32 difference in
  the last bit can move a bf16 rounding.
* decode against forward, port alone: rtol 2e-3, atol 2e-4, the bounds
  of the reference's own ``test_decode_matches_forward``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import base as tbase
from repro_torch.core import trace_execution
from repro_torch.interop import model_params_from_numpy, \
    model_params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import model as M
from strategies import Draw

DENSE = ["qwen3-8b", "qwen3-14b", "phi3-mini-3.8b", "stablelm-1.6b"]
RTOL = ATOL = 1e-5
BF16_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def jax_params():
    """arch -> (JAX params, numpy tree) of the reduced config, key 0."""
    cache = {}

    def get(arch):
        if arch not in cache:
            params, _ = JM.init_model(jbase.reduced_config(arch),
                                      jax.random.PRNGKey(0))
            cache[arch] = (params, jax.tree.map(np.asarray, params))
        return cache[arch]
    return get


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- configs -----------------------------------------------------------------

def test_full_configs_match_assignment():
    """Pin the exact assigned hyperparameters (as the reference does)."""
    expect = {
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840, 64, 6),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352, 16, 4),
        "qwen3-8b": (36, 4096, 32, 8, 12288, 151936, 0, 0),
        "phi3-mini-3.8b": (32, 3072, 32, 32, 8192, 32064, 0, 0),
        "qwen3-14b": (40, 5120, 40, 8, 17408, 151936, 0, 0),
        "stablelm-1.6b": (24, 2048, 32, 32, 5632, 100352, 0, 0),
        "hubert-xlarge": (48, 1280, 16, 16, 5120, 504, 0, 0),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000, 0, 0),
        "qwen2-vl-2b": (28, 1536, 12, 2, 8960, 151936, 0, 0),
        "xlstm-350m": (24, 1024, 4, 4, 0, 50304, 0, 0),
    }
    for arch, want in expect.items():
        cfg = tbase.get_config(arch)
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_ff, cfg.vocab, cfg.n_experts, cfg.top_k)
        assert got == want, (arch, got)
    q8 = tbase.get_config("qwen3-8b")
    assert q8.qk_norm and q8.d_head == 128 and q8.dtype == "bfloat16"
    assert tbase.get_config("qwen2-vl-2b").mrope
    assert not tbase.get_config("hubert-xlarge").causal


@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "reduced_config"):
        mine = dataclasses.asdict(getattr(tbase, get)(arch))
        ref = dataclasses.asdict(getattr(jbase, get)(arch))
        assert mine == ref, (arch, get)
    assert tbase.get_config(arch).params_total == \
        jbase.get_config(arch).params_total


def test_cells_and_input_specs_equal_the_reference():
    """31 runnable cells + 9 documented skips = 40; every input spec is
    the reference's shape and dtype, as a (shape, torch.dtype) pair."""
    mine = list(tbase.cells(include_skipped=True))
    assert mine == list(jbase.cells(include_skipped=True))
    assert len(mine) == 40 and sum(c[2] for c in mine) == 31
    for arch, shape, ok, _ in mine:
        if not ok:
            continue
        spec = tbase.input_specs(arch, shape)
        ref = jbase.input_specs(arch, shape)
        assert list(spec) == list(ref)
        for name, (shp, dtype) in spec.items():
            assert shp == ref[name].shape, (arch, shape, name)
            assert str(dtype).removeprefix("torch.") == \
                str(ref[name].dtype), (arch, shape, name)
        assert tbase.input_batch_axes(arch, shape) == \
            jbase.input_batch_axes(arch, shape)
    assert tbase.step_kind("prefill_32k") == "prefill"


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    draw = Draw(1)
    x, g = draw.normal((2, 5, 64)), draw.normal((64,))
    got = L.rms_norm(_t(x).to(getattr(torch, dtype)),
                     _t(g).to(getattr(torch, dtype)), 1e-6)
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype), 1e-6)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=BF16_TOL,
            atol=BF16_TOL * float(np.abs(want).max()))


def test_apply_rope_matches_jax():
    draw = Draw(2)
    x = draw.normal((2, 7, 4, 16))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    got = L.apply_rope(_t(x), _t(pos), 10_000.0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _qkv(seed, b=2, s=32, h=4, hk=2, dh=16):
    draw = Draw(seed)
    return (draw.normal((b, s, h, dh)), draw.normal((b, s, hk, dh)),
            draw.normal((b, s, hk, dh)))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_attention_scores_matches_jax(causal, window):
    q, k, v = _qkv(3)
    for flash in (False, True):
        got = L.attention_scores(_t(q), _t(k), _t(v), causal=causal,
                                 window=window, use_flash=flash)
        want = JL.attention_scores(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, use_flash=flash)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 12)])
def test_attention_chunked_matches_jax(dtype, causal, window):
    """Chunks of 8 over S = 32: the online softmax across four KV chunks,
    the causal skip of chunks after the query chunk, and (bf16) the
    reference's casts of the pre-scaled q and of p."""
    q, k, v = _qkv(4)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = L.attention_chunked(*(_t(a).to(td) for a in (q, k, v)),
                              causal=causal, window=window, chunk_q=8,
                              chunk_k=8)
    want = JL.attention_chunked(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                causal=causal, window=window, chunk_q=8,
                                chunk_k=8)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        full = L.attention_scores(_t(q), _t(k), _t(v), causal=causal,
                                  window=window)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(
            got.float().numpy(), want, rtol=BF16_TOL,
            atol=BF16_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("use_flash,threshold", [(True, 2048), (False, 2048),
                                                 (False, 8)])
def test_run_attention_matches_jax(jax_params, use_flash, threshold):
    """The layer-0 attention of the reduced qwen3-8b (qk_norm, GQA): the
    flash dispatch, full scores, and the chunked path (threshold 8 < S)."""
    cfg = tbase.reduced_config("qwen3-8b")
    params, tree = jax_params("qwen3-8b")
    model = model_params_from_numpy(cfg, tree, device="cpu")
    x = Draw(5).normal((2, 16, cfg.d_model))
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    got = L.run_attention(model.blocks[0].attn, cfg, _t(x), _t(pos),
                          use_flash=use_flash, chunked_threshold=threshold)
    p0 = jax.tree.map(lambda a: a[0], params["periods"]["0"]["attn"])
    jcfg = jbase.reduced_config("qwen3-8b")
    want = JL.run_attention(p0, jcfg, jnp.asarray(x), jnp.asarray(pos),
                            use_flash=use_flash,
                            chunked_threshold=threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- model -------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(jax_params, arch):
    cfg = tbase.reduced_config(arch)
    params, tree = jax_params(arch)
    model = model_params_from_numpy(cfg, tree, device="cpu")
    toks = _tokens(cfg, 2, 16)
    want, aux = JM.forward(params, jbase.reduced_config(arch),
                           jnp.asarray(toks))
    want = np.asarray(want)
    for use_flash in (True, False):
        with trace_execution() as tr:
            got, got_aux = M.forward(model, _t(toks), use_flash=use_flash)
        assert got.shape == (2, 16, cfg.vocab) and got_aux == {} == aux
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        # one flash_attention dispatch per layer, resolved to the plain
        # version on CPU tensors
        assert [e.engine for e in tr.kernels] == \
            ["ref"] * (cfg.n_layers if use_flash else 0)


def test_decode_step_matches_jax(jax_params):
    """Scalar and (B,) positions, alternating, for 12 steps over a cache
    of 8: positions 8..11 wrap the ring buffer."""
    arch = "qwen3-8b"
    cfg, jcfg = tbase.reduced_config(arch), jbase.reduced_config(arch)
    params, tree = jax_params(arch)
    model = model_params_from_numpy(cfg, tree, device="cpu")
    toks = _tokens(cfg, 2, 12, seed=1)
    step = jax.jit(lambda p, s, t, pos: JM.decode_step(p, jcfg, s, t, pos))
    jstate = JM.init_decode_state(jcfg, 2, 8)
    state = M.init_decode_state(cfg, 2, 8, device="cpu")
    for t in range(12):
        pos = np.int32(t) if t % 2 else np.full((2,), t, np.int32)
        want, jstate = step(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(pos))
        got, state = M.decode_step(model, state, _t(toks[:, t:t + 1]),
                                   _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {t}")
    for i, cache in enumerate(state):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                cache[kv].numpy(), np.asarray(jstate["periods"]["0"][kv][i]),
                rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the forward logits (port alone,
    weights from the port's own init_model)."""
    cfg = tbase.reduced_config(arch)
    model = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    toks = _t(_tokens(cfg, 2, 12, seed=2))
    fwd, _ = M.forward(model, toks)
    state = M.init_decode_state(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(12):
        lg, state = M.decode_step(model, state, toks[:, t:t + 1], t)
        outs.append(lg)
    np.testing.assert_allclose(fwd.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-4)


def test_interop_round_trip_is_exact(jax_params):
    cfg = tbase.reduced_config("qwen3-8b")
    _, tree = jax_params("qwen3-8b")
    back = model_params_to_numpy(model_params_from_numpy(cfg, tree,
                                                         device="cpu"))
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    # and a bf16 model through its f32 arrays
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    m = M.init_model(bf, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    m2 = model_params_from_numpy(bf, model_params_to_numpy(m), device="cpu")
    for (n, p), (_, p2) in zip(m.named_parameters(), m2.named_parameters()):
        assert p2.dtype == torch.bfloat16 and torch.equal(p, p2), n


def test_init_model_draws():
    """Norms are ones; matrices normal with std fan_in^-0.5, the
    embedding std 1; the same seed gives the same model."""
    cfg = dataclasses.replace(tbase.reduced_config("qwen3-8b"), vocab=4096)
    a = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    b = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
        if "norm" in name.rsplit(".", 1)[-1]:
            assert torch.equal(p, torch.ones_like(p)), name
    assert abs(float(a.embed.std()) - 1.0) < 0.02
    assert abs(float(a.lm_head.std()) * cfg.d_model ** 0.5 - 1.0) < 0.02
    wq = a.blocks[1].attn.wq
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("arch,item", [
    ("moonshot-v1-16b-a3b", "item 11"), ("dbrx-132b", "item 11"),
    ("hubert-xlarge", "item 11"), ("recurrentgemma-2b", "item 11"),
    ("qwen2-vl-2b", "item 11"), ("xlstm-350m", "item 11")])
def test_unported_families_raise(arch, item):
    cfg = tbase.reduced_config(arch)
    for make in (lambda: M.init_model(
            cfg, generator=torch.Generator(), device="cpu"),
            lambda: M.init_decode_state(cfg, 1, 4, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 {item}"):
            make()


@pytest.mark.parametrize("change", [{"seq_parallel": True},
                                    {"moe_impl": "a2a"}])
def test_sharding_options_raise(change):
    cfg = dataclasses.replace(tbase.reduced_config("qwen3-8b"), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        M.Model(cfg, device="cpu")


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tbase.reduced_config("qwen3-8b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        M.init_model(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        M.init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        model_params_from_numpy(cfg, {})
