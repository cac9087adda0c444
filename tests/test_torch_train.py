"""The port's LM training (``train_loss``, ``make_train_step``, the
interop of a training state) against the JAX package, on the CPU.

Weights and optimizer states come from the reference's ``init_model`` /
``init_train_state`` and cross with ``interop``; tokens and embeddings
are numpy draws.  Everything is f32.  Tolerances:

* loss against JAX: rtol 1e-5 (the logits' own tolerance in
  ``test_torch_models.py``: the same f32 products summed in other
  orders); 1e-4 for the hybrid family, whose RG-LRU scan groups the
  recurrence otherwise (``test_torch_rglru.py``).
* each gradient leaf against ``jax.grad``: within 1e-4 of the leaf's max
  |JAX| (1e-3 for the hybrid): the backward sums those rounding
  differences once more over every position.
* after AdamW steps, parameters within ``2 lr`` per step plus 1e-5: the
  first AdamW step moves each weight by lr sign(g) (m_hat / sqrt(v_hat)
  = +-1), so a gradient within rounding of zero may take either sign in
  the two libraries; losses within rtol 1e-4 over the steps.
* ``grad_accum=4`` against ``grad_accum=1``: loss rtol 1e-5, parameters
  within the same lr bound (a sum of four micro-batch gradients against
  one whole-batch gradient).
* remat on and off: bitwise (the same ops recomputed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as JM
from repro.train import trainer as JT
from repro_torch.configs import base as tbase
from repro_torch.interop import model_params_from_numpy, \
    train_state_from_numpy, train_state_to_numpy
from repro_torch.models import model as M
from repro_torch.train import init_train_state, make_serve_step, \
    make_train_step
from strategies import Draw

ARCHS = ["qwen3-8b", "qwen3-14b", "phi3-mini-3.8b", "stablelm-1.6b",
         "moonshot-v1-16b-a3b", "dbrx-132b", "hubert-xlarge",
         "recurrentgemma-2b", "qwen2-vl-2b", "xlstm-350m"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _tols(arch):
    if arch == "recurrentgemma-2b":
        return 1e-4, 1e-3
    return LOSS_RTOL, GRAD_REL


def _mrope_positions(b, grid, n_text):
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    img = np.stack([np.zeros(grid * grid), hh.ravel(), ww.ravel()])
    text = np.broadcast_to(np.arange(n_text) + grid, (3, n_text))
    pos = np.concatenate([img, text], 1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, b, pos.shape[1])))


def _batch(cfg, b, s, seed=0):
    """A training batch for ``cfg``'s family as numpy arrays: frame
    embeddings (audio); 4 patch embeddings, s - 4 tokens and M-RoPE
    positions (vlm); tokens; labels and a mask with a few zeros over the
    whole sequence."""
    draw = Draw(seed)
    rng = draw.rng
    out = {}
    if cfg.family == "audio":
        out["embeddings"] = draw.normal((b, s, cfg.d_model))
    elif cfg.family == "vlm":
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s - 4)).astype(
            np.int32)
        out["embeddings"] = draw.normal((b, 4, cfg.d_model))
        out["mrope_positions"] = _mrope_positions(b, 2, s - 4)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, :2] = 0.0
    out["mask"] = mask
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_state(arch, seed=0):
    jcfg = jbase.reduced_config(arch)
    state, _ = JT.init_train_state(jcfg, jax.random.PRNGKey(seed))
    return jcfg, state


def _named_jax(cfg, tree):
    """The reference's params-shaped tree as the port's named tensors."""
    m = model_params_from_numpy(cfg, jax.tree.map(np.asarray, tree), "cpu")
    return dict(m.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grad_match_jax(arch):
    jcfg, jstate = _jax_state(arch)
    cfg = tbase.reduced_config(arch)
    assert cfg.dtype == "float32"
    np_params = jax.tree.map(np.asarray, jstate.params)
    model = model_params_from_numpy(cfg, np_params, "cpu")
    model.requires_grad_(True)
    batch = _batch(cfg, 2, 16, seed=len(arch))
    (jtotal, jmets), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, _j(batch)), has_aux=True)(
            jstate.params)
    total, mets = M.train_loss(model, _t(batch))
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    loss_rtol, grad_rel = _tols(arch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=loss_rtol)
    assert set(mets) == set(jmets)
    for k in jmets:
        np.testing.assert_allclose(float(mets[k].detach()), float(jmets[k]),
                                   rtol=loss_rtol, atol=1e-7, err_msg=k)
    want = _named_jax(cfg, jgrads)
    for name, g in zip(names, grads):
        w = want[name].detach().numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= grad_rel * float(np.abs(w).max()) + 1e-12, (name, err)


def _lr_atol(lrs):
    return 2.0 * sum(lrs) + 1e-5


def test_three_train_steps_match_jax():
    arch = "stablelm-1.6b"
    jcfg, jstate = _jax_state(arch, seed=1)
    cfg = tbase.reduced_config(arch)
    kw = dict(base_lr=1e-3, warmup=0, total_steps=10, grad_clip=1.0)
    np_state = jax.tree.map(np.asarray, (jstate.params, jstate.opt,
                                         jstate.step))
    state = train_state_from_numpy(cfg, *np_state, device="cpu")
    step = make_train_step(cfg, **kw)
    jstep = jax.jit(JT.make_train_step(jcfg, **kw))
    lrs = []
    for i in range(3):
        batch = _batch(cfg, 2, 16, seed=100 + i)
        state, mets = step(state, _t(batch))
        jstate, jmets = jstep(jstate, _j(batch))
        lrs.append(float(jmets["lr"]))
        for k in ("loss", "grad_norm", "lr", "nll"):
            np.testing.assert_allclose(float(mets[k]), float(jmets[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert int(state.step) == int(jstate.step) == 3
    params, (mu, nu, count), st = train_state_to_numpy(state)
    assert int(count) == 3 and int(st) == 3
    atol = _lr_atol(lrs)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
    # the moments are the gradients' averages: the gradient tolerance
    for got, want in ((mu, jstate.opt.mu), (nu, jstate.opt.nu)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b)
            assert float(np.abs(a - b).max()) <= GRAD_REL * float(
                np.abs(b).max())


def test_grad_accum_4_matches_grad_accum_1_and_jax():
    arch = "qwen3-8b"
    jcfg, jstate = _jax_state(arch, seed=2)
    cfg = tbase.reduced_config(arch)
    kw = dict(base_lr=1e-3, warmup=0, total_steps=10)
    np_state = jax.tree.map(np.asarray, (jstate.params, jstate.opt,
                                         jstate.step))
    batch = _batch(cfg, 8, 16, seed=7)
    batch["mask"][:] = 1.0      # equal masks: the mean of the micro-means
    s1 = train_state_from_numpy(cfg, *np_state, device="cpu")
    s4 = train_state_from_numpy(cfg, *np_state, device="cpu")
    s1, m1 = make_train_step(cfg, **kw)(s1, _t(batch))
    s4, m4 = make_train_step(cfg, grad_accum=4, **kw)(s4, _t(batch))
    jstate, jm = jax.jit(JT.make_train_step(jcfg, grad_accum=4, **kw))(
        jstate, _j(batch))
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m4["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m4["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m4["nll"]), float(jm["nll"]), rtol=1e-5)
    atol = _lr_atol([float(m4["lr"])])
    for (n1, p1), (n4, p4) in zip(s1.model.named_parameters(),
                                  s4.model.named_parameters()):
        np.testing.assert_allclose(p4.detach().numpy(), p1.detach().numpy(),
                                   rtol=0, atol=atol, err_msg=n1)


def test_grad_accum_splits_mrope_positions_on_their_batch_axis():
    arch = "qwen2-vl-2b"
    cfg = tbase.reduced_config(arch)
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    batch = _t(_batch(cfg, 4, 12, seed=3))
    state, mets = make_train_step(cfg, grad_accum=2)(state, batch)
    assert np.isfinite(float(mets["loss"])) and int(state.step) == 1


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "recurrentgemma-2b",
                                  "moonshot-v1-16b-a3b"])
def test_remat_gives_bitwise_equal_grads(arch):
    base = dataclasses.replace(tbase.reduced_config(arch), n_layers=4)
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = M.init_model(cfg, generator=torch.Generator().manual_seed(5),
                             device="cpu")
        model.requires_grad_(True)
        total, _ = M.train_loss(model, _t(_batch(cfg, 2, 16, seed=9)))
        grads.append(torch.autograd.grad(total, list(model.parameters()),
                                         allow_unused=True,
                                         materialize_grads=True))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_serving_forward_records_no_graph():
    cfg = tbase.reduced_config("stablelm-1.6b")
    model = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, _ = M.forward(model, torch.zeros((1, 8), dtype=torch.int32))
    assert not logits.requires_grad and logits.grad_fn is None
    state = M.init_decode_state(cfg, 1, 4, device="cpu")
    out, _ = make_serve_step(cfg)(model, state,
                                  torch.zeros((1, 1), dtype=torch.int32), 0)
    assert out.shape == (1, cfg.vocab) and out.grad_fn is None


def test_forward_records_a_graph_only_where_a_gradient_is_wanted(
        monkeypatch):
    # serving runs its ops with grad mode off (as decode_step does); once
    # the parameters require a gradient, the same call records the graph
    cfg = tbase.reduced_config("xlstm-350m")
    model = M.init_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    seen = []
    norm = M.L.rms_norm

    def spy(*a, **k):
        seen.append(torch.is_grad_enabled())
        return norm(*a, **k)

    monkeypatch.setattr(M.L, "rms_norm", spy)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    served, _ = M.forward(model, toks)
    assert seen and not any(seen) and served.grad_fn is None
    seen.clear()
    model.requires_grad_(True)
    trained, _ = M.forward(model, toks)
    assert seen and all(seen) and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())


def test_train_state_interop_round_trips():
    arch = "recurrentgemma-2b"
    jcfg, jstate = _jax_state(arch, seed=4)
    cfg = tbase.reduced_config(arch)
    np_state = jax.tree.map(np.asarray, (jstate.params, jstate.opt,
                                         jstate.step))
    state = train_state_from_numpy(cfg, *np_state, device="cpu")
    assert all(p.requires_grad for p in state.model.parameters())
    assert set(state.opt.mu) == {n for n, _ in
                                 state.model.named_parameters()}
    params, (mu, nu, count), step = train_state_to_numpy(state)
    for got, want in ((params, np_state[0]), (mu, np_state[1].mu),
                      (nu, np_state[1].nu)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(a, b)
    assert int(count) == int(np_state[1].count) and int(step) == 0


def test_make_train_step_rejects_a_mesh():
    """A mesh that is not the port's ``Mesh`` (the sharded step itself is
    held in ``test_torch_sharded_train.py``)."""
    cfg = tbase.reduced_config("stablelm-1.6b")
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(cfg, mesh=object())
