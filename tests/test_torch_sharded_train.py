"""The port's sharded train step (``jit_train_step``,
``shardings_for_state``), ``restore(..., shardings=)``, the batches'
shardings and the launcher's mesh route, against the JAX package and the
port's own unsharded step, on CPU meshes.

The reference's ``jit_train_step`` runs reduced qwen3-8b on a (4, 2) mesh
for 4 steps in the shared 8-device subprocess (``torch_dist_reference``);
its initial weights cross with ``interop``.  Tolerances:

* losses against JAX: rtol 1e-5 (the f32 logits' tolerance of
  ``test_torch_models.py``, carried over four steps);
* against the port's unsharded ``grad_accum`` step: losses rtol 1e-5 and
  gradients within 1e-5 of each leaf's max (the same per-row terms summed
  in another grouping);
* on a one-shard mesh, and a checkpoint restored across meshes: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_reference as R
from repro_torch.configs import base as tbase
from repro_torch.core.compat import make_mesh
from repro_torch.data import TokenStream, make_lm_batches, synthetic_batch
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as S
from repro_torch.interop import train_state_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.train import trainer as T
from repro_torch.tree import tree_map

T_ = R.TRAIN


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.load(tmp_path_factory)


def _mesh(shape, names=("data", "model"), dev="cpu"):
    return make_mesh(shape, names, devices=[dev] * int(np.prod(shape)))


def _state(ref, cfg):
    params = ref.tree("train/params")
    zeros = tree_map(np.zeros_like, params)
    return train_state_from_numpy(cfg, params, (zeros, zeros, 0), 0,
                                  device="cpu")


def _batch(ref):
    return {k: torch.from_numpy(ref[f"train/batch/{k}"])
            for k in ("tokens", "labels", "mask")}


def _step(cfg, **kw):
    return T.make_train_step(cfg, base_lr=T_["lr"], warmup=1,
                             total_steps=50, **kw)


def test_sharded_step_matches_jax_losses(ref):
    cfg = tbase.reduced_config("qwen3-8b")
    state, batch = _state(ref, cfg), _batch(ref)
    fn = T.jit_train_step(_step(cfg), state, M.param_axes(state.model),
                          batch, _mesh((4, 2)), S.DEFAULT_RULES)
    losses = []
    for _ in range(T_["steps"]):
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref.meta["train_losses"], rtol=1e-5)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("shape,accum", [((4, 2), 1), ((2, 2), 2),
                                         ((2, 1), 4)])
def test_sharded_step_matches_the_grad_accum_step(ref, shape, accum):
    cfg = tbase.reduced_config("qwen3-8b")
    batch = _batch(ref)
    a, b = _state(ref, cfg), _state(ref, cfg)
    sharded = T.jit_train_step(_step(cfg, grad_accum=accum), None, None,
                               None, _mesh(shape))
    plain = _step(cfg, grad_accum=shape[0] * accum)
    l_s, _, g_s = sharded.grads(a, batch)
    l_p, _, g_p = plain.grads(b, batch)
    np.testing.assert_allclose(float(l_s), float(l_p), rtol=1e-5)
    for k in g_p:
        scale = float(g_p[k].abs().max()) or 1.0
        assert float((g_s[k] - g_p[k]).abs().max()) <= 1e-5 * scale, k
    for _ in range(2):
        a, ma = sharded(a, batch)
        b, mb = plain(b, batch)
        np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                                   rtol=1e-5)
    # a repeat merges in the same order: the same bits
    c = _state(ref, cfg)
    l2, _, g2 = sharded.grads(c, batch)
    l1, _, g1 = sharded.grads(_state(ref, cfg), batch)
    assert torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k])
                                       for k in g1)


@pytest.mark.parametrize("accum", [1, 2])
def test_one_shard_mesh_is_bitwise_the_unsharded_step(ref, accum):
    cfg = tbase.reduced_config("qwen3-8b")
    batch = _batch(ref)
    a, b = _state(ref, cfg), _state(ref, cfg)
    sharded = T.make_train_step(cfg, base_lr=T_["lr"], warmup=1,
                                total_steps=50, grad_accum=accum,
                                mesh=_mesh((1, 2)))
    plain = _step(cfg, grad_accum=accum)
    for _ in range(2):
        a, ma = sharded(a, batch)
        b, mb = plain(b, batch)
        assert all(torch.equal(ma[k], mb[k]) for k in mb)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_shard_grads_split_the_batch_as_the_reference():
    cfg = tbase.reduced_config("qwen3-8b")
    state = T.init_train_state(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    batch = synthetic_batch(cfg, 8, 8, generator=torch.Generator()
                            .manual_seed(1))
    fn = T.jit_train_step(_step(cfg, grad_accum=2), None, None, None,
                          _mesh((2, 1)))
    per = fn.shard_grads(state, batch)
    assert len(per) == 2
    # shard s takes rows [4j + 2s, 4j + 2s + 2) of micro-batch j
    one = _step(cfg, grad_accum=2).fold(
        state, [{k: v[r] for k, v in batch.items()}
                for r in (slice(2, 4), slice(6, 8))])
    assert torch.equal(per[1][0], one[0])
    assert all(torch.equal(per[1][2][k], one[2][k]) for k in one[2])


def test_sharded_step_splits_mrope_positions_on_their_batch_axis():
    cfg = tbase.reduced_config("qwen2-vl-2b")
    state = T.init_train_state(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    b, s = 4, 12
    toks = torch.randint(0, cfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(s)[None, None].expand(3, b, s).clone()
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
             "mask": torch.ones(b, s), "mrope_positions": pos}
    fn = T.jit_train_step(_step(cfg), None, None, None, _mesh((2, 2)))
    state, m = fn(state, batch)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="data shards"):
        fn(state, {k: (v[:, :3] if k == "mrope_positions" else v[:3])
                   for k, v in batch.items()})


def test_shardings_for_state_and_a_restore_across_meshes(tmp_path):
    cfg = tbase.reduced_config("moonshot-v1-16b-a3b")
    gen = torch.Generator().manual_seed(0)
    src = T.init_train_state(cfg, generator=gen, device="cpu")
    step = _step(cfg)
    batch = synthetic_batch(cfg, 4, 8, generator=gen)
    src, _ = T.jit_train_step(step, None, None, None, _mesh((2, 2)))(
        src, batch)
    axes = M.param_axes(src.model)
    sh_a = T.shardings_for_state(src, axes, _mesh((2, 2)))
    assert sh_a.opt.mu == sh_a.model and sh_a.opt.nu == sh_a.model
    assert sh_a.step.spec == S.P() and sh_a.opt.count.spec == S.P()
    assert sh_a.model["blocks.0.moe.w_gate"].spec == S.P("model", "data",
                                                         None)
    ckpt.save(str(tmp_path), src, 1)
    dst = T.init_train_state(cfg, generator=gen, device="cpu")
    sh_b = T.shardings_for_state(dst, axes, _mesh((4, 2)))
    out, got = ckpt.restore(str(tmp_path), dst, shardings=sh_b)
    assert out is dst and got == 1
    flat_a, flat_b = ckpt._flatten(src), ckpt._flatten(dst)
    assert set(flat_a) == set(flat_b)
    assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)


def test_jit_train_step_needs_the_model_on_its_data_shards():
    cfg = tbase.reduced_config("qwen3-8b")
    state = T.init_train_state(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    batch = synthetic_batch(cfg, 4, 8, generator=torch.Generator())
    fn = T.jit_train_step(_step(cfg), None, None, None,
                          _mesh((2, 1), dev="meta"))
    with pytest.raises(ValueError, match="model's device"):
        fn(state, batch)


def test_make_lm_batches_takes_the_reference_mesh_and_shardings():
    stream = TokenStream(vocab=100, seq_len=8, batch=4, seed=0)
    mesh = _mesh((2, 2))
    sample = next(iter(stream))
    sh = S.batch_sharding(mesh, sample)
    it = make_lm_batches(stream, mesh, sh)
    got = next(it)
    it.close()
    assert got["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(got["tokens"].numpy(), sample["tokens"])
    bad = S.batch_sharding(_mesh((4, 1)), {"tokens": np.zeros((4, 8))})
    bad = {k: bad["tokens"] for k in sample}
    odd = TokenStream(vocab=100, seq_len=8, batch=6, seed=0)
    with pytest.raises(ValueError, match="split"):
        next(make_lm_batches(odd, mesh, bad))


def test_launch_train_runs_through_the_host_mesh_bitwise(monkeypatch):
    meshes = []
    real = launch_train.jit_train_step

    def spy(step, state, axes, spec, mesh, rules=None):
        meshes.append(mesh)
        return real(step, state, axes, spec, mesh, rules)

    monkeypatch.setattr(launch_train, "jit_train_step", spy)
    kw = dict(steps=3, batch=4, seq=16, profile_data=False, log_every=100,
              device="cpu")
    got = launch_train.train("stablelm-1.6b", **kw)
    assert [m.shape for m in meshes] == [{"data": 1}]
    monkeypatch.setattr(launch_train, "jit_train_step",
                        lambda step, *a, **k: step)
    want = launch_train.train("stablelm-1.6b", **kw)
    assert got == want


def test_launch_train_on_a_host_of_two_cards_trains_on_its_device(
        monkeypatch):
    # the mesh is the one data shard of the model's device, whatever
    # else the host holds: a host mesh of both cards would put a data
    # shard where the model is not
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    meshes = []
    real = launch_train.jit_train_step

    def spy(step, state, axes, spec, mesh, rules=None):
        meshes.append(mesh)
        return real(step, state, axes, spec, mesh, rules)

    monkeypatch.setattr(launch_train, "jit_train_step", spy)
    losses = launch_train.train("stablelm-1.6b", steps=3, batch=4, seq=16,
                                profile_data=False, log_every=100,
                                device="cpu")
    assert [list(m.devices.flat) for m in meshes] == [[torch.device("cpu")]]
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_sharded_moe_a2a_step_runs():
    cfg = dataclasses.replace(tbase.reduced_config("moonshot-v1-16b-a3b"),
                              moe_impl="a2a")
    state = T.init_train_state(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    batch = synthetic_batch(cfg, 4, 16, generator=torch.Generator()
                            .manual_seed(1))
    fn = T.jit_train_step(_step(cfg), None, None, None, _mesh((2, 2)))
    losses = []
    for _ in range(3):
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
        assert 0.0 <= float(m["drop_frac"]) < 1.0
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
