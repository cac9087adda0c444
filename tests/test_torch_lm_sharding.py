"""The port's LM shardings (``distributed/sharding.py``'s LM half, the
model's ``param_axes``/``decode_state_axes``, ``seq_parallel`` and the
a2a MoE inside a forward) against the JAX package, on CPU meshes.

The reference's meshes need real devices, so its outputs come from one
subprocess with 8 forced host devices (``torch_dist_reference``).
Tolerances:

* specs (``to_pspec``, ``param_sharding``, ``batch_sharding``) and
  ``decode_state_axes``: equal.
* forwards on a (2, 2) mesh against JAX's jitted forward under
  ``activation_sharding``: rtol 1e-5, atol 1e-5 in f32 (the same products
  summed in other orders, ``test_torch_models.py``'s tolerance).
* ``seq_parallel`` against the port's own unsharded forward: bitwise
  (``constrain`` returns its tensor).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_reference as R
from repro.configs import base as jbase
from repro.models import model as JM
from repro_torch.configs import base as tbase
from repro_torch.core.compat import make_mesh
from repro_torch.distributed import sharding as S
from repro_torch.interop import _layer_slots, model_params_from_numpy
from repro_torch.models import model as M

ARCHS = list(jbase.ARCHS)
MESHES = [(1, 1), (2, 2), (4, 2)]
RTOL = ATOL = 1e-5


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.load(tmp_path_factory)


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _spec(sh) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def _jax_path(cfg, name: str) -> tuple[str, bool]:
    """The reference's params path of the port's parameter ``name``, and
    whether the reference stacks it over layers."""
    if not name.startswith("blocks."):
        return name, False
    _, i, rest = name.split(".", 2)
    where, j = _layer_slots(cfg)[int(i)]
    rest = rest.replace(".", "/")
    if where == "tail":
        return f"tail/{j}/{rest}", False
    return f"periods/{where}/{rest}", True


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_param_sharding_matches_jax(ref, arch, shape):
    cfg = tbase.reduced_config(arch)
    model = M.Model(cfg, device="cpu")
    got = S.param_sharding(M.param_axes(model), _mesh(shape),
                           dict(model.named_parameters()))
    want = ref.meta["specs"][f"{shape[0]}x{shape[1]}/{arch}"]
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, sh in got.items():
        path, stacked = _jax_path(cfg, name)
        w = want[path]
        if stacked:
            assert w[0] is None, (name, w)
            w = w[1:]
        assert _spec(sh) == w, (name, _spec(sh), w)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_sharding_and_to_pspec_match_jax(ref, shape):
    mesh = _mesh(shape)
    key = f"{shape[0]}x{shape[1]}"
    b = {"tokens": torch.zeros(8, 16), "mask": torch.zeros(8, 16),
         "odd": torch.zeros(3, 16),
         "mrope_positions": torch.zeros(3, 8, 16)}
    lg = {"tokens": ("batch", None), "mask": ("batch", None),
          "odd": ("batch", None), "mrope_positions": (None, "batch", None)}
    for got, want in ((S.batch_sharding(mesh, b), ref.meta["specs"][
            f"{key}/batch"]), (S.batch_sharding(mesh, b, logical_tree=lg),
                               ref.meta["specs"][f"{key}/batch_logical"])):
        assert {k: _spec(v) for k, v in got.items()} == want
    rules = dict(S.DEFAULT_RULES, kv_seq="model")
    got = [[list(e) if isinstance(e, tuple) else e
            for e in S.to_pspec(tuple(lg), mesh, rules)]
           for lg in R.LOGICALS]
    assert got == ref.meta["specs"][f"{key}/to_pspec"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_axes_match_jax(arch):
    cfg = tbase.reduced_config(arch)
    want = JM.decode_state_axes(jbase.reduced_config(arch))
    got = M.decode_state_axes(cfg)
    assert len(got) == cfg.n_layers
    for layer, (where, j) in zip(got, _layer_slots(cfg)):
        if where == "tail":
            w = want["tail"][j]
        else:
            w = {k: v[1:] for k, v in want["periods"][where].items()}
            assert all(v[0] == "layers"
                       for v in want["periods"][where].values())
        assert layer == w
    state = M.init_decode_state(cfg, 2, 8, device="cpu")
    sh = S.param_sharding(got, _mesh((2, 2)), state,
                          dict(S.DEFAULT_RULES, kv_seq="model"))
    assert [set(d) for d in sh] == [set(d) for d in state]


def _forward_case(ref, name):
    _, arch, change = next(f for f in R.FORWARDS if f[0] == name)
    cfg = dataclasses.replace(tbase.reduced_config(arch), **change)
    model = model_params_from_numpy(cfg, ref.tree(f"fwd/{name}/params"),
                                    device="cpu")
    toks = torch.from_numpy(ref[f"fwd/{name}/tokens"]).long()
    return cfg, model, toks


@pytest.mark.parametrize("name", ["seq_dense", "seq_moe"])
def test_seq_parallel_forward_matches_jax_and_is_bitwise_unsharded(
        ref, name):
    cfg, model, toks = _forward_case(ref, name)
    with S.activation_sharding(_mesh((2, 2))):
        logits, aux = M.forward(model, toks)
    np.testing.assert_allclose(logits.numpy(),
                               ref[f"fwd/{name}/logits"], rtol=RTOL,
                               atol=ATOL)
    plain, plain_aux = M.forward(model, toks)
    assert torch.equal(logits, plain)
    for k, v in aux.items():
        assert torch.equal(v, plain_aux[k])
        np.testing.assert_allclose(v.numpy(), ref[f"fwd/{name}/aux/{k}"],
                                   rtol=RTOL, atol=ATOL)


def test_a2a_forward_matches_jax(ref):
    cfg, model, toks = _forward_case(ref, "a2a")
    with S.activation_sharding(_mesh((2, 2))):
        logits, aux = M.forward(model, toks)
    np.testing.assert_allclose(logits.numpy(), ref["fwd/a2a/logits"],
                               rtol=RTOL, atol=ATOL)
    for k in ("aux_loss", "drop_frac"):
        np.testing.assert_allclose(aux[k].numpy(), ref[f"fwd/a2a/aux/{k}"],
                                   rtol=RTOL, atol=ATOL)
    assert float(aux["drop_frac"]) > 0.0            # the capacity drops
    # without a mesh the a2a config runs the gather MoE
    gathered, _ = M.forward(model, toks)
    assert not torch.equal(gathered, logits)


def test_constrain_checks_rank_and_returns_its_tensor():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert S.constrain(x, ("batch", "tensor", None, None)) is x  # no mesh
    with S.activation_sharding(_mesh((2, 2))):
        assert S.constrain(x, ("batch", "tensor", None)) is x
        with pytest.raises(ValueError, match="rank"):
            S.constrain(x, ("batch", "tensor", None, None))
        assert S.get_active()[0].shape == {"data": 2, "model": 2}
    assert S.get_active() is None
    with pytest.raises(TypeError, match="Mesh"):
        with S.activation_sharding(object()):
            pass


def test_named_sharding_slices_cover_each_element_once():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    sh = S.NamedSharding(mesh, S.P(("pod", "data"), None, "model"))
    t = torch.zeros(8, 3, 4)
    for pos in sh.positions():
        t[sh.index(pos, t.shape)] += 1.0
    # the spec names every mesh axis: each element has one owner
    assert torch.equal(t, torch.ones_like(t))
    assert sh.index((1, 0, 1), t.shape) == (slice(4, 6), slice(0, 3),
                                            slice(2, 4))
    rep = S.NamedSharding(mesh, S.P("data"))
    u = torch.zeros(4)
    for pos in rep.positions():
        u[rep.index(pos, u.shape)] += 1.0
    assert torch.equal(u, torch.full((4,), 4.0))   # replicated over 4
    with pytest.raises(ValueError, match="split"):
        sh.index((0, 0, 0), (6, 3, 4))
    with pytest.raises(ValueError, match="not in"):
        S.NamedSharding(mesh, S.P("expert"))


def test_named_sharding_check_wants_its_slices_on_the_first_device():
    mesh = make_mesh((2, 2), ("data", "model"),
                     devices=["cpu", "meta", "meta", "meta"])
    sh = S.NamedSharding(mesh, S.P("data", "model"))
    sh.check((4, 6))                       # no device: the shape alone
    sh.check((4, 6), torch.device("cpu"), "t")
    with pytest.raises(ValueError, match="split"):
        sh.check((4, 5), "cpu")
    with pytest.raises(ValueError, match="t: on meta"):
        sh.check((4, 6), "meta", "t")


def test_param_sharding_gives_a_mesh_axis_to_one_dim_only():
    cfg = tbase.reduced_config("moonshot-v1-16b-a3b")
    model = M.Model(cfg, device="cpu")
    sh = S.param_sharding(M.param_axes(model), _mesh((2, 2)),
                          dict(model.named_parameters()))
    assert sh["blocks.0.moe.w_gate"].spec == S.P("model", "data", None)
    assert sh["blocks.0.moe.w_down"].spec == S.P("model", None, "data")
    # a dimension that does not divide its 4-way axis falls back
    odd = {"w": torch.zeros(10, 6)}
    got = S.param_sharding({"w": ("tensor", "fsdp")}, _mesh((2, 4)), odd)
    assert got["w"].spec == S.P(None, "data")


@pytest.mark.parametrize("axes,ndim", [(("data",), 1), (("data",), 3),
                                       (("pod", "data"), 2), ((), 2)])
def test_row_pspec_matches_jax(axes, ndim):
    from repro.distributed.sharding import row_pspec as j_row_pspec
    got = [list(e) if isinstance(e, tuple) else e
           for e in S.row_pspec(axes, ndim)]
    want = [list(e) if isinstance(e, tuple) else e
            for e in tuple(j_row_pspec(axes, ndim))]
    assert got == want
