"""The port's split-K decode attention (``distributed/decode.py``) and
decode under a mesh, against the JAX package on CPU meshes.

The reference's split-K runs on a (2, 4) mesh with MQA (kv = 1, its own
test's shapes) in the shared 8-device subprocess
(``torch_dist_reference``).  Tolerances:

* against JAX's split-K and against the unsharded masked softmax in f32:
  rtol 1e-5, atol 1e-5 (the same f32 exponentials summed in other
  orders);
* the per-shard partials against JAX's ``splitk_partial``: rtol 1e-6;
* ``decode_step`` under ``activation_sharding`` with the caches placed
  by ``decode_state_axes``: bitwise the plain ``decode_step``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_reference as R
from repro.distributed import decode as JD
from repro_torch.configs import base as tbase
from repro_torch.core.compat import make_mesh
from repro_torch.distributed import decode as D
from repro_torch.distributed import sharding as S
from repro_torch.models import model as M

RTOL = ATOL = 1e-5


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.load(tmp_path_factory)


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def _plain(q, ck, cv, pos):
    """The unsharded masked softmax over the whole cache, in f32."""
    b, _, h, dh = q.shape
    hk, s = ck.shape[2], ck.shape[1]
    qg = q.reshape(b, hk, h // hk, dh).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, ck.float()) / dh ** 0.5
    valid = torch.arange(s)[None, :] <= pos[:, None]
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(-1e30))
    w = torch.softmax(logits, -1)
    return torch.einsum("bhgk,bkhd->bhgd", w, cv.float()).reshape(
        b, 1, h, dh)


def test_splitk_matches_jax_and_the_unsharded_softmax(ref):
    q, ck, cv = (torch.from_numpy(ref[f"splitk/{k}"])
                 for k in ("q", "ck", "cv"))
    pos = torch.tensor(R.SPLITK["pos"])
    attn = D.make_splitk_decode_attention(_mesh((2, 4)),
                                          batch_axes=("data",))
    out = attn(q, ck, cv, pos)
    np.testing.assert_allclose(out.numpy(), ref["splitk/out"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out.numpy(), _plain(q, ck, cv, pos).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(out, attn(q, ck, cv, pos))     # no atomic anywhere


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (1, 8)])
def test_splitk_on_gqa_and_ragged_positions(shape):
    g = torch.Generator().manual_seed(sum(shape))
    b, h, hk, s, dh = 4, 8, 2, 32, 16
    q = torch.randn(b, 1, h, dh, generator=g)
    ck, cv = (torch.randn(b, s, hk, dh, generator=g) for _ in range(2))
    pos = torch.tensor([0, 3, 17, 31])     # shards wholly past pos too
    out = D.make_splitk_decode_attention(_mesh(shape), batch_axes=(
        "data",))(q, ck, cv, pos)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), _plain(q, ck, cv, pos).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_splitk_partial_matches_jax():
    g = np.random.default_rng(0)
    q = g.standard_normal((2, 2, 3, 16)).astype(np.float32)
    k, v = (g.standard_normal((2, 8, 2, 16)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(8)[None, :] <= np.array([[2], [9]])
    want = JD.splitk_partial(*(jnp.asarray(a) for a in (q, k, v, valid)))
    got = D.splitk_partial(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_splitk_raises_where_shard_map_would():
    q = torch.zeros(4, 1, 8, 16)
    kv = torch.zeros(4, 30, 2, 16)
    attn = D.make_splitk_decode_attention(_mesh((2, 4)),
                                          batch_axes=("data",))
    with pytest.raises(ValueError, match="sequence"):
        attn(q, kv, kv, torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="not in"):
        D.make_splitk_decode_attention(_mesh((2, 4)))   # no "pod" axis


@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-2b"])
def test_decode_under_a_mesh_is_bitwise_the_plain_decode(arch):
    cfg = tbase.reduced_config(arch)
    model = M.init_model(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    mesh = _mesh((2, 2))
    rules = dict(S.DEFAULT_RULES, kv_seq="model")
    toks = torch.randint(0, cfg.vocab, (4, 1),
                         generator=torch.Generator().manual_seed(2))
    runs = []
    for sharded in (False, True):
        state = M.init_decode_state(cfg, 4, 16, device="cpu")
        tok, out = toks, []
        for i in range(6):
            pos = torch.tensor([i, i + 2, i + 5, i + 7])
            if sharded:
                sh = S.param_sharding(M.decode_state_axes(cfg), mesh, state,
                                      rules)
                for layer, lsh in zip(state, sh):
                    for key, t in layer.items():
                        for p in lsh[key].positions():
                            lsh[key].index(p, t.shape)
                with S.activation_sharding(mesh, rules):
                    logits, state = M.decode_step(model, state, tok, pos)
            else:
                logits, state = M.decode_step(model, state, tok, pos)
            out.append(logits)
            tok = torch.argmax(logits, -1)[:, None]
        runs.append(torch.stack(out))
    assert torch.equal(runs[0], runs[1])
