"""The JAX package's distributed outputs, computed once per test run.

The reference needs real devices for its meshes, so one subprocess with
8 forced host CPU devices (``JAX_PLATFORMS=cpu XLA_FLAGS=
--xla_force_host_platform_device_count=8``, as ``test_multidevice.py``
runs) computes every output the port's distribution tests hold
themselves against and writes them to one ``.npz`` (arrays) and one
``.json`` (specs, losses).  Workers of one run share the files through
the run's base temporary directory, under a file lock, so the suite pays
one JAX start-up.  Inputs are numpy draws from fixed seeds or JAX's own
initialisers (weights cross with ``interop``).
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# shapes shared by the script and the tests
A2A_X = (4, 64, 64)            # (B, S, d) into one MoE layer, (2, 2) mesh
A2A_CF = 0.5                   # a capacity that drops
FWD_TOKENS = (4, 64)           # the (2, 2) mesh forwards
SPLITK = dict(b=4, h=8, hk=1, s=64, dh=32, pos=[5, 20, 40, 63])
PIPE = dict(stages=4, micro=8, mb=2, d=16)
TRAIN = dict(batch=8, seq=16, steps=4, lr=1e-2)

SCRIPT = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import dataclasses
from repro.configs import ARCHS, reduced_config
from repro.core.compat import make_mesh, shard_map
from repro.distributed.sharding import (DEFAULT_RULES, activation_sharding,
    batch_sharding, param_sharding, to_pspec)
from repro.models import model as JM

C = json.loads(sys.argv[2])
out_npz, out_json = {}, {}

def put_tree(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put_tree(f"{prefix}/{k}", v)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            put_tree(f"{prefix}/#{i}", v)
    else:
        out_npz[prefix] = np.asarray(tree)

def spec(sh):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(sh.spec)]

def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, NamedSharding))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): spec(leaf) for path, leaf in flat}

# -- specs ------------------------------------------------------------------
specs = {}
inits = {arch: JM.init_model(reduced_config(arch), jax.random.PRNGKey(0))
         for arch in ARCHS}
for mshape in ((1, 1), (2, 2), (4, 2)):
    mesh = make_mesh(mshape, ("data", "model"),
                     devices=jax.devices()[:mshape[0] * mshape[1]])
    key = f"{mshape[0]}x{mshape[1]}"
    for arch, (params, axes) in inits.items():
        specs[f"{key}/{arch}"] = paths(param_sharding(axes, mesh, params))
    b = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
         "mask": jax.ShapeDtypeStruct((8, 16), jnp.float32),
         "odd": jax.ShapeDtypeStruct((3, 16), jnp.float32),
         "mrope_positions": jax.ShapeDtypeStruct((3, 8, 16), jnp.int32)}
    lg = {"tokens": ("batch", None), "mask": ("batch", None),
          "odd": ("batch", None), "mrope_positions": (None, "batch", None)}
    specs[f"{key}/batch"] = paths(batch_sharding(mesh, b))
    specs[f"{key}/batch_logical"] = paths(batch_sharding(mesh, b,
                                                         logical_tree=lg))
    rules = dict(DEFAULT_RULES, kv_seq="model")
    specs[f"{key}/to_pspec"] = [
        [list(e) if isinstance(e, tuple) else e
         for e in tuple(to_pspec(tuple(lg), mesh, rules))]
        for lg in C["logicals"]]
out_json["specs"] = specs

# -- forwards on (2, 2): seq_parallel and the a2a MoE -----------------------
mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
rng = np.random.default_rng(7)
for name, arch, change in C["forwards"]:
    cfg = dataclasses.replace(reduced_config(arch), **change)
    params, _ = JM.init_model(cfg, jax.random.PRNGKey(3))
    toks = rng.integers(0, cfg.vocab, C["fwd_tokens"]).astype(np.int32)
    def fwd(p, t):
        with activation_sharding(mesh):
            return JM.forward(p, cfg, t)
    logits, aux = jax.jit(fwd)(params, toks)
    put_tree(f"fwd/{name}/params", params)
    out_npz[f"fwd/{name}/tokens"] = toks
    out_npz[f"fwd/{name}/logits"] = np.asarray(logits)
    for k, v in aux.items():
        out_npz[f"fwd/{name}/aux/{k}"] = np.asarray(v)

# one a2a MoE layer, straight through make_run_moe_a2a
from repro.distributed.ep_a2a import make_run_moe_a2a
cfg = dataclasses.replace(reduced_config("moonshot-v1-16b-a3b"),
                          capacity_factor=C["a2a_cf"])
params, _ = JM.init_model(cfg, jax.random.PRNGKey(5))
p = jax.tree.map(lambda a: a[0], params["periods"]["0"]["moe"])
x = rng.standard_normal(C["a2a_x"]).astype(np.float32)
fn = make_run_moe_a2a(mesh, cfg, batch_axes=("data",))
xs = jax.device_put(x, NamedSharding(mesh, P("data", "model", None)))
o, aux = jax.jit(fn)(p, xs)
put_tree("a2a/p", p)
out_npz["a2a/x"] = x
out_npz["a2a/out"] = np.asarray(o)
out_npz["a2a/aux_loss"] = np.asarray(aux["aux_loss"])
out_npz["a2a/drop_frac"] = np.asarray(aux["drop_frac"])

# -- split-K on (2, 4), MQA ---------------------------------------------------
from repro.distributed.decode import make_splitk_decode_attention
S = C["splitk"]
mesh24 = make_mesh((2, 4), ("data", "model"))
k0 = jax.random.PRNGKey(0)
q = jax.random.normal(k0, (S["b"], 1, S["h"], S["dh"]))
ck = jax.random.normal(jax.random.fold_in(k0, 1),
                       (S["b"], S["s"], S["hk"], S["dh"]))
cv = jax.random.normal(jax.random.fold_in(k0, 2),
                       (S["b"], S["s"], S["hk"], S["dh"]))
pos = jnp.array(S["pos"], jnp.int32)
attn = make_splitk_decode_attention(mesh24, batch_axes=("data",))
sh = NamedSharding(mesh24, P("data", "model", None, None))
o = attn(q, jax.device_put(ck, sh), jax.device_put(cv, sh), pos)
for k, v in dict(q=q, ck=ck, cv=cv, out=o).items():
    out_npz[f"splitk/{k}"] = np.asarray(v)

# -- GPipe over pod = 4 -------------------------------------------------------
from repro.distributed.pipeline import make_pipeline
G = C["pipe"]
mesh42 = make_mesh((4, 2), ("pod", "model"))
ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                  (G["stages"], G["d"], G["d"]))) * 0.3
bs = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                  (G["stages"], G["d"]))) * 0.1
x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                 (G["micro"], G["mb"], G["d"])))
def stage_fn(p, a):
    return a + jnp.tanh(a @ p["w"] + p["b"])
pipe = make_pipeline(mesh42, stage_fn, stage_axis="pod")
o = jax.jit(pipe)({"w": ws, "b": bs}, x)
for k, v in dict(w=ws, b=bs, x=x, out=o).items():
    out_npz[f"pipe/{k}"] = np.asarray(v)

# -- compressed_psum over pod = 8 -------------------------------------------
from repro.distributed.compression import compressed_psum
mesh8 = make_mesh((8,), ("pod",))
kg = jax.random.PRNGKey(0)
g = {"b": jax.random.normal(jax.random.fold_in(kg, 1), (8, 16)) * 3.0,
     "w": jax.random.normal(kg, (8, 1024))}
e = {"b": jax.random.normal(jax.random.fold_in(kg, 2), (8, 16)) * 0.01,
     "w": jax.random.normal(jax.random.fold_in(kg, 3), (8, 1024)) * 0.01}
key = jax.random.PRNGKey(1)
def body(g_s, e_s, key):
    gg = jax.tree.map(lambda a: a[0], g_s)
    ee = jax.tree.map(lambda a: a[0], e_s)
    o, ne = compressed_psum(gg, ee, key, "pod")
    return (jax.tree.map(lambda a: a[None], o),
            jax.tree.map(lambda a: a[None], ne))
fn = jax.jit(shard_map(body, mesh=mesh8, in_specs=(P("pod"), P("pod"), P()),
                       out_specs=(P("pod"), P("pod")), check_vma=False))
o, ne = fn(g, e, key)
leaves, treedef = jax.tree_util.tree_flatten(g)
keys = jax.random.split(key, len(leaves))
names = sorted(g)
for name, k in zip(names, keys):
    out_npz[f"psum/u/{name}"] = np.asarray(
        jax.random.uniform(k, g[name].shape[1:]))
for name in names:
    out_npz[f"psum/g/{name}"] = np.asarray(g[name])
    out_npz[f"psum/e/{name}"] = np.asarray(e[name])
    out_npz[f"psum/out/{name}"] = np.asarray(o[name])
    out_npz[f"psum/new_e/{name}"] = np.asarray(ne[name])

# -- the sharded train step on (4, 2) ---------------------------------------
from repro.data import synthetic_batch
from repro.train.trainer import (init_train_state, jit_train_step,
                                 make_train_step)
T = C["train"]
cfg = reduced_config("qwen3-8b")
state, axes = init_train_state(cfg, jax.random.PRNGKey(0))
put_tree("train/params", state.params)
step = make_train_step(cfg, base_lr=T["lr"], warmup=1, total_steps=50)
batch = synthetic_batch(cfg, T["batch"], T["seq"], jax.random.PRNGKey(1))
for k, v in batch.items():
    out_npz[f"train/batch/{k}"] = np.asarray(v)
spec_ = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
fn = jit_train_step(step, state, axes, spec_,
                    make_mesh((4, 2), ("data", "model")), DEFAULT_RULES)
losses = []
for _ in range(T["steps"]):
    state, m = fn(state, batch)
    losses.append(float(m["loss"]))
out_json["train_losses"] = losses

np.savez(sys.argv[1] + ".npz", **out_npz)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(out_json, f)
'''

LOGICALS = [("batch", "tensor", None), ("batch", None, "vocab"),
            ("fsdp", "expert"), ("layers", "kv_seq"), ("batch", "kv_seq",
                                                       None, None),
            ("vocab", "fsdp"), (None, "batch", None), ("expert", "tensor")]
FORWARDS = [("seq_dense", "qwen3-8b", {"seq_parallel": True}),
            ("seq_moe", "moonshot-v1-16b-a3b", {"seq_parallel": True}),
            ("a2a", "moonshot-v1-16b-a3b",
             {"moe_impl": "a2a", "capacity_factor": A2A_CF})]


def _config() -> dict:
    return {"logicals": LOGICALS, "forwards": FORWARDS,
            "fwd_tokens": FWD_TOKENS, "a2a_cf": A2A_CF, "a2a_x": A2A_X,
            "splitk": SPLITK, "pipe": PIPE, "train": TRAIN}


class Reference:
    """The reference's outputs: ``arrays`` (the npz by key), ``meta``
    (the json), and :meth:`tree` to rebuild a nested tree saved under a
    prefix."""

    def __init__(self, base: str):
        with np.load(base + ".npz") as z:
            self.arrays = {k: z[k] for k in z.files}
        with open(base + ".json") as f:
            self.meta = json.load(f)

    def __getitem__(self, key: str) -> np.ndarray:
        return self.arrays[key]

    def tree(self, prefix: str):
        out: dict = {}
        for k, v in self.arrays.items():
            if not k.startswith(prefix + "/"):
                continue
            node = out
            parts = k[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
        return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("#") for k in node):
        return [_lists(node[f"#{i}"]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def load(tmp_path_factory) -> Reference:
    """Run the script once for the whole run (shared by xdist workers
    through the run's base temporary directory) and load its output."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    base = str(root / "jax_dist_reference")
    with open(base + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(base + ".json"):
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=8",
                       PYTHONPATH=os.path.join(ROOT, "src"))
            r = subprocess.run(
                [sys.executable, "-c", textwrap.dedent(SCRIPT), base,
                 json.dumps(_config())],
                capture_output=True, text=True, timeout=600, env=env,
                cwd=ROOT)
            assert r.returncode == 0, (f"stdout:\n{r.stdout}\nstderr:\n"
                                       f"{r.stderr}")
    return Reference(base)
