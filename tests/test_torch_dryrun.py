"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

The reference's numbers come from one subprocess that imports
``repro.launch.dryrun`` (so 512 forced host devices), computed once per
module:

* full width, no compile: for every supported cell on both production
  meshes, the sum over the step's arguments of JAX's
  ``NamedSharding.shard_shape`` sizes (``_abstract_state`` or
  ``_abstract_params``, the inputs, the decode cache): the port's
  per-device ``argument_bytes`` must equal it exactly;
* reduced configs on (8, 1) and (2, 4) meshes of the first 8 devices:
  the compiled ``memory_analysis().argument_size_in_bytes``, exactly
  (XLA drops arguments that the step never reads: the prefill's labels
  and mask, which the port's prefill cell leaves out too, and hubert's
  token embedding in a prefill from frame embeddings, which the port's
  model holds and the test adds back);
* ``model_flops`` of every cell, exactly.

The closed-form collectives are held to a hand count on a two-leaf toy
model, and the CLI to the JAX numbers on one cell.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import cells, reduced_config
from repro_torch.core.compat import make_mesh
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              param_sharding)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.op_analysis import OpCounter, analyze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(arch, shape) for arch, shape, _, _ in cells()]
MESHES = [False, True]
REDUCED = [("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"),
           ("qwen3-8b", "decode_32k"), ("moonshot-v1-16b-a3b", "train_4k"),
           ("recurrentgemma-2b", "decode_32k"),
           ("hubert-xlarge", "prefill_32k"), ("qwen2-vl-2b", "train_4k"),
           ("xlstm-350m", "train_4k")]
SMALL_MESHES = [(8, 1), (2, 4)]
# parameters that a reduced cell's step never reads: hubert's prefill runs
# on frame embeddings, not on its token embedding
UNREAD = {("hubert-xlarge", "prefill_32k"): ("embed",)}

SCRIPT = r'''
import json, math, sys
import jax
import repro.launch.dryrun as D
from repro.configs import cells, reduced_config
from repro.core.compat import make_mesh
from repro.launch.mesh import make_production_mesh

C = json.loads(sys.argv[2])


def per_device(tree):
    return sum(math.prod(a.sharding.shard_shape(a.shape)) * a.dtype.itemsize
               for a in jax.tree.leaves(tree))


def cell(arch, shape, mesh):
    kind = D.step_kind(shape)
    if kind == "train":
        return D.abstract_train_cell(arch, shape, mesh)
    fn, args, cfg = D.abstract_serve_cell(arch, shape, mesh,
                                          prefill=kind == "prefill")
    if kind == "prefill":    # the arguments the prefill reads
        args = (args[0], {k: v for k, v in args[1].items()
                          if k not in ("labels", "mask")})
    return fn, args, cfg


out = {"full": {}, "model_flops": {}, "reduced": {}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch, shape, _, _ in cells():
        fn, args, cfg = cell(arch, shape, mesh)
        out["full"][f"{arch}/{shape}/{mp}"] = per_device(args)
        out["model_flops"][f"{arch}/{shape}"] = D.model_flops(cfg, shape)
D.get_config = reduced_config
for shp in C["meshes"]:
    mesh = make_mesh(tuple(shp), ("data", "model"),
                     devices=jax.devices()[:8])
    for arch, shape in C["reduced"]:
        fn, args, cfg = cell(arch, shape, mesh)
        mem = fn.lower(*args).compile().memory_analysis()
        out["reduced"][f"{arch}/{shape}/{shp[0]}x{shp[1]}"] = \
            mem.argument_size_in_bytes
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "jax_dryrun.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(SCRIPT), path,
         json.dumps({"meshes": SMALL_MESHES, "reduced": REDUCED})],
        capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(path) as f:
        return json.load(f)


def _argument_bytes(cell, mesh) -> int:
    return int(D.position_bytes(cell.inputs(mesh), mesh).max())


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_full_width_match_jax(jax_ref, arch, shape,
                                             multi_pod):
    cell = D.abstract_cell(arch, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert _argument_bytes(cell, mesh) == \
        jax_ref["full"][f"{arch}/{shape}/{multi_pod}"]


@pytest.mark.parametrize("mshape", SMALL_MESHES)
@pytest.mark.parametrize("arch,shape", REDUCED)
def test_argument_bytes_reduced_match_compiled(jax_ref, arch, shape,
                                               mshape):
    cfg = reduced_config(arch)
    if cfg.is_moe and shape != "train_4k":
        cfg = dataclasses.replace(cfg, moe_token_chunk=D.MOE_PREFILL_CHUNK)
    cell = D.abstract_cell(arch, shape, cfg=cfg)
    mesh = make_mesh(mshape, ("data", "model"), devices=["meta"] * 8)
    want = jax_ref["reduced"][f"{arch}/{shape}/{mshape[0]}x{mshape[1]}"]
    for name in UNREAD.get((arch, shape), ()):
        # a parameter the step never reads: the port's cell holds it, XLA
        # drops it from the compiled arguments
        want += int(D.position_bytes(
            [pair for pair, key in zip(cell.inputs(mesh), _input_names(cell))
             if key == name], mesh).max())
    assert _argument_bytes(cell, mesh) == want


def _input_names(cell) -> list[str]:
    """The names of :meth:`Cell.inputs`' leaves, for a serve cell."""
    return list(dict(cell.model.named_parameters())) + list(cell.data)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_jax(jax_ref, arch, shape):
    assert D.model_flops(D.cell_config(arch, shape), shape) == \
        jax_ref["model_flops"][f"{arch}/{shape}"]


def test_cli_writes_both_meshes_with_jax_argument_bytes(jax_ref, tmp_path):
    arch, shape = "qwen3-8b", "decode_32k"
    assert D.main(["--arch", arch, "--shape", shape, "--both", "--out",
                   str(tmp_path)]) == 0
    for mp in MESHES:
        res = json.loads((tmp_path / f"{arch}__{shape}__"
                          f"{D.mesh_name(mp)}.json").read_text())
        assert res["memory"]["argument_bytes"] == \
            jax_ref["full"][f"{arch}/{shape}/{mp}"]
        assert res["n_chips"] == (512 if mp else 256)
        assert res["fits"] == (res["memory"]["argument_bytes"]
                               + res["memory"]["temp_bytes"] <= HBM_BYTES)
        roof = res["roofline"]
        assert roof["compute_s"] == res["hlo_flops"] / PEAK_FLOPS_BF16
        assert roof["collective_s"] == \
            res["collectives"]["total_wire_bytes"] / LINK_BW
        assert roof["dominant"] == max(
            ("compute_s", "memory_s", "collective_s"), key=roof.get)
        assert any(k.startswith("tagscan_layers_dec")
                   for k in res["scan_registry"])


def test_train_trace_scales_one_micro_batch_by_the_trip_count():
    """The dry run traces one micro-batch of ``grad_accum`` and scales it:
    its counts equal those of the step run in full on meta, and it
    registers the reference's ``tagscan_grad_accum`` trip count."""
    cfg = reduced_config("qwen3-8b")
    cell = D.abstract_cell("qwen3-8b", "train_4k", cfg=cfg, batch=8, seq=16,
                           grad_accum=4)
    counts, _ = D.trace(cell)
    assert counts["registry"]["tagscan_grad_accum_L4"] == 4
    full = D.abstract_cell("qwen3-8b", "train_4k", cfg=cfg, batch=8,
                           seq=16, grad_accum=4)
    step = D.make_train_step(cfg, grad_accum=4)
    with OpCounter() as c:
        step(full.state, full.data)
    want = analyze(c, {})
    assert counts["dot_flops"] == want["dot_flops"] > 0
    assert counts["kernels"] == want["kernels"]
    # four micro-batches of two attention layers, no remat
    assert counts["kernels"]["flash_attention"]["calls"] == 4 * 2


def test_closed_form_collectives_of_a_two_leaf_model_by_hand():
    """Leaf w (64, 32) f32 split over data (2) and model (4); leaf b (32,)
    replicated.  One micro-batch of a remat'd train step on a (2, 2, 4)
    mesh: w is all-gathered twice (8192 bytes out each) and
    reduce-scattered once (8192 in), and its gradient all-reduced over
    pod, the batch axis its spec lacks (8192 / 8 = 1024 bytes, 2048 on
    the wire); b is only all-reduced over pod and data (128 bytes)."""
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"),
                     devices=["meta"] * 16)
    params = {"w": torch.empty((64, 32), device="meta"),
              "b": torch.empty((32,), device="meta")}
    sh = param_sharding({"w": ("fsdp", "tensor"), "b": (None,)}, mesh,
                        params)
    assert sh["w"].spec == P("data", "model") and sh["b"].spec == P(None)
    c = OpCounter()
    D.param_collectives(c, params, sh, mesh, kind="train", remat=True,
                        grad_accum=3)
    res = analyze(c, {})
    assert res["collective_raw_bytes"] == {
        "all-gather": 3 * 2 * 8192.0, "reduce-scatter": 3 * 8192.0,
        "all-reduce": 3 * (1024.0 + 128.0)}
    assert res["collective_wire_bytes"]["all-reduce"] == 3 * 2 * 1152.0
    serve = OpCounter()
    D.param_collectives(serve, params, sh, mesh, kind="prefill",
                        remat=True)
    assert analyze(serve, {})["collective_raw_bytes"] == {
        "all-gather": 8192.0}


def test_position_bytes_by_hand():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    w = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    s = torch.empty((), dtype=torch.int32, device="meta")
    got = D.position_bytes([(w, NamedSharding(mesh, P("data", None))),
                            (w, NamedSharding(mesh, P("data", "model"))),
                            (s, NamedSharding(mesh, P()))], mesh)
    assert got.tolist() == [4 * 6 * 2 + 4 * 3 * 2 + 4] * 4
