"""Multi-pod dry run on the ``meta`` device: does a cell fit on H100s of
80 GB at 256 or 512 positions, and where is its roofline?

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch dbrx-132b --shape \
        prefill_32k --multi-pod
    python -m repro_torch.launch.dryrun --all          # every cell, both

The port's counterpart of the reference ``launch/dryrun.py``.  The
reference forces 512 host devices, lowers and compiles each (arch x
shape x mesh) cell and reads XLA's memory and cost analyses.  Eager
PyTorch has no compiled program; the port builds each cell on ``meta``
tensors (shapes and dtypes, nothing allocated, no card needed) and reads
the same quantities from the cell itself:

* ``argument_bytes``: per mesh position, the sum over the step's inputs
  (the train state or the parameters, the decode cache and the batch) of
  the slice that its ``NamedSharding`` gives that position
  (``shardings_for_state``, ``param_sharding`` and ``batch_sharding``;
  the decode cache under ``kv_seq="model"``); the maximum over positions;
* the step, run once on meta under :class:`~.op_analysis.OpCounter` with
  the reference's ``GRAD_ACCUM = 8`` and ``MOE_PREFILL_CHUNK = 16384``:
  one micro-batch is traced and scaled by the registered
  ``tagscan_grad_accum`` trip count, rather than eight identical ones
  run.  The global counts do not depend on the mesh, so one trace serves
  both meshes;
* per-device flops and bytes: the global counts over the positions,
  which assumes the work splits evenly;
* ``temp_bytes``: an estimate, the step's peak of live storage over the
  positions that the batch splits over;
* collectives: the closed form that the parameter shardings imply
  (:func:`param_collectives`).  The tensor-parallel activation
  collectives over ``"model"`` are not counted: the port has no
  partitioner that would insert them (a gap against the reference,
  recorded in ROADMAP);
* ``model_flops``: the reference's 6·N·D for training and 2·N·D for
  serving, unchanged.

The result JSON keeps ``run_cell``'s schema where a key means the same
thing (``hlo_flops`` and ``hlo_bytes_accessed`` are the op counter's
per-device counts; there is no raw ``cost_analysis`` count and no
``collectives_naive``), with the roofline against the H100 constants of
:mod:`.mesh`, ``trace_s`` in place of the lowering and compile times, and
``fits``: argument plus temp bytes within ``HBM_BYTES``.  Results go to
``build/dryrun/<arch>__<shape>__<mesh>.json``; ``--all`` runs each cell
in a subprocess, as the reference does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import cells, get_config, input_specs, step_kind
from ..configs.base import SHAPES, input_batch_axes
from ..core.compat import make_mesh
from ..distributed.sharding import (DEFAULT_RULES, NamedSharding, P,
                                    _names, activation_sharding,
                                    axes_in_mesh, batch_sharding,
                                    param_sharding)
from ..models import model as M
from ..optim import adamw_init
from ..train.trainer import (TrainState, make_train_step,
                             shardings_for_state)
from ..tree import tree_leaves
from .mesh import (HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16,
                   make_production_mesh)
from .op_analysis import OpCounter, analyze
from .scan_registry import clear_registry, get_registry

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

GRAD_ACCUM = 8               # micro-batch fold depth of the train cells
MOE_PREFILL_CHUNK = 16384    # MoE token chunks of the serve cells
DECODE_RULES = dict(DEFAULT_RULES, kv_seq="model")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_config(arch: str, shape: str, overrides: dict | None = None):
    """The cell's config: a serve cell of an MoE streams its tokens
    through the experts in chunks, as the reference's serve cells do."""
    cfg = get_config(arch)
    if step_kind(shape) != "train" and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_token_chunk=MOE_PREFILL_CHUNK)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def meta_batch(specs: dict) -> dict:
    return {k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in specs.items()}


def decode_inputs(batch: int) -> dict:
    """One new token per sequence and one shared position (the
    reference's synchronized batch decode)."""
    return {"token": torch.empty((batch, 1), dtype=torch.int32,
                                 device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


# ---------------------------------------------------------------------------
# Abstract cells
# ---------------------------------------------------------------------------

def abstract_train_state(cfg) -> TrainState:
    """A :class:`TrainState` on meta: the model (``init_model`` would draw
    values, which meta tensors do not hold), gradients on, zero AdamW
    moments and step 0."""
    model = M.Model(cfg, "meta")
    model.requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters())),
                      torch.zeros((), dtype=torch.int32, device="meta"))


@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell on meta: its config and kind, the step's
    inputs as (tensor, sharding) pairs over a mesh (:meth:`inputs`), and
    the step (:meth:`run`)."""

    arch: str
    shape: str
    cfg: object
    kind: str
    batch: int
    seq: int
    model: M.Model
    state: TrainState | None
    data: dict
    cache: list | None
    grad_accum: int = GRAD_ACCUM

    def inputs(self, mesh) -> list[tuple[torch.Tensor, NamedSharding]]:
        """Every input leaf of the step with its sharding on ``mesh``."""
        out = []
        if self.kind == "train":
            axes = M.param_axes(self.model)
            sh = shardings_for_state(self.state, axes, mesh)
            st = dataclasses.replace(self.state, model=self.state.params())
            out += list(zip(tree_leaves(st), tree_leaves(sh)))
        else:
            params = dict(self.model.named_parameters())
            sh = param_sharding(M.param_axes(self.model), mesh, params)
            out += [(params[k], sh[k]) for k in params]
        if self.kind == "decode":
            cache_sh = param_sharding(M.decode_state_axes(self.cfg), mesh,
                                      self.cache, DECODE_RULES)
            out += list(zip(tree_leaves(self.cache), tree_leaves(cache_sh)))
            tok = batch_sharding(mesh, self.data["token"])
            out += [(self.data["token"], tok),
                    (self.data["pos"], NamedSharding(mesh, P()))]
        else:
            logical = input_batch_axes(self.arch, self.shape, self.cfg)
            sh = batch_sharding(mesh, self.data, logical_tree={
                k: logical[k] for k in self.data})
            out += [(self.data[k], sh[k]) for k in self.data]
        return out

    def batch_positions(self, mesh) -> int:
        """The positions that the batch splits over (1 where the batch
        does not divide the batch axes and stays replicated)."""
        lead = self.data["token"] if self.kind == "decode" \
            else next(iter(self.data.values()))
        logical = ("batch",) + (None,) * (lead.dim() - 1)
        spec = batch_sharding(mesh, {"x": lead},
                              logical_tree={"x": logical})["x"].spec
        names = _names(spec[0]) if spec else ()
        return math.prod(mesh.shape[a] for a in names)

    def run(self, counter: OpCounter, mesh=None):
        """The step once, on meta, under ``counter`` (and the mesh's
        activation shardings where one is given)."""
        rules = DECODE_RULES if self.kind == "decode" else DEFAULT_RULES
        with (activation_sharding(mesh, rules) if mesh is not None
              else contextlib.nullcontext()):
            if self.kind == "train":
                return train_trace(self.cfg, self.state, self.data,
                                   self.grad_accum, counter)
            if self.kind == "prefill":
                return M.forward(self.model, self.data.get("tokens"),
                                 embeddings=self.data.get("embeddings"),
                                 mrope_positions=self.data.get(
                                     "mrope_positions"))
            return M.decode_step(self.model, self.cache, self.data["token"],
                                 self.data["pos"])


def abstract_cell(arch: str, shape: str, overrides: dict | None = None,
                  *, cfg=None, batch: int | None = None,
                  seq: int | None = None,
                  grad_accum: int = GRAD_ACCUM) -> Cell:
    """Cell ``arch`` x ``shape`` on meta (``cfg``, ``batch`` and ``seq``
    replace the cell's where given); nothing is allocated.  A prefill
    takes the inputs that the forward reads (XLA drops the reference's
    unread labels and mask from its arguments)."""
    cfg = cfg or cell_config(arch, shape, overrides)
    kind = step_kind(shape)
    b = SHAPES[shape]["batch"] if batch is None else batch
    s = SHAPES[shape]["seq"] if seq is None else seq
    state = abstract_train_state(cfg) if kind == "train" else None
    model = state.model if state is not None else M.Model(cfg, "meta")
    cache = None
    if kind == "decode":
        data = decode_inputs(b)
        cache = M.init_decode_state(cfg, b, s, device="meta")
    else:
        specs = input_specs(arch, shape, cfg, batch=b, seq=s)
        if kind == "prefill":
            specs = {k: v for k, v in specs.items()
                     if k not in ("labels", "mask")}
        data = meta_batch(specs)
    return Cell(arch, shape, cfg, kind, b, s, model, state, data, cache,
                grad_accum)


def train_trace(cfg, state: TrainState, batch: dict, grad_accum: int,
                counter: OpCounter):
    """``make_train_step(cfg, grad_accum=...)``'s step, its fold traced
    over the first micro-batch and counted ``grad_accum`` times
    (``counter.repeat``) inside the ``tagscan_grad_accum`` scope."""
    return make_train_step(cfg, grad_accum=grad_accum)(
        state, batch, repeat=counter.repeat)


# ---------------------------------------------------------------------------
# Per-device bytes and the closed-form collectives
# ---------------------------------------------------------------------------

def position_bytes(pairs, mesh) -> np.ndarray:
    """Bytes held at each mesh position (row-major): the sum over the
    (tensor, sharding) pairs of the slice that ``NamedSharding.index``
    gives the position."""
    positions = list(np.ndindex(*mesh.devices.shape))
    total = np.zeros(len(positions), dtype=np.int64)
    memo: dict = {}
    for t, sh in pairs:
        key = (sh.spec, tuple(t.shape), t.element_size())
        if key not in memo:
            memo[key] = np.array([
                math.prod(sl.stop - sl.start
                          for sl in sh.index(pos, t.shape))
                for pos in positions], dtype=np.int64) * t.element_size()
        total += memo[key]
    return total


def param_collectives(counter: OpCounter, params: dict, shardings: dict,
                      mesh, *, kind: str, remat: bool,
                      grad_accum: int = 1) -> None:
    """Record the collectives that the parameter shardings imply, per
    device, at the reference's conventions.  Each leaf of B bytes sharded
    k ways over its mesh axes is all-gathered over them in the forward
    (B out) and, for training with remat, again in the backward; its
    gradient is reduce-scattered over them (B in) and all-reduced over
    the batch axes its spec lacks (B / k).  A training step does this once
    per micro-batch."""
    batch_axes = axes_in_mesh(mesh, DEFAULT_RULES["batch"])
    reps = grad_accum if kind == "train" else 1
    with counter.repeat(reps):
        for name, p in params.items():
            axes = [a for e in shardings[name].spec for a in _names(e)
                    if mesh.shape[a] > 1]
            b = float(p.numel() * p.element_size())
            k = math.prod(mesh.shape[a] for a in axes)
            if axes:
                counter.add_collective("all-gather", b)
                if kind == "train":
                    if remat:
                        counter.add_collective("all-gather", b)
                    counter.add_collective("reduce-scatter", b)
            lacking = [a for a in batch_axes
                       if a not in axes and mesh.shape[a] > 1]
            if kind == "train" and lacking:
                counter.add_collective("all-reduce", b / k)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def model_flops(cfg, shape_name: str, *, batch: int | None = None,
                seq: int | None = None) -> float:
    """MODEL_FLOPS: 6·N·D for training (N active parameters, D global
    tokens); 2·N·D for inference (forward only).  Attention score flops
    are excluded by convention (the op counter counts them).  ``batch``
    and ``seq`` replace the shape's where given."""
    spec = SHAPES[shape_name]
    b = spec["batch"] if batch is None else batch
    s = spec["seq"] if seq is None else seq
    n_active = cfg.params_active
    if spec["kind"] == "train":
        return 6.0 * n_active * b * s
    if spec["kind"] == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b


def trace(cell: Cell, mesh=None) -> tuple[dict, float]:
    """(``analyze`` of the cell's step on meta, trace seconds)."""
    clear_registry()
    t0 = time.perf_counter()
    with OpCounter() as counter:
        cell.run(counter, mesh)
    seconds = time.perf_counter() - t0
    return analyze(counter, get_registry()), seconds


def cell_result(arch: str, shape: str, cell: Cell, counts: dict,
                trace_s: float, multi_pod: bool) -> dict:
    """The JSON of one cell on one production mesh from the cell's
    mesh-independent counts."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = mesh.size
    pairs = cell.inputs(mesh)
    arg = int(position_bytes(pairs, mesh).max())
    bpos = cell.batch_positions(mesh)
    temp = counts["peak_bytes"] / bpos
    cfg = cell.cfg
    params = dict(cell.model.named_parameters())
    p_sh = param_sharding(M.param_axes(cell.model), mesh, params)
    coll = OpCounter()
    param_collectives(coll, params, p_sh, mesh, kind=cell.kind,
                      remat=cfg.remat, grad_accum=cell.grad_accum)
    c = analyze(coll, {})
    if cell.kind == "train":
        state_pairs = pairs[:-len(cell.data)]
        out_b = alias_b = int(position_bytes(state_pairs, mesh).max())
    else:
        logits = cell.batch * (1 if cell.kind == "decode" else cell.seq) \
            * cfg.vocab * params["embed"].element_size()
        out_b, alias_b = logits // bpos, 0
        if cell.kind == "decode":
            n_cache = len(tree_leaves(cell.cache))
            alias_b = int(position_bytes(pairs[len(params):len(params)
                                               + n_cache], mesh).max())
            out_b += alias_b
    flops = counts["dot_flops"] / n
    nbytes = counts["bytes_accessed"] / n
    wire = c["total_wire_bytes"]
    mflops = model_flops(cfg, shape)
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_name(multi_pod),
        "n_chips": n, "kind": cell.kind, "trace_s": trace_s,
        "memory": {"argument_bytes": arg, "output_bytes": out_b,
                   "temp_bytes": temp, "alias_bytes": alias_b,
                   "temp_is_estimate": True},
        "fits": arg + temp <= HBM_BYTES,
        "hlo_flops": flops,
        "hlo_bytes_accessed": nbytes,
        "dot_flops_global": counts["dot_flops"],
        "kernel_flops_global": counts["kernel_flops"],
        "bytes_accessed_global": counts["bytes_accessed"],
        "peak_live_bytes_global": counts["peak_bytes"],
        "kernels": counts["kernels"],
        "collectives": {"raw_bytes": c["collective_raw_bytes"],
                        "wire_bytes": c["collective_wire_bytes"],
                        "counts": c["collective_counts"],
                        "total_wire_bytes": wire},
        "unknown_whiles": [],
        "scan_registry": counts["registry"],
        "params_total": int(cfg.params_total),
        "params_active": int(cfg.params_active),
        "model_flops_global": mflops,
        "model_flops_per_chip": mflops / n,
        "useful_flops_ratio": (mflops / n) / max(flops, 1.0),
    }
    roof = {"compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": nbytes / HBM_BW,
            "collective_s": wire / LINK_BW}
    roof["dominant"] = max(roof, key=roof.get)
    result["roofline"] = roof
    return result


def run_cell(arch: str, shape: str, multi_pods=(False,), out_dir=None,
             overrides: dict | None = None, tag: str = "") -> list[dict]:
    """Trace cell ``arch`` x ``shape`` once and write its JSON for each
    production mesh of ``multi_pods``; returns the results."""
    cell = abstract_cell(arch, shape, overrides)
    counts, seconds = trace(cell, make_production_mesh())
    out_dir = Path(out_dir or RESULTS_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for mp in multi_pods:
        res = cell_result(arch, shape, cell, counts, seconds, mp)
        if overrides:
            res["overrides"] = {k: str(v) for k, v in overrides.items()}
        suffix = f"__{tag}" if tag else ""
        path = out_dir / f"{arch}__{shape}__{res['mesh']}{suffix}.json"
        path.write_text(json.dumps(res, indent=1))
        results.append(res)
    return results


def one_position_mesh():
    """A (1, 1) mesh over ("data", "model") on meta: a one-card cell."""
    return make_mesh((1, 1), ("data", "model"), devices=["meta"])


def summary(res: dict) -> str:
    gb = (res["memory"]["argument_bytes"] + res["memory"]["temp_bytes"]) \
        / 1e9
    return (f"{res['arch']} {res['shape']} {res['mesh']}: "
            f"{'fits' if res['fits'] else 'does not fit'}, "
            f"{gb:.2f} GB a device, {res['roofline']['dominant']} bound, "
            f"trace {res['trace_s']:.2f} s")


def _parse_override(text: str):
    k, v = text.split("=", 1)
    for conv in (int, float):
        try:
            return k, conv(v)
        except ValueError:
            pass
    return k, (v == "True") if v in ("True", "False") else v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="write both production meshes from one trace")
    ap.add_argument("--all", action="store_true",
                    help="every supported cell on both meshes, each in a "
                         "subprocess")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--tag", default="", help="result filename suffix")
    args = ap.parse_args(argv)
    overrides = dict(_parse_override(o) for o in args.override)

    if args.all:
        failures = []
        for arch, shape, _, _ in cells():
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--both",
                   "--out", args.out]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            dt = time.perf_counter() - t0
            if r.returncode != 0:
                failures.append((arch, shape))
                print(f"FAIL {arch} {shape} ({dt:.0f} s)\n"
                      f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}", flush=True)
            else:
                print(r.stdout.strip(), f"({dt:.1f} s with start-up)",
                      flush=True)
        print(f"\n{len(failures)} failures: {failures}")
        return 1 if failures else 0

    mps = (False, True) if args.both else (args.multi_pod,)
    for res in run_cell(args.arch, args.shape, mps, args.out,
                        overrides or None, args.tag):
        print(summary(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
