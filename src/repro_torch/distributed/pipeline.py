"""Pipeline parallelism: the GPipe schedule over a mesh axis of stages.

Counterpart of the reference package's ``distributed/pipeline.py``.
Stages lie along a mesh axis (``"pod"`` by default); over M micro-batches
and S stages the schedule takes ``M + S - 1`` ticks, and at each tick
every stage runs its stage function on what it received the tick before
and hands the result one stage down.  The reference moves activations
with ``ppermute`` inside a ``shard_map``; on one controller each tick
runs the stages in order and swaps the buffers only after all of them
have run, so every tick does the reference's work (the bubble's stages
included, on zeros or a repeated micro-batch) and the outputs are the
last stage's.  :func:`bubble_fraction` is (S - 1) / (M + S - 1).
"""

from __future__ import annotations

import torch

from ..tree import tree_map
from .sharding import Mesh, check_mesh, on_device


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def make_pipeline(mesh: Mesh, stage_fn, *, stage_axis: str = "pod",
                  n_microbatches: int | None = None):
    """Returns ``pipe(params_stacked, x) -> y``.

    ``params_stacked`` is a tree whose leaves carry a leading axis of
    n_stages (stage s takes the views ``leaf[s]``); ``x`` is (M, mb, ...)
    micro-batches.  ``stage_fn(params, act) -> act`` keeps the
    activation's shape.  Stage s runs on the device of position s along
    ``stage_axis``; an activation crossing to another device is copied
    (a ``kind="copy"`` trace event)."""
    check_mesh(mesh, "make_pipeline")
    n_stages = mesh.shape[stage_axis]
    devs = mesh.segments((stage_axis,))

    def pipe(params_stacked, x):
        local = [tree_map(lambda p, s=s: on_device(p[s], devs[s]),
                          params_stacked) for s in range(n_stages)]
        m = x.shape[0]
        ticks = m + n_stages - 1
        buf = [torch.zeros_like(x[0], device=d) for d in devs]
        outs = torch.zeros_like(x)
        for t in range(ticks):
            acts = []
            for s in range(n_stages):
                # stage 0 injects micro-batch t (the last once they run
                # out); the others take what they received last tick
                act = (on_device(x[min(t, m - 1)], devs[0]) if s == 0
                       else buf[s])
                acts.append(stage_fn(local[s], act))
            out_idx = t - (n_stages - 1)
            if 0 <= out_idx < m:
                outs[out_idx] = on_device(acts[-1], outs.device)
            # hand every activation one stage down (stage 0 receives
            # nothing and never reads its buffer)
            buf = buf[:1] + [
                on_device(acts[s - 1], devs[s], stage=s)
                for s in range(1, n_stages)]
        return outs

    return pipe
