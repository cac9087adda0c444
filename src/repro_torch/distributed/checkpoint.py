"""Checkpoint and restore, synchronous or on a background writer.

Counterpart of the single-card part of the reference package's
``distributed/checkpoint.py``, in its format: one ``.npy`` per leaf and
a JSON manifest (step, and each leaf's file, shape and dtype) in
``step_<10 digits>``, written to a ``.tmp`` directory that is renamed
into place, so a crash mid-save never leaves a partial checkpoint under
the final name; the newest ``keep`` (3) are kept.  A leaf's key is its
path through the state joined by ``/``: a module contributes its
``state_dict`` names (``model/blocks.0.attn.wq``), a dataclass its
fields, a dict its keys (``opt/mu/embed``).  bfloat16 leaves are stored
as their 16-bit patterns (numpy has no bfloat16), with the dtype
``bfloat16`` in the manifest.  ``restore`` copies into the tensors of
the state it is given, casting to their dtypes, in place; with
``shardings=`` (a tree of ``NamedSharding`` keyed as the state, e.g.
``train.shardings_for_state`` on the new mesh) each leaf is first checked
against its sharding, so a checkpoint saved from one mesh restores onto
another (elastic restart).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_FLAT_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        items = tree.state_dict(keep_vars=True).items()
    elif isinstance(tree, dict):
        items = tree.items()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_FLAT_SEP}{k}" if prefix
                            else str(k)))
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy on the CPU too: the caller may update
    the state in place while the writer still holds the snapshot)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _snapshot(tree) -> tuple[dict, dict]:
    """(key -> host array, key -> dtype name) of every leaf."""
    flat = _flatten(tree)
    host = {k: _to_host(v) for k, v in flat.items()}
    dtypes = {k: str(v.dtype).removeprefix("torch.") for k, v in flat.items()}
    return host, dtypes


def save(ckpt_dir: str, tree, step: int, *, keep: int = 3) -> str:
    """Synchronous checkpoint. Returns the checkpoint path."""
    host, dtypes = _snapshot(tree)
    return _write(ckpt_dir, host, dtypes, step, keep)


class AsyncCheckpointer:
    """Background writer; at most one save in flight (newer saves wait).
    The state is copied to the host on the caller's thread; only the file
    writes run on the writer."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, ckpt_dir: str, tree, step: int, *, keep: int = 3):
        self.wait()
        host, dtypes = _snapshot(tree)
        self._thread = threading.Thread(
            target=_write, args=(ckpt_dir, host, dtypes, step, keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _write(ckpt_dir: str, host: dict, dtypes: dict, step: int,
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "time": time.time()}
    for k, v in host.items():
        fname = k.replace(_FLAT_SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), v)
        manifest["leaves"][k] = {"file": fname, "shape": list(v.shape),
                                 "dtype": dtypes[k]}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> list[str]:
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _gc(ckpt_dir: str, keep: int):
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _steps(ckpt_dir)
    return int(ckpts[-1].split("_")[1]) if ckpts else None


def restore(ckpt_dir: str, target_tree, *, step: int | None = None,
            shardings=None):
    """Load the checkpoint at ``step`` (the latest by default) into the
    tensors of ``target_tree``, in place.  Returns (target_tree, step).

    ``shardings`` (keyed as ``target_tree``) places each leaf: its shape
    must split into the sharding's slices, and the leaf must live on the
    sharding's device (the mesh's first position holds the global
    tensor)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_sh = _flatten(shardings) if shardings is not None else None
    with torch.no_grad():
        for k, leaf in _flatten(target_tree).items():
            meta = manifest["leaves"][k]
            arr = np.load(os.path.join(path, meta["file"]))
            src = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                src = src.view(torch.int16).view(torch.bfloat16)
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(f"restore: {k} has shape "
                                 f"{tuple(src.shape)} in {path}, the "
                                 f"target {tuple(leaf.shape)}")
            if flat_sh is not None:
                if flat_sh.get(k) is None:
                    raise ValueError(f"restore: no sharding for {k}")
                flat_sh[k].check(leaf.shape, leaf.device, f"restore: {k}")
            leaf.copy_(src)
    return target_tree, step
