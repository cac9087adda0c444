"""Training driver: the MADlib host driver at LM scale, on one card.

Counterpart of the reference package's ``launch/train.py``: config ->
mesh -> :class:`TrainState` (weights from a seed) -> the train step over
the mesh (``jit_train_step``) -> data pipeline (prefetched to the device,
checked against ``batch_sharding``) -> checkpoint/restart and straggler
tracking.  The reference's mesh holds every device of the host; the
model here lives on one device, so the mesh is the one data shard of
that device, whatever else the host holds, and the step is the unsharded
step, bit for bit.  Only the logged metrics
cross to the host, every ``log_every`` steps.  Runs on the card unless
``device="cpu"`` (``--device cpu``); without a card and without that it
raises.

    python -m repro_torch.launch.train --arch stablelm-1.6b --full --steps 4
    python -m repro_torch.launch.train --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, reduced_config
from ..core.compat import make_mesh
from ..data import TokenStream, corpus_profile, make_lm_batches
from ..device import resolve_device
from ..distributed import checkpoint as ckpt
from ..distributed.fault_tolerance import StragglerMitigator
from ..distributed.sharding import DEFAULT_RULES, batch_sharding
from ..models.model import param_axes
from ..train.trainer import (init_train_state, jit_train_step,
                             make_train_step)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 50, resume: bool = False, base_lr: float = 3e-3,
          log_every: int = 10, profile_data: bool = True, device=None):
    """Train ``arch`` (its reduced config unless ``reduced=False``) for
    ``steps`` steps of ``batch`` x ``seq`` tokens from a
    :class:`TokenStream`, with the reference's schedule (10 warmup steps,
    cosine to ``steps``), from weights drawn with seed 0.  Returns the
    losses as floats, one a step."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    dev = resolve_device(device)
    mesh = make_mesh((1,), ("data",), devices=[dev])
    rules = dict(DEFAULT_RULES)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(cfg, generator=gen, device=dev)
    step_fn = make_train_step(cfg, base_lr=base_lr, warmup=10,
                              total_steps=steps)
    stream = TokenStream(vocab=cfg.vocab, seq_len=seq, batch=batch)
    if profile_data:
        prof = corpus_profile(iter(stream), vocab=cfg.vocab, n_batches=2,
                              device=dev)
        print(f"[data] distinct-token estimate: "
              f"{float(prof['distinct_estimate']):.0f}")

    sample = next(iter(stream))
    fn = jit_train_step(step_fn, state, param_axes(state.model), sample,
                        mesh, rules)
    batch_sh = batch_sharding(mesh, sample, rules)

    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt.restore(ckpt_dir, state)
        print(f"[ckpt] resumed from step {start_step}")

    writer = ckpt.AsyncCheckpointer()
    straggler = StragglerMitigator(["host0"])
    losses = []
    _sync(dev)
    t_last = time.perf_counter()
    for i, b in enumerate(make_lm_batches(stream, mesh, batch_sh,
                                          device=dev)):
        step_no = start_step + i
        if step_no >= steps:
            break
        state, metrics = fn(state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.perf_counter() - t_last
        t_last = time.perf_counter()
        straggler.record("host0", dt)
        if step_no % log_every == 0:
            print(f"step {step_no:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt * 1e3:.0f} ms)",
                  flush=True)
        if ckpt_dir and step_no > 0 and step_no % ckpt_every == 0:
            writer.save(ckpt_dir, state, step_no)
    writer.wait()
    if ckpt_dir:
        ckpt.save(ckpt_dir, state, min(steps, start_step + len(losses)))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the full config (on the card)")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, reduced=not args.full,
                   ckpt_dir=args.ckpt_dir, resume=args.resume,
                   base_lr=args.lr, device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
