"""Serving: batched decode with a KV or recurrent cache.

Counterpart of the reference package's ``launch/serve.py``, for every
decoder family (the encoder-only audio family raises ``ValueError``): a
model of
random weights drawn from ``seed``, a teacher-forced prefill of a random
prompt through ``decode_step`` (which drives the cache path end to end),
then sampled generation.  The first generated token is the prefill's
argmax, fed but not returned, as in the reference; the ``gen_len``
returned tokens are drawn with ``torch.multinomial`` over
``softmax(logits / temperature)`` from a ``torch.Generator`` seeded with
``seed`` (in place of ``jax.random.categorical``).  Runs on the card
unless ``device="cpu"``.

    python -m repro_torch.launch.serve --arch qwen3-8b --full
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --full
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, reduced_config
from ..device import resolve_device
from ..models import model as M


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 16,
          gen_len: int = 32, reduced: bool = True, temperature: float = 0.8,
          seed: int = 0, device=None):
    """Returns (generated tokens (batch, gen_len) int64, timings): the
    timings dict holds ``prefill_s`` and ``prefill_tok_s`` (the
    teacher-forced prompt), ``decode_s`` and ``decode_tok_s`` (the sampled
    tokens), each on the host clock ended by a synchronize."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode path")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = M.init_model(cfg, generator=gen, device=dev)
    max_seq = prompt_len + gen_len
    state = M.init_decode_state(cfg, batch, max_seq, device=dev)

    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, state = M.decode_step(model, state, toks[:, t:t + 1], t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    cur = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    for t in range(prompt_len, max_seq):
        logits, state = M.decode_step(model, state, cur, t)
        probs = torch.softmax(logits.float() / temperature, -1)
        cur = torch.multinomial(probs, 1, generator=gen)
        out.append(cur)
    tokens = torch.cat(out, 1)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    timings = {"prefill_s": t_prefill,
               "prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
               "decode_s": t_gen,
               "decode_tok_s": batch * gen_len / max(t_gen, 1e-9)}
    print(f"{arch}: prefill {prompt_len} tok in {t_prefill:.2f}s; "
          f"generated {gen_len} tok x {batch} seqs at "
          f"{timings['decode_tok_s']:.1f} tok/s")
    return tokens, timings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen_len=args.gen_len, reduced=not args.full)


if __name__ == "__main__":
    main()
