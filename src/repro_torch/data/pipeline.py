"""Data pipeline: a deterministic synthetic token stream, host-to-device
batches with a background prefetch, and MADlib-sketch corpus profiling.

Counterpart of the reference package's ``data/pipeline.py``.
:class:`TokenStream` is numpy only and draws what the reference draws,
so its batches are bitwise the reference's.  :func:`make_lm_batches`
copies them to the device from pinned host memory on a producer thread;
where the reference's consumer would wait for ever on a producer that
died, an exception in the producer is raised again in the consumer.
The profiling layer is the paper's descriptive statistics run as
aggregates over the stream (Count-Min token frequencies through the
``countmin`` kernel on the card, an FM distinct count, a histogram of
token ids): MADlib's ``profile`` applied to an LM corpus.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import as_device
from ..methods.quantiles import HistogramAggregate
from ..methods.sketches import CountMinAggregate, FMAggregate, \
    countmin_query


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM corpus: Zipfian unigrams with short-range
    bigram structure (so models have something learnable)."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        # Zipf over a capped vocab for sampling stability
        v_eff = min(self.vocab, 50_000)
        ranks = np.arange(1, v_eff + 1)
        probs = ranks ** (-self.zipf_a)
        probs /= probs.sum()
        while True:
            base = rng.choice(v_eff, size=(self.batch, self.seq_len),
                              p=probs)
            # bigram structure: with p=0.5, token t+1 = (token t + 1) % v
            rep = rng.random((self.batch, self.seq_len)) < 0.5
            shifted = (np.roll(base, 1, axis=1) + 1) % v_eff
            toks = np.where(rep, shifted, base).astype(np.int32)
            yield {
                "tokens": toks,
                "labels": np.roll(toks, -1, axis=1).astype(np.int32),
                "mask": np.ones((self.batch, self.seq_len), np.float32),
            }


def synthetic_batch(cfg, batch: int, seq: int, *,
                    generator: torch.Generator) -> dict:
    """One random batch of ``cfg``'s tokens on the generator's device (for
    tests and benches): tokens uniform in [0, vocab), labels the tokens
    rolled by one, a mask of ones."""
    dev = generator.device
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=generator,
                         dtype=torch.int32, device=dev)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
            "mask": torch.ones((batch, seq), dtype=torch.float32,
                               device=dev)}


_DONE = object()


def make_lm_batches(stream, mesh=None, sharding=None, *, device=None,
                    prefetch: int = 2) -> Iterator[dict]:
    """Batches of ``stream`` (dicts of numpy arrays) as tensors on
    ``device``, in the stream's order.  A producer thread keeps up to
    ``prefetch`` batches in flight: each array goes into pinned host
    memory (on a card) and is copied with ``non_blocking=True`` on a
    stream of the producer's own, which the consumer's stream waits on
    before it uses the batch.  An exception in the producer is raised
    here.

    With the reference's ``mesh`` (and no ``device``) the batches land on
    the mesh's first device, which holds a sharded global tensor;
    ``sharding`` (a dict of ``NamedSharding`` by key, from
    ``batch_sharding``) checks that each array splits into its slices
    there."""
    if device is None and mesh is not None:
        device = mesh.devices.flat[0]
    dev = as_device(resolve_device(device))
    if sharding is not None:
        stream = _checked(stream, sharding, dev)
    on_card = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for np_batch in stream:
                if stop.is_set():
                    return
                if on_card:
                    with torch.cuda.stream(copy_stream):
                        batch = {k: torch.from_numpy(np.asarray(v))
                                 .pin_memory().to(dev, non_blocking=True)
                                 for k, v in np_batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                    item = (batch, ready)
                else:
                    item = ({k: torch.from_numpy(np.array(v)).to(dev)
                             for k, v in np_batch.items()}, None)
                if not put(item):
                    return
            put(_DONE)
        except BaseException as exc:      # handed to the consumer
            put(exc)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ready)
                for v in batch.values():
                    v.record_stream(cur)
            yield batch
    finally:
        stop.set()
        t.join()


def _checked(stream, sharding: dict, dev: torch.device):
    """``stream``'s batches, each array checked against its sharding as
    it will land on ``dev``."""
    for np_batch in stream:
        for k, v in np_batch.items():
            sharding[k].check(np.shape(v), dev, f"make_lm_batches: {k}")
        yield np_batch


def corpus_profile(token_batches, *, vocab: int, n_batches: int = 4,
                   cm_width: int = 4096, device=None) -> dict:
    """MADlib-sketch profile of a token stream: heavy hitters (Count-Min,
    depth 4), the distinct-token estimate (FM) and a 1,024-bin histogram
    of token ids over ``n_batches`` batches, and the Count-Min and FM
    states themselves (``countmin``, ``fm``), which the reference keeps
    to itself.  Batches of numpy arrays go to ``device``, the card unless
    the caller asks for the CPU (tensors stay where they are); on the card
    the Count-Min runs the ``countmin`` kernel."""
    cm = CountMinAggregate(depth=4, width=cm_width, item_col="tokens",
                           use_kernel=True)
    fm = FMAggregate(item_col="tokens")
    hist = HistogramAggregate(0, vocab, bins=1024, value_col="tokens")
    cm_state = fm_state = hist_state = None
    dev = None
    it = iter(token_batches)
    for _ in range(n_batches):
        toks = next(it)["tokens"]
        if not isinstance(toks, torch.Tensor):
            if dev is None:
                dev = resolve_device(device)
            toks = torch.from_numpy(np.asarray(toks)).to(dev)
        flat = toks.reshape(-1)
        tbl = {"tokens": flat}
        mask = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
        cm_state = cm.transition(
            cm_state if cm_state is not None else cm.init(tbl), tbl, mask)
        fm_state = fm.transition(
            fm_state if fm_state is not None else fm.init(tbl), tbl, mask)
        hist_state = hist.transition(
            hist_state if hist_state is not None else hist.init(tbl), tbl,
            mask)
    top_ids = torch.arange(64, device=cm_state.device)
    return {
        "heavy_hitters": countmin_query(cm_state, top_ids),
        "distinct_estimate": fm.final(fm_state),
        "token_histogram": hist_state,
        "countmin": cm_state,
        "fm": fm_state,
    }
