"""Approximate string matching by q-grams (paper §5.2, Table 3).

The port's counterpart of the reference ``methods/string_match.py``.  A
corpus of strings is a table of fixed-width byte rows, the "index" is a
hashed 3-gram incidence matrix built by one UDA pass, and a query is a
similarity join: hash the query's trigrams, score every document by
Jaccard similarity against the incidence matrix (one matmul), and keep
those above a threshold.

The trigram hash is the reference's uint32 arithmetic, computed in
int64 and masked to 32 bits (CPU PyTorch has no uint32 shift or
modulo), so signatures are bitwise the reference's.  A signature is
built by a scatter into ``(n, n_buckets)`` rather than the reference's
``(n, width - 2, n_buckets)`` one-hot; both give 1.0 where any valid
trigram lands and 0.0 elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.aggregates import MERGE_MAX, Aggregate
from ..device import resolve_device

_U32 = 0xFFFFFFFF


def encode_strings(strings: list[str], width: int = 64,
                   device=None) -> torch.Tensor:
    """Pack Python strings into ``(n, width)`` uint8 rows (lower-cased
    UTF-8, zero-padded), on ``device``: the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    out = np.zeros((len(strings), width), np.uint8)
    for i, s in enumerate(strings):
        b = s.lower().encode("utf-8")[:width]
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(out).to(dev)


def trigram_hashes(chars: torch.Tensor, n_buckets: int = 512):
    """``(bucket (n, W - 2) int64, valid (n, W - 2) bool)`` of every
    trigram: ``(t1 p1 + t2 p2 + t3 p3) mod 2^32``, then ``h ^ (h >> 13)``
    modulo the bucket count; a trigram with a zero byte is not valid."""
    c = chars.to(torch.int64)
    t1, t2, t3 = c[:, :-2], c[:, 1:-1], c[:, 2:]
    valid = (t1 > 0) & (t2 > 0) & (t3 > 0)
    h = (t1 * 0x9E3779B1 + t2 * 0x85EBCA77 + t3 * 0xC2B2AE3D) & _U32
    return (h ^ (h >> 13)) % n_buckets, valid


def trigram_signature(chars: torch.Tensor,
                      n_buckets: int = 512) -> torch.Tensor:
    """(n, W) uint8 -> (n, n_buckets) {0, 1} hashed-trigram incidence."""
    h, valid = trigram_hashes(chars, n_buckets)
    sig = torch.zeros((chars.shape[0], n_buckets), dtype=torch.float32,
                      device=chars.device)
    sig.scatter_add_(1, h, valid.to(torch.float32))
    return torch.clamp(sig, 0.0, 1.0)


class TrigramIndexAggregate(Aggregate):
    """Builds the corpus incidence matrix; merge = elementwise OR (max).

    The state is ``(n_docs, n_buckets)``: rows of documents a block does
    not hold stay zero, so the OR-merge reassembles the full index."""

    merge_ops = MERGE_MAX

    def __init__(self, n_docs: int, n_buckets: int = 512):
        self.n_docs, self.n_buckets = n_docs, n_buckets

    def init(self, block):
        return torch.zeros((self.n_docs, self.n_buckets),
                           dtype=torch.float32,
                           device=block["chars"].device)

    def transition(self, state, block, mask):
        sig = trigram_signature(block["chars"], self.n_buckets)
        sig = sig * mask.to(torch.float32)[:, None]
        ids = block["doc_id"].to(torch.int64)[:, None].expand_as(sig)
        return state.scatter_reduce(0, ids, sig, "amax")


def jaccard_scores(index: torch.Tensor,
                   query_sig: torch.Tensor) -> torch.Tensor:
    """(D, B), (B,) -> (D,) Jaccard similarities."""
    inter = index @ query_sig
    union = torch.sum(index, -1) + torch.sum(query_sig) - inter
    return inter / torch.clamp(union, min=1.0)


def approx_match(corpus_index: torch.Tensor, query: str, *,
                 threshold: float = 0.3, width: int = 64,
                 n_buckets: int | None = None):
    """``(doc indices, scores)`` of approximate matches for ``query``:
    the indices of the documents scoring at least ``threshold``, in
    document order and padded with -1 to the corpus size, and every
    document's score.  Runs where the index lives."""
    n_buckets = n_buckets or corpus_index.shape[1]
    q = encode_strings([query], width, device=corpus_index.device)
    sig = trigram_signature(q, n_buckets)[0]
    scores = jaccard_scores(corpus_index, sig)
    hits = torch.nonzero(scores >= threshold)[:, 0].to(torch.int32)
    idx = torch.full((corpus_index.shape[0],), -1, dtype=torch.int32,
                     device=corpus_index.device)
    idx[:hits.shape[0]] = hits
    return idx, scores
