"""Latent Dirichlet Allocation (paper Table 1): variational EM as a UDA
and a driver update.

The port's counterpart of the reference ``methods/lda.py``.  Documents
are table rows of bag-of-words count vectors.  One EM round is one
aggregate pass: the transition runs a few mean-field updates (gamma,
phi) per document against the current topics beta and accumulates the
expected topic-word counts; merge = sum; the M-step renormalization is
the driver update of :class:`LDATask` under the port's ``fit``, with
perplexity-change convergence.

The reference vmaps the per-document loop; here the inner loop runs
over the whole block at once, ``(docs, topics, vocab)``, so a block's
memory is a few times ``block_size * K * V`` floats: size the block to
the card.  Each mean-field round normalizes phi over the topics with one
``softmax`` (the reference subtracts a ``logsumexp``; the two agree to
the last ulps), and only the last round keeps ``log phi``.  ``torch.special.digamma`` stands in for
``jax.scipy.special.digamma`` (the two differ in the last ulps), and the
Dirichlet start comes from a ``torch.Generator`` or an integer seed.
"""

from __future__ import annotations

import torch

from ..core.aggregates import MERGE_SUM, Aggregate
from ..core.iterative import IterativeTask
from ..core.plan import IterativeFit, execute
from ..core.table import Table, _generator
from ..device import resolve_device


class LDAEStepAggregate(Aggregate):
    """E-step and sufficient statistics: state = (expected topic-word
    counts, bound, tokens)."""

    merge_ops = MERGE_SUM

    def __init__(self, log_beta: torch.Tensor, alpha: float = 0.1,
                 inner_iters: int = 12):
        self.log_beta = log_beta           # (K, V) log topic-word probs
        self.alpha = alpha
        self.inner_iters = inner_iters

    def init(self, block):
        zero = torch.zeros((), dtype=torch.float32,
                           device=self.log_beta.device)
        return {"counts": torch.zeros_like(self.log_beta), "bound": zero,
                "n_tokens": zero.clone()}

    def transition(self, state, block, mask):
        docs = block["counts"].to(torch.float32)          # (B, V)
        m = mask.to(torch.float32)
        K = self.log_beta.shape[0]
        log_beta = self.log_beta[None]                     # (1, K, V)
        dg = torch.special.digamma
        gamma = (self.alpha + docs.sum(-1, keepdim=True) / K).expand(
            -1, K)                                         # (B, K)
        for it in range(self.inner_iters):
            elog_th = dg(gamma) - dg(gamma.sum(-1, keepdim=True))
            logits = elog_th[:, :, None] + log_beta        # (B, K, V)
            # phi normalized over topics; only the last round's log is kept
            if it + 1 < self.inner_iters:
                phi = torch.softmax(logits, dim=1)
            else:
                log_phi = torch.log_softmax(logits, dim=1)
                phi = torch.exp(log_phi)
            del logits
            gamma = self.alpha + torch.einsum("bkv,bv->bk", phi, docs)
        ll = torch.sum(docs * torch.logsumexp(log_phi + log_beta, dim=1),
                       -1)                                 # (B,)
        return {
            "counts": state["counts"] + torch.einsum(
                "bkv,bv->kv", phi, docs * m[:, None]),
            "bound": state["bound"] + torch.sum(ll * m),
            "n_tokens": state["n_tokens"] + torch.sum(docs.sum(-1) * m),
        }


class LDATask(IterativeTask):
    """Variational EM as an executor task: state = (log topics,
    perplexity); one pass = the E-step aggregate; driver update = the
    M-step renormalization; metric = relative perplexity change."""

    def __init__(self, log_beta0: torch.Tensor, alpha: float, eta: float):
        self.log_beta0 = log_beta0
        self.alpha = alpha
        self.eta = eta

    def init_state(self, columns):
        return {"log_beta": self.log_beta0,
                "perp": torch.tensor(float("inf"), dtype=torch.float32,
                                     device=self.log_beta0.device)}

    def make_aggregate(self, state):
        return LDAEStepAggregate(state["log_beta"], self.alpha)

    def update(self, state, out):
        counts = out["counts"] + self.eta
        log_beta = torch.log(counts) - torch.log(
            torch.sum(counts, -1, keepdim=True))
        perp = torch.exp(-out["bound"] / torch.clamp(out["n_tokens"],
                                                     min=1.0))
        return {"log_beta": log_beta, "perp": perp}

    def metric(self, prev, new, out):
        return torch.abs(prev["perp"] - new["perp"]) \
            / torch.clamp(new["perp"], min=1e-9)

    def trace_record(self, state, out, m):
        return state["perp"]


def dirichlet_topics(n_topics: int, vocab: int, seed=0,
                     device=None) -> torch.Tensor:
    """(K, V) rows drawn from Dirichlet(1, ..., 1): normalized unit
    exponentials from a ``torch.Generator`` on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    u = torch.rand((n_topics, vocab), generator=gen, device=dev)
    e = -torch.log1p(-u)
    return e / e.sum(-1, keepdim=True)


def lda_fit(table: Table, n_topics: int, vocab: int, *,
            alpha: float = 0.1, eta: float = 0.01, max_iters: int = 30,
            tol: float = 1e-4, seed=0, block_size: int | None = None,
            mode: str = "compiled"):
    """Variational EM; returns (topics (K, V), perplexity trace)."""
    beta = dirichlet_topics(n_topics, vocab, seed, table.device)
    log_beta = torch.log(torch.clamp(beta, min=1e-12))
    res = execute(IterativeFit(LDATask(log_beta, alpha, eta), table,
                               max_iters=max_iters, tol=tol,
                               block_size=block_size, mode=mode,
                               label="lda"))
    return torch.exp(res.state["log_beta"]), [float(p) for p in res.trace]
