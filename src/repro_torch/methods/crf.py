"""Statistical text analytics (paper §5.2, Tables 2 & 3).

The port's counterpart of the reference ``methods/crf.py``.  A
linear-chain CRF with:

* **Text feature extraction** — hashed word features, the previous word,
  position features (first/last) and dictionary features, over token
  blocks.  The hashes are the reference's uint32 arithmetic, done in
  int64 masked to 32 bits after each multiply and add (torch has no
  uint32 ``%``), so the feature ids equal the reference's bit for bit.
* **Training** — the Table-2 "Labeling (CRF)" objective
  ``Σ_k [Σ_j x_j F_j(y_k, z_k) − log Z(z_k)]`` as a ConvexProgram: the
  log-partition is a forward (logsumexp) recursion over positions;
  gradients by ``torch.func``; each table row is one sequence.
* **Viterbi inference** — max-product recursion with backpointers.
* **MCMC inference** — Gibbs sampling and Metropolis-Hastings over label
  sequences.  The reference draws with ``jax.random``, whose bits torch
  cannot reproduce: Gibbs draws each site by Gumbel-max from a
  ``torch.Generator``; MH draws its site from a CPU generator (a Python
  int, no device sync per step) and its proposals and uniforms from a
  generator on the device.  Their results match the reference in
  distribution, not in bits.

Parameters: ``{"emit": (F, L), "trans": (L, L)}`` over hashed feature ids.
Randomness takes an integer ``seed`` or a ``torch.Generator`` where the
reference takes a JAX key.
"""

from __future__ import annotations

import torch

from ..core.convex import ConvexProgram
from ..core.table import _generator
from ..device import resolve_device

NEG = -1e9
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Feature extraction (hashed; static shapes).
# ---------------------------------------------------------------------------

def _hash_u32(v: torch.Tensor, mult: int, add: int, n_features: int
              ) -> torch.Tensor:
    """``(uint32(v) * mult + add) % n_features`` in uint32 arithmetic, as
    int64: an int64 product may wrap, but its low 32 bits are right."""
    h = ((v.to(torch.int64) & _U32) * mult) & _U32
    return ((h + add) & _U32) % n_features


def extract_features(tokens: torch.Tensor, n_features: int,
                     dictionary: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T) int tokens -> (B, T, K) int32 feature ids (K = 3, or 4 with
    a dictionary).

    Features per position: hashed word id; hashed previous word; is-first
    / is-last position flags; optional dictionary membership.  All map
    into one shared hashed feature space of size ``n_features``."""
    B, T = tokens.shape
    word = _hash_u32(tokens, 0x9E3779B1, 0, n_features)
    prev = torch.cat([tokens.new_zeros((B, 1)), tokens[:, :-1]], dim=1)
    prev_h = _hash_u32(prev, 0x85EBCA77, 1, n_features)
    pos = torch.zeros((B, T), dtype=torch.int64, device=tokens.device)
    pos[:, 0] = 1
    pos[:, -1] = 2
    pos_h = _hash_u32(pos, 0xC2B2AE3D, 7, n_features)
    feats = [word, prev_h, pos_h]
    if dictionary is not None:
        in_dict = dictionary[tokens.clamp(0, dictionary.shape[0] - 1).long()]
        feats.append(_hash_u32(in_dict, 0x27D4EB2F, 13, n_features))
    return torch.stack(feats, dim=-1).to(torch.int32)   # (B, T, K)


def emissions(params, feats: torch.Tensor) -> torch.Tensor:
    """(B,T,K) feature ids -> (B,T,L) emission scores (sum of feat weights).
    The K weights are added left to right, so the card and the CPU round
    alike (Viterbi's labels then agree between them)."""
    emit, f = params["emit"], feats.long()
    out = emit[f[..., 0]]
    for j in range(1, f.shape[-1]):
        out = out + emit[f[..., j]]
    return out


# ---------------------------------------------------------------------------
# Training objective (forward algorithm).
# ---------------------------------------------------------------------------

def _per_seq_ll(params, feats, labels, mask) -> torch.Tensor:
    """(B,) log p(y|z) of each sequence; mask (B,T) marks valid positions.
    Sequences never mix, so this batch equals the reference's ``vmap`` of
    one sequence."""
    emit = emissions(params, feats)                      # (B, T, L)
    trans = params["trans"]                              # (L, L)
    T = emit.shape[1]
    m = mask.to(torch.float32)
    y = labels.long()

    # score of the gold path
    gold_emit = torch.gather(emit, -1, y[..., None])[..., 0]
    gold_trans = trans[y[:, :-1], y[:, 1:]]
    path = torch.sum(gold_emit * m, 1) + torch.sum(gold_trans * m[:, 1:], 1)

    # log partition by the forward recursion; masked positions carry alpha
    alpha = emit[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emit[:, t]
        alpha = torch.where(m[:, t, None] > 0, nxt, alpha)
    log_z = torch.logsumexp(alpha, dim=-1)
    return path - log_z


def crf_log_likelihood(params, feats: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Sum over batch of log p(y|z); mask (B,T) marks valid positions."""
    return torch.sum(_per_seq_ll(params, feats, labels, mask))


def crf_program(n_features: int, n_labels: int, mu: float = 1e-4
                ) -> ConvexProgram:
    """Table-2 CRF row as a ConvexProgram over rows {feats, labels, mask}."""

    def loss(params, block, mask_rows):
        ll = _per_seq_ll(params, block["feats"], block["labels"],
                         block["mask"])
        return -torch.sum(ll * mask_rows.to(torch.float32))

    def reg(params):
        return 0.5 * mu * (torch.sum(params["emit"] ** 2)
                           + torch.sum(params["trans"] ** 2))

    return ConvexProgram(loss=loss, regularizer=reg)


def crf_init_params(n_features: int, n_labels: int, seed=0,
                    scale: float = 0.01, device=None):
    """N(0, scale²) weights on ``device`` (the card unless
    ``device="cpu"``; a generator's own device when ``seed`` is a
    ``torch.Generator`` and ``device`` is None)."""
    dev = seed.device if isinstance(seed, torch.Generator) and device is None \
        else resolve_device(device)
    gen = _generator(seed, dev)
    return {
        "emit": scale * torch.randn((n_features, n_labels), generator=gen,
                                    device=dev),
        "trans": scale * torch.randn((n_labels, n_labels), generator=gen,
                                     device=dev),
    }


# ---------------------------------------------------------------------------
# Viterbi (most-likely labeling).
# ---------------------------------------------------------------------------

def viterbi_decode(params, feats: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """(B,T,K) -> (B,T) int32 argmax labelings by max-product.  Ties go to
    the first label, as ``jnp.argmax`` sends them."""
    emit = emissions(params, feats)
    trans = params["trans"]
    B, T, L = emit.shape
    m = mask.to(torch.float32)
    stay = torch.arange(L, device=emit.device).expand(B, L)

    delta = emit[:, 0]
    ptrs = []                                  # ptrs[t]: position t + 1
    for t in range(1, T):
        scores = delta[:, :, None] + trans[None]          # (B, L, L)
        best = torch.amax(scores, dim=1) + emit[:, t]
        ptr = torch.argmax(scores, dim=1)
        keep = m[:, t, None] > 0
        delta = torch.where(keep, best, delta)
        ptrs.append(torch.where(keep, ptr, stay))
    cur = torch.argmax(delta, dim=-1)                     # (B,)
    path = [cur]
    for ptr in reversed(ptrs):
        cur = torch.gather(ptr, 1, cur[:, None])[:, 0]
        path.append(cur)
    return torch.stack(path[::-1], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# MCMC inference (Gibbs, Metropolis-Hastings).
# ---------------------------------------------------------------------------

def _site_logits(emit, trans, labels, t: int):
    """Conditional logits for position t given neighbors (B, L)."""
    T = emit.shape[1]
    left = trans[labels[:, t - 1].long()] if t > 0 else 0.0
    right = trans[:, labels[:, t + 1].long()].T if t < T - 1 else 0.0
    return emit[:, t] + left + right


def _gumbel_max(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of ``softmax(logits)``: argmax of logits plus
    standard Gumbel noise (the method ``jax.random.categorical`` uses)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def gibbs_sample(params, feats: torch.Tensor, mask: torch.Tensor, seed=0,
                 n_sweeps: int = 20):
    """Systematic-scan Gibbs over label sequences; returns the final
    sample (B, T) int32 and per-position marginal estimates (B, T, L) from
    the last half of the chain."""
    emit = emissions(params, feats)
    trans = params["trans"]
    B, T, L = emit.shape
    gen = _generator(seed, emit.device)
    valid = mask > 0
    labels = torch.argmax(emit, dim=-1).to(torch.int32)
    counts = torch.zeros((B, T, L), device=emit.device)
    for s in range(n_sweeps):
        for t in range(T):
            logits = _site_logits(emit, trans, labels, t)
            logits = torch.where(valid[:, t, None], logits, 0.0)
            new = _gumbel_max(logits, gen).to(torch.int32)
            labels[:, t] = torch.where(valid[:, t], new, labels[:, t])
        if s >= n_sweeps // 2:
            counts += torch.nn.functional.one_hot(labels.long(), L)
    return labels, counts / (n_sweeps - n_sweeps // 2)


def _mh_generators(seed, dev: torch.device):
    """(CPU generator for the sites, generator on ``dev`` for proposals
    and uniforms), both from one int seed or one ``torch.Generator``."""
    def draw(gen):
        return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))

    if isinstance(seed, torch.Generator) and seed.device.type != "cpu":
        return _generator(draw(seed), "cpu"), seed
    cpu = _generator(seed, "cpu")
    return cpu, _generator(draw(cpu), dev)


def mh_sample(params, feats: torch.Tensor, mask: torch.Tensor, seed=0,
              n_steps: int = 200):
    """Single-site Metropolis-Hastings with uniform proposals; returns the
    final sample (B, T) int32 and the mean acceptance rate."""
    emit = emissions(params, feats)
    trans = params["trans"]
    B, T, L = emit.shape
    dev = emit.device
    sites, gen = _mh_generators(seed, dev)
    valid = mask > 0
    labels = torch.argmax(emit, dim=-1).to(torch.int32)
    accepted = torch.zeros((), device=dev)
    for _ in range(n_steps):
        t = int(torch.randint(0, T, (), generator=sites))
        prop = torch.randint(0, L, (B,), generator=gen, device=dev)
        logits = _site_logits(emit, trans, labels, t)
        cur = labels[:, t].long()
        lp_cur = torch.gather(logits, 1, cur[:, None])[:, 0]
        lp_prop = torch.gather(logits, 1, prop[:, None])[:, 0]
        u = torch.rand((B,), generator=gen, device=dev)
        accept = (torch.log(u) < (lp_prop - lp_cur)) & valid[:, t]
        labels[:, t] = torch.where(accept, prop, cur).to(torch.int32)
        accepted += torch.mean(accept.to(torch.float32))
    return labels, accepted / n_steps
