"""Run-length-encoded sparse vectors (paper §3.2 support module).

The port's counterpart of the reference ``methods/sparse_vector.py``.
MADlib wrote a C RLE sparse-vector library because standard math
libraries handle sparse data poorly.  A vector of *fixed capacity* is
``(values[cap], runs[cap], n_runs)``: ``values[i]`` repeated ``runs[i]``
times.  Operations: encode and decode, scale, dot with a dense vector,
and an RLE x RLE dot.

The reference's RLE x RLE dot is a two-pointer ``lax.while_loop``; here
it merges the two run-boundary lists at once (every segment between
consecutive boundaries pairs one run of each vector), so on the card it
asks the host nothing.  The sum runs over the segments in another order
than the loop's, which matters only where the products round.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RLEVector:
    values: torch.Tensor   # (cap,) values
    runs: torch.Tensor     # (cap,) int32 run lengths
    n_runs: torch.Tensor   # () int32
    length: int            # logical (dense) length


def rle_encode(dense: torch.Tensor, capacity: int) -> RLEVector:
    """Dense (n,) -> RLE of static ``capacity``; runs past the capacity
    are dropped, as the reference's scatter drops them."""
    n = dense.shape[0]
    change = torch.ones((n,), dtype=torch.bool, device=dense.device)
    change[1:] = dense[1:] != dense[:-1]
    run_id = torch.cumsum(change.to(torch.int64), 0) - 1
    n_runs = (run_id[-1] + 1).to(torch.int32)
    keep = run_id < capacity
    rid, vals = run_id[keep], dense[keep]
    values = torch.zeros((capacity,), dtype=dense.dtype, device=dense.device)
    values[rid] = vals
    runs = torch.zeros((capacity,), dtype=torch.int32, device=dense.device)
    runs.index_add_(0, rid, torch.ones_like(rid, dtype=torch.int32))
    return RLEVector(values, runs, n_runs, n)


def _run_index(v: RLEVector) -> torch.Tensor:
    """Each dense position's run index (valid runs only)."""
    starts = torch.cumsum(v.runs.to(torch.int64), 0) - v.runs
    valid = torch.arange(v.runs.shape[0], device=v.runs.device) < v.n_runs
    s = torch.where(valid, starts, torch.full_like(starts, v.length + 1))
    pos = torch.arange(v.length, dtype=torch.int64, device=v.runs.device)
    return torch.searchsorted(s, pos, right=True) - 1


def rle_decode(v: RLEVector) -> torch.Tensor:
    return v.values[_run_index(v)]


def rle_scale(v: RLEVector, a: float) -> RLEVector:
    return RLEVector(v.values * a, v.runs, v.n_runs, v.length)


def rle_dot_dense(v: RLEVector, dense: torch.Tensor) -> torch.Tensor:
    """Σ values[i] * sum(dense over run i), by segment sums."""
    cap = v.runs.shape[0]
    idx = torch.clamp(_run_index(v), 0, cap - 1)
    seg = torch.zeros((cap,), dtype=dense.dtype, device=dense.device)
    seg.index_add_(0, idx, dense)
    return torch.sum(seg * v.values)


def _run_ends(v: RLEVector) -> torch.Tensor:
    """(cap,) end of each run; runs past ``n_runs`` have length 0."""
    valid = torch.arange(v.runs.shape[0], device=v.runs.device) < v.n_runs
    return torch.cumsum(torch.where(valid, v.runs, 0).to(torch.int64), 0)


def rle_dot_rle(a: RLEVector, b: RLEVector) -> torch.Tensor:
    """Σ over the segments between consecutive run boundaries of either
    vector, up to the shorter one's end: each pairs one run of ``a``
    with one of ``b`` (a repeated boundary gives an empty segment)."""
    ends_a, ends_b = _run_ends(a), _run_ends(b)
    stop = torch.minimum(ends_a[-1], ends_b[-1])
    ends = torch.sort(torch.cat([ends_a, ends_b])).values
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    step = torch.clamp(torch.minimum(ends, stop) - torch.minimum(starts, stop),
                       min=0).to(a.values.dtype)
    ia = torch.clamp(torch.searchsorted(ends_a, ends), max=len(ends_a) - 1)
    ib = torch.clamp(torch.searchsorted(ends_b, ends), max=len(ends_b) - 1)
    return torch.sum(a.values[ia] * b.values[ib] * step)
