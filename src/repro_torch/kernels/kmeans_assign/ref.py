"""Plain PyTorch version of the kmeans_assign kernel (counterpart of the
reference package's ``kernels/kmeans_assign/ref.py``)."""

import torch


def assign_and_reduce_ref(x: torch.Tensor, c: torch.Tensor,
                          m: torch.Tensor):
    """x (N,D), c (K,D), m (N,) -> (assign (N,), mind (N,), sums (K,D),
    counts (K,)), in full f32 (no TF32).  ``assign`` is the int64 of
    ``torch.argmin``, which takes the lowest index among equal minima."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x32 = x.to(torch.float32)
    c32 = c.to(torch.float32)
    m32 = m.to(torch.float32)
    d2 = (torch.sum(x32 * x32, -1, keepdim=True) - 2.0 * x32 @ c32.T
          + torch.sum(c32 * c32, -1)[None])
    assign = torch.argmin(d2, -1)
    mind = torch.clamp(torch.amin(d2, -1), min=0.0) * m32
    onehot = torch.nn.functional.one_hot(assign, c.shape[0]).to(
        torch.float32) * m32[:, None]
    return assign, mind, onehot.T @ x32, torch.sum(onehot, 0)
