"""Plain PyTorch version of the xtx kernel (counterpart of the reference
package's ``kernels/xtx/ref.py``)."""

import torch


def xtx_xty_ref(x: torch.Tensor, y: torch.Tensor):
    """(N,K),(N,) -> (K,K) f32, (K,) f32, in full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x32 = x.to(torch.float32)
    y32 = y.to(torch.float32)
    return x32.T @ x32, x32.T @ y32
