"""A response ``x @ beta + noise_sd * e`` over the column ``of``: ``beta``
normal with standard deviation ``coef_sd``, drawn once a seed; ``e``
standard normal, drawn after ``of``.  The product runs with TF32 off."""

import torch

from reference.tf32 import matmul_precision


def make(data, name, spec, gen, n, made):
    x = made[spec["of"]]
    beta = data.params.get(name)
    if beta is None:
        beta = data.params[name] = torch.randn(
            (x.shape[1],), generator=data.param_gen(name),
            device=data.device) * float(spec["coef_sd"])
    e = torch.randn((n,), generator=gen, device=data.device)
    with matmul_precision(False):
        return x @ beta + float(spec["noise_sd"]) * e
