"""Standard normal float32 values: ``(n, width)``, or ``(n,)`` where the
column has no ``width``."""

import torch


def make(data, name, spec, gen, n, made):
    shape = (n, int(spec["width"])) if "width" in spec else (n,)
    return torch.randn(shape, generator=gen, device=data.device)
