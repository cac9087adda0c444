"""The port's one device policy.

Entry points place data on the card unless the caller asks for the CPU
with ``device="cpu"``.  Without a card and without that request they
raise: nothing carries on quietly on the CPU.  Computation then runs
wherever the table's tensors live.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given.  A CUDA
    device on a machine without a card raises a ``RuntimeError`` that
    names the way to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions on the CPU")
    return dev


def kernel_route(t: torch.Tensor, what: str) -> str:
    """Where a kernel's work on ``t`` goes: ``"cuda"`` on a CUDA tensor (the
    kernel launches), ``"cpu"`` on a CPU tensor (its plain version runs),
    ``"meta"`` on a meta tensor (the kernel's shape path: outputs of the
    kernel's shapes and dtypes, nothing launched and nothing computed; the
    dry run's device).  Any other device raises.  The kernel wrappers and
    the registry all ask this one function, so they cannot disagree: a
    CUDA tensor never takes the meta path, and a meta tensor never
    reaches a plain version."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"{what}: no kernel and no plain version for "
                     f"device {t.device}")
