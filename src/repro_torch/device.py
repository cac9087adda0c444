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


def runs_on_card(t: torch.Tensor, what: str) -> bool:
    """Where a kernel's work on ``t`` runs: ``True`` on a CUDA tensor (the
    kernel launches), ``False`` on a CPU tensor (its plain version runs).
    Any other device raises.  The kernel wrappers and the registry both
    ask this one function, so they cannot disagree."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel and no plain version for "
                     f"device {t.device}")
