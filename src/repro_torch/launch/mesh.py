"""Mesh construction: the port's counterpart of the reference
``launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
device.  :func:`make_production_mesh` builds the dry run's 256- and
512-position meshes on the ``meta`` device, where nothing computes: it is
the dry run's fiction, as the reference's 512 forced host CPU devices
are.  :func:`make_host_mesh` is the mesh of the cards this host has.

The roofline constants are the H100 SXM's (NVIDIA's data sheet), at its
700 W power limit; a card set below that runs slower under load.
``LINK_BW`` is the per-card network rate, not NVLink's: a 16-wide mesh
axis spans two 8-card hosts (DGX H100), so its slowest hop is the card's
400 Gb/s NIC (50 GB/s each way), where NVLink inside one host gives 450
GB/s each way.
"""

from __future__ import annotations

import math

import torch

from ..core.compat import make_mesh
from ..distributed.sharding import Mesh

PEAK_FLOPS_BF16 = 989e12   # dense bf16 on the tensor cores, per card
HBM_BW = 3.35e12           # bytes/s of HBM3 per card
HBM_BYTES = 80e9           # device memory per card
LINK_BW = 50e9             # bytes/s per card across hosts (400 Gb/s NIC)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), every position on ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=[device] * math.prod(shape))


def make_host_mesh() -> Mesh:
    """One ``"data"`` segment per visible card (data-parallel only);
    raises without a card."""
    return make_mesh((max(torch.cuda.device_count(), 1),), ("data",))
