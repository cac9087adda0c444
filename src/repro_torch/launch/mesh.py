"""Host mesh construction: the port's counterpart of the reference
``launch/mesh.py``.

A function, not a module-level constant: importing this module touches
no device.  ``make_production_mesh`` (the 256- and 512-chip meshes of the
dry run) is ROADMAP Queue 1 item 13c.
"""

from __future__ import annotations

import torch

from ..core.compat import make_mesh
from ..distributed.sharding import Mesh


def make_host_mesh() -> Mesh:
    """One ``"data"`` segment per visible card (data-parallel only);
    raises without a card."""
    return make_mesh((max(torch.cuda.device_count(), 1),), ("data",))
