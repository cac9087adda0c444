"""Mesh construction: the port's counterpart of the reference
``core/compat.py``.

The reference's module adapts moved JAX APIs (``shard_map``,
``random_multinomial``, ``axis_size``, ``cost_analysis``); none of them
has a PyTorch counterpart to adapt (ROADMAP lists each as not
applicable).  What the port keeps is :func:`make_mesh`, the one way to
build the :class:`~repro_torch.distributed.sharding.Mesh` that
``Table.distribute`` and the sharded engines take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributed.sharding import Mesh


def make_mesh(axis_shapes: tuple[int, ...], axis_names: tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names``.

    ``devices`` lists one device per position in row-major order; a
    device may repeat, so ``["cuda:0"] * 24`` is 24 segments on one card
    and ``["cpu"] * 8`` a CPU mesh for tests.  ``None`` means every
    visible card, once each, and raises without one."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[\"cpu\"] * n "
                "to build a mesh of CPU segments")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    if arr.size != int(np.prod(axis_shapes)):
        raise ValueError(f"make_mesh: {arr.size} devices for a mesh of "
                         f"shape {axis_shapes}")
    return Mesh(arr.reshape(axis_shapes), axis_names)
