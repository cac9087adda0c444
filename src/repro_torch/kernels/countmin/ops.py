"""PyTorch wrapper of the CUDA countmin kernel (``csrc/countmin.cu``).

On a CUDA tensor it checks the inputs and launches the kernel, or
raises; on a CPU tensor it runs the plain version in ``ref.py``; on a
meta tensor it returns the counts' shape and launches nothing
(:func:`cost` is the work of one call).
``countmin_launches`` counts the kernel's launches: one per call on the
card, so a fold over one block shows 1 and a fold over ``b`` blocks
shows ``b``.
"""

from __future__ import annotations

import functools

import torch

from ...device import kernel_route
from .. import _build
from ..sketch_hash import _check_rows, as_u32
from .ref import countmin_block_ref

countmin_launches = 0

_INT_MAX = 2 ** 31 - 1
# persistent CTAs to an SM of the Count-Min kernels (kCountMinCtasPerSm in
# csrc/sketch_hash.cuh), and the fewest rows a CTA of countmin takes: below
# that, clearing and flushing its histogram outweighs its rows
CTAS_PER_SM = 2
MIN_CTA_ROWS = 16_384


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's number of SMs (read once per device)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def cta_rows(n: int, sms: int) -> int:
    """Rows per CTA of the countmin kernel: ``n`` rows cut into at most
    ``sms * CTAS_PER_SM`` contiguous ranges, each a multiple of 4 rows
    (the kernel's vector chunk, so every range starts at the same
    alignment) and at least MIN_CTA_ROWS."""
    per = max(MIN_CTA_ROWS, -(-n // (sms * CTAS_PER_SM)))
    return -(-per // 4) * 4


def check_items(items: torch.Tensor, mask: torch.Tensor, what: str) -> None:
    """1-D items of any integer or float type, and a bool mask of the same
    length on the same device."""
    if items.dim() != 1 or mask.shape != items.shape:
        raise ValueError(f"{what}: want items (n,) and mask (n,), got "
                         f"{tuple(items.shape)} and {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{what}: want a bool mask, got {mask.dtype}")
    if items.dtype.is_complex:
        raise TypeError(f"{what}: items must be integers, got {items.dtype}")
    if mask.device != items.device:
        raise ValueError(f"{what}: items on {items.device}, mask on "
                         f"{mask.device}")


def item_words(items: torch.Tensor, *, saturate_floats: bool = False
               ) -> torch.Tensor:
    """Contiguous int32 items whose bits are the uint32 the hash reads
    (int32 columns pass through without a copy)."""
    if items.dtype != torch.int32:
        items = as_u32(items, saturate_floats=saturate_floats).to(torch.int32)
    return items.contiguous()


def countmin_cost(n: int, depth: int, width: int) -> tuple[float, float]:
    """(floating-point operations, bytes) of one call: no floating point
    (its hashes are integer instructions, which the bound counts by pipe
    from the SASS); int32 items and the bool mask read once, the
    (depth, width) int32 counts written once."""
    return 0.0, 5.0 * n + 4.0 * depth * width


def cost(items, mask, depth: int, width: int) -> tuple[float, float]:
    return countmin_cost(items.shape[0], depth, width)


def countmin_block(items: torch.Tensor, mask: torch.Tensor, depth: int,
                   width: int) -> torch.Tensor:
    """(n,) items, (n,) bool mask -> (depth, width) int32 counts."""
    global countmin_launches
    check_items(items, mask, "countmin")
    _check_rows(depth, "countmin: depth")
    if width < 1 or depth * width > _INT_MAX:
        raise ValueError(f"countmin: width {width} out of range")
    route = kernel_route(items, "countmin")
    if route == "cpu":
        return countmin_block_ref(items, mask, depth, width)
    n = items.shape[0]
    out = torch.empty((depth, width), dtype=torch.int32, device=items.device)
    if route == "meta":
        return out
    if n == 0:
        return out.zero_()
    words, mask = item_words(items), mask.contiguous()
    stream = torch.cuda.current_stream(items.device).cuda_stream
    rows = cta_rows(n, sm_count(items.device.index))
    err = _build.lib().madlib_countmin(
        words.data_ptr(), mask.data_ptr(), out.data_ptr(), n, depth, width,
        rows, stream)
    _build.check("countmin", err)
    countmin_launches += 1
    return out
