"""repro_torch: MADlib's one-pass analytics (the paper's init/transition/
merge/final aggregates over tables) in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100.

A port of the JAX package ``repro``, module for module (``core/``,
``kernels/<name>/{ref,ops}.py``, ``methods/``).  It imports neither JAX
nor ``repro``.  Entry points put data on the card unless the caller
passes ``device="cpu"``, and raise when there is no card and the CPU was
not asked for (:mod:`repro_torch.device`).
"""

from .device import resolve_device  # noqa: F401
