"""Architecture registry + input-shape cells.

The port's copy of the reference package's ``configs/base.py``.  Ten
architectures from the public pool, each with the four LM shapes:
  train_4k     seq 4096  x global_batch 256   (train_step)
  prefill_32k  seq 32768 x global_batch 32    (serve prefill)
  decode_32k   kv 32768  x global_batch 128   (serve decode, 1 new token)
  long_500k    kv 524288 x global_batch 1     (long-context decode)

Skips: encoder-only archs have no decode; long_500k only for
sub-quadratic families (hybrid, ssm).

Input specs are ``(shape, dtype)`` pairs with a ``torch.dtype``, where
the reference gives ``jax.ShapeDtypeStruct``s: nothing is allocated.
"""

from __future__ import annotations

import importlib

import torch

from ..models.config import ModelConfig

ARCHS: tuple[str, ...] = (
    "moonshot-v1-16b-a3b",
    "dbrx-132b",
    "qwen3-8b",
    "phi3-mini-3.8b",
    "qwen3-14b",
    "stablelm-1.6b",
    "hubert-xlarge",
    "recurrentgemma-2b",
    "qwen2-vl-2b",
    "xlstm-350m",
)

SHAPES: dict[str, dict] = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

_SUBQUADRATIC = {"recurrentgemma-2b", "xlstm-350m"}
_ENCODER_ONLY = {"hubert-xlarge"}

Spec = tuple[tuple[int, ...], torch.dtype]


def _module(arch: str):
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def step_kind(shape: str) -> str:
    return SHAPES[shape]["kind"]


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    kind = SHAPES[shape]["kind"]
    if arch in _ENCODER_ONLY and kind == "decode":
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return False, "full quadratic attention at 512k indefensible"
    return True, ""


def cells(include_skipped: bool = False):
    """Yield (arch, shape, supported, reason)."""
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = cell_supported(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, why


def input_specs(arch: str, shape: str, cfg: ModelConfig | None = None
                ) -> dict[str, Spec]:
    """The cell's step inputs as ``(shape, dtype)`` pairs."""
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape]
    b, s = spec["batch"], spec["seq"]
    i32, f32 = torch.int32, torch.float32
    f = getattr(torch, cfg.dtype)

    if spec["kind"] in ("train", "prefill"):
        if cfg.family == "audio":
            # modality frontend is a stub: precomputed frame embeddings
            return {"embeddings": ((b, s, cfg.d_model), f),
                    "labels": ((b, s), i32), "mask": ((b, s), f32)}
        if cfg.family == "vlm":
            s_vis = 256                       # stub patch embeddings
            return {"tokens": ((b, s - s_vis), i32),
                    "embeddings": ((b, s_vis, cfg.d_model), f),
                    "mrope_positions": ((3, b, s), i32),
                    "labels": ((b, s), i32), "mask": ((b, s), f32)}
        return {"tokens": ((b, s), i32), "labels": ((b, s), i32),
                "mask": ((b, s), f32)}

    # decode: one new token against a seq-long cache
    return {"token": ((b, 1), i32), "pos": ((b,), i32)}


def decode_cache_len(arch: str, shape: str) -> int:
    return SHAPES[shape]["seq"]


def input_batch_axes(arch: str, shape: str, cfg: ModelConfig | None = None
                     ) -> dict[str, tuple]:
    """Logical sharding axes for every input (same keys as input_specs).
    Everything is batch-leading except M-RoPE positions."""
    out = {}
    for name, (shp, _dtype) in input_specs(arch, shape, cfg).items():
        if name == "mrope_positions":
            out[name] = (None, "batch", None)
        else:
            out[name] = ("batch",) + (None,) * (len(shp) - 1)
    return out
