"""Config registry + the four assigned input-shape cells.

Every architecture file exposes:
    full()  -> ModelConfig          (exact published dims)
    smoke() -> ModelConfig          (reduced same-family config for CPU tests)
plus metadata: FAMILY, SUPPORTED_SHAPES.

The dry-run's ``input_specs`` (shape stand-ins for lowering) is not ported
yet: the port has no dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Registry filled by __init__.
ARCHS: Dict[str, object] = {}


def register(name: str, module) -> None:
    ARCHS[name] = module


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def supported_shapes(module) -> Tuple[str, ...]:
    return getattr(module, "SUPPORTED_SHAPES",
                   ("train_4k", "prefill_32k", "decode_32k"))
