"""Config registry + the four assigned input-shape cells.

Every architecture file exposes:
    full()  -> ModelConfig          (exact published dims)
    smoke() -> ModelConfig          (reduced same-family config for CPU tests)
plus metadata: FAMILY, SUPPORTED_SHAPES.

``_frontend_len`` and ``_enc_len`` give the lengths of the stub frontends'
inputs (vision patches prepended to the tokens; audio frames for the
encoder), ``prefill_input_shapes`` a prefill batch's shapes, and
``input_specs(cfg, shape)`` the dry run's stand-ins for a cell's inputs:
meta tensors (no allocation) of JAX's shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models import ModelConfig, init_cache


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

def _frontend_len(cfg: ModelConfig) -> int:
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def _enc_len(cfg: ModelConfig, seq: int) -> int:
    # Audio enc-dec: encoder consumes seq//4 frame embeddings (frontend stub
    # downsampling factor).
    return seq // 4 if cfg.arch == "encdec" else 0


def prefill_input_shapes(cfg: ModelConfig, batch: int,
                         positions: int) -> Dict[str, Tuple[int, ...]]:
    """The shapes of a prefill batch over ``positions`` positions, as JAX's
    ``input_specs`` gives them: ``tokens`` [B, positions - P]; for the
    vision frontend ``frontend`` [B, P, D], the P patch embeddings before
    the tokens; for an enc-dec config ``src`` [B, positions // 4, D], the
    frames the encoder runs over."""
    P, E = _frontend_len(cfg), _enc_len(cfg, positions)
    if positions <= P:
        raise ValueError(f"{positions} positions: {cfg.name} prepends {P} "
                         f"patch embeddings")
    shapes = {"tokens": (batch, positions - P)}
    if P:
        shapes["frontend"] = (batch, P, cfg.d_model)
    if E:
        shapes["src"] = (batch, E, cfg.d_model)
    return shapes


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, object]:
    """Meta tensors for one (arch × shape) cell, JAX's shapes and dtypes.

    train/prefill: token batch (+ frontend/src embeddings).
    decode: single-token batch + cache (``init_cache`` on the meta
    device: one dict per layer) + position.
    """
    cell = SHAPES[shape]
    B, S = cell.global_batch, cell.seq_len
    P = _frontend_len(cfg)
    E = _enc_len(cfg, S)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32, i32 = torch.float32, torch.int32
    if cell.kind in ("train", "prefill"):
        specs: Dict[str, object] = {"tokens": meta((B, S - P), i32)}
        if cell.kind == "train":
            specs["targets"] = meta((B, S), i32)
            specs["weights"] = meta((B, S), f32)
        if P:
            specs["frontend"] = meta((B, P, cfg.d_model), cfg.dtype)
        if E:
            specs["src"] = meta((B, E, cfg.d_model), cfg.dtype)
        return specs
    # decode: one new token against a cache of size seq_len.
    specs = {"tokens": meta((B, 1), i32),
             "cache": init_cache(cfg, B, S, device="meta"),
             "pos": meta((), i32)}
    if E:
        specs["enc_out"] = meta((B, E, cfg.d_model), cfg.dtype)
    return specs


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
