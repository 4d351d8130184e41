"""Axpy (z = a·x + y) — the first memory-bound HBM workload.

Level-1 BLAS moves three bytes of HBM traffic per FLOP: the design is
bank-limited, never compute- or link-limited (the FpgaHbmForDaCe workload
set).  The graph shards the vectors row-wise, one task per shard, each
reading its x/y shards through its own ``async_mmap`` memory streams
(``ProgramBinding.mem_reads``) and streaming the result to a collect sink
over tiny FIFO channels — banks saturate, links idle.

Bit-tightness contract: each shard task runs the *same op* on its shard
(one row block) that the reference runs over the full array with
``block_rows == shard rows``; concatenation in shard order reproduces the
monolithic op bit for bit (see ``repro_torch.kernels.hbm_blas``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph

# Modeled (full-scale) problem: 2^26 float32 elements per vector.
N_FULL = 1 << 26
ELEM_BYTES = 4
VEC_BYTES = N_FULL * ELEM_BYTES


def shards_for(ndev: int) -> int:
    return 2 * max(1, ndev)


def build_graph(ndev: int) -> TaskGraph:
    """S = 2·ndev shard tasks, each an HBM reader, plus a collect sink."""
    S = shards_for(ndev)
    g = TaskGraph(f"axpy-s{S}x{ndev}")
    shard_bytes = VEC_BYTES // S
    for i in range(S):
        g.add_task(Task(
            f"axpy{i}",
            ResourceProfile({"LUT": 18000, "DSP": 16, "BRAM": 8}),
            hbm_bytes=2 * shard_bytes,        # x shard + y shard per firing
            meta={"shard": i}))
    g.add_task(Task("collect",
                    ResourceProfile({"LUT": 4000, "DSP": 0, "BRAM": 4})))
    for i in range(S):
        g.add_channel(f"axpy{i}", "collect", width_bits=512,
                      bytes_per_step=shard_bytes)
    return g


def shard_spec(graph: TaskGraph, spec, prefix: str) -> Dict[str, object]:
    """The numeric configuration of a sharded HBM app: S shard tasks named
    ``prefix{i}``, ``rows`` (a multiple of S) × ``lanes`` per operand,
    ``br = rows // S`` rows per shard, ``streams`` firings."""
    spec = dict(spec or {})
    S = sum(1 for t in graph.tasks if t.startswith(prefix))
    rows = spec.get("rows", 16)
    if rows % S:
        raise ValueError(f"rows ({rows}) must be a multiple of the {S} "
                         "shards")
    return {"S": S, "rows": rows, "lanes": spec.get("lanes", 128),
            "br": rows // S, "streams": spec.get("streams", 3),
            "seed": spec.get("seed", 0), "a": spec.get("a", 1.5)}


def draw(sp: Dict[str, object], shapes: Dict[str, tuple]
         ) -> Dict[str, np.ndarray]:
    """fp32 standard normal arrays ``[streams, *shape]``, drawn from
    ``np.random.default_rng(seed)`` in the order of ``shapes``."""
    rng = np.random.default_rng(sp["seed"])
    return {name: rng.standard_normal((sp["streams"], *shape),
                                      dtype=np.float32)
            for name, shape in shapes.items()}


def vector_inputs(graph: TaskGraph, spec, prefix: str,
                  names: Sequence[str]) -> Dict[str, np.ndarray]:
    sp = shard_spec(graph, spec, prefix)
    return draw(sp, {n: (sp["rows"], sp["lanes"]) for n in names})


def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The operands :func:`bind_programs` streams: ``x`` then ``y``, each
    [streams, rows, lanes] fp32 standard normal from ``spec["seed"]``."""
    return vector_inputs(graph, spec, "axpy", ("x", "y"))


def on_device(arrays: Dict[str, np.ndarray], device
              ) -> Dict[str, list]:
    """Each [streams, ...] array as a list of per-firing device tensors."""
    return {n: list(torch.from_numpy(a).to(device).unbind(0))
            for n, a in arrays.items()}


def shard_rows(arr: torch.Tensor, i: int, br: int) -> torch.Tensor:
    """Shard ``i``'s row block: a contiguous view, no copy."""
    return arr[i * br:(i + 1) * br]


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    """Executable binding (repro_torch.exec hook): async-read shards +
    collect."""
    from ..exec.programs import ProgramBinding, resolve_device
    from ..kernels import axpy_op

    device = resolve_device(device)
    sp = shard_spec(graph, spec, "axpy")
    S, br, a = sp["S"], sp["br"], sp["a"]
    ops = on_device(make_inputs(graph, spec), device)

    mem_reads = {
        f"axpy{i}": {"x": [shard_rows(x, i, br) for x in ops["x"]],
                     "y": [shard_rows(y, i, br) for y in ops["y"]]}
        for i in range(S)}

    def shard_body(inputs):
        return axpy_op(a, inputs["x"], inputs["y"], block_rows=br)

    def collect_body(inputs):
        return torch.cat([inputs[f"axpy{i}"] for i in range(S)], dim=0)

    programs = {f"axpy{i}": shard_body for i in range(S)}
    programs["collect"] = collect_body

    def reference():
        return torch.stack([axpy_op(a, x, y, block_rows=br)
                            for x, y in zip(ops["x"], ops["y"])])

    return ProgramBinding(
        graph=graph, programs=programs, iterations=sp["streams"],
        mem_reads=mem_reads,
        finalize=lambda sinks: torch.stack(sinks["collect"]),
        reference=reference, atol=0.0)
