"""Gemv (z = A·x) — the level-2 memory-bound workload.

Row-block sharding: each shard task streams its block of A rows out of its
own HBM bank while re-reading the (much smaller) dense x vector — the
classic HBM-FPGA matrix-vector pattern where A's streaming bandwidth is
the whole game.  Each firing processes a fresh (A, x) pair.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph
from .axpy import (ELEM_BYTES, draw, on_device, shard_rows, shard_spec,
                   shards_for)

# Modeled (full-scale) operand: 2^13 × 2^13 float32 matrix (256 MB).
M_FULL = 1 << 13
MAT_BYTES = M_FULL * M_FULL * ELEM_BYTES
ROW_BYTES = M_FULL * ELEM_BYTES


def build_graph(ndev: int) -> TaskGraph:
    S = shards_for(ndev)
    g = TaskGraph(f"gemv-s{S}x{ndev}")
    shard_bytes = MAT_BYTES // S
    for i in range(S):
        g.add_task(Task(
            f"row{i}",
            ResourceProfile({"LUT": 22000, "DSP": 32, "BRAM": 16}),
            hbm_bytes=shard_bytes + ROW_BYTES,   # A row-block + x replica
            meta={"shard": i}))
    g.add_task(Task("collect",
                    ResourceProfile({"LUT": 4000, "DSP": 0, "BRAM": 4})))
    for i in range(S):
        g.add_channel(f"row{i}", "collect", width_bits=512,
                      bytes_per_step=M_FULL * ELEM_BYTES // S)
    return g


def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The operands :func:`bind_programs` streams, fp32 standard normal from
    ``spec["seed"]`` in this order: ``A`` [streams, rows, lanes], then
    ``x`` [streams, 1, lanes]."""
    sp = shard_spec(graph, spec, "row")
    return draw(sp, {"A": (sp["rows"], sp["lanes"]), "x": (1, sp["lanes"])})


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    from ..exec.programs import ProgramBinding, resolve_device
    from ..kernels import gemv_op

    device = resolve_device(device)
    sp = shard_spec(graph, spec, "row")
    S, br = sp["S"], sp["br"]
    ops = on_device(make_inputs(graph, spec), device)
    As, xs = ops["A"], ops["x"]

    mem_reads = {
        f"row{i}": {"A": [shard_rows(A, i, br) for A in As],
                    "x": list(xs)}               # dense x re-read per shard
        for i in range(S)}

    def shard_body(inputs):
        return gemv_op(inputs["A"], inputs["x"], block_rows=br)

    def collect_body(inputs):
        return torch.cat([inputs[f"row{i}"] for i in range(S)], dim=0)

    programs = {f"row{i}": shard_body for i in range(S)}
    programs["collect"] = collect_body

    def reference():
        return torch.stack([gemv_op(A, x, block_rows=br)
                            for A, x in zip(As, xs)])

    return ProgramBinding(
        graph=graph, programs=programs, iterations=sp["streams"],
        mem_reads=mem_reads,
        finalize=lambda sinks: torch.stack(sinks["collect"]),
        reference=reference, atol=0.0)
