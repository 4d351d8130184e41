"""Dot (r = x·y) — memory-bound reduction over banked HBM.

Same shard decomposition as :mod:`repro_torch.apps.axpy`, but the shards
emit scalar partials that a reduce sink folds **in shard order** with the
kernels' shared ``fold_partials`` — the one canonical reduction order that
makes the decomposed dataflow bit-identical to the monolithic ``dot_op``
(floating-point addition does not commute in rounding).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph
from .axpy import (ELEM_BYTES, VEC_BYTES, on_device, shard_rows,
                   shard_spec, shards_for, vector_inputs)


def build_graph(ndev: int) -> TaskGraph:
    S = shards_for(ndev)
    g = TaskGraph(f"dot-s{S}x{ndev}")
    shard_bytes = VEC_BYTES // S
    for i in range(S):
        g.add_task(Task(
            f"part{i}",
            ResourceProfile({"LUT": 14000, "DSP": 24, "BRAM": 8}),
            hbm_bytes=2 * shard_bytes,
            meta={"shard": i}))
    g.add_task(Task("reduce",
                    ResourceProfile({"LUT": 3000, "DSP": 8, "BRAM": 2})))
    for i in range(S):
        # A scalar partial per firing: the cut carries bytes, banks carry GB.
        g.add_channel(f"part{i}", "reduce", width_bits=32,
                      bytes_per_step=ELEM_BYTES)
    return g


def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The operands :func:`bind_programs` streams: ``x`` then ``y``, each
    [streams, rows, lanes] fp32 standard normal from ``spec["seed"]``."""
    return vector_inputs(graph, spec, "part", ("x", "y"))


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    from ..exec.programs import ProgramBinding, resolve_device
    from ..kernels import dot_op, dot_partials_op, fold_partials

    device = resolve_device(device)
    sp = shard_spec(graph, spec, "part")
    S, br = sp["S"], sp["br"]
    ops = on_device(make_inputs(graph, spec), device)

    mem_reads = {
        f"part{i}": {"x": [shard_rows(x, i, br) for x in ops["x"]],
                     "y": [shard_rows(y, i, br) for y in ops["y"]]}
        for i in range(S)}

    def shard_body(inputs):
        return dot_partials_op(inputs["x"], inputs["y"],
                               block_rows=br)[0, 0]

    def reduce_body(inputs):
        return fold_partials([inputs[f"part{i}"] for i in range(S)])

    programs = {f"part{i}": shard_body for i in range(S)}
    programs["reduce"] = reduce_body

    def reference():
        return torch.stack([dot_op(x, y, block_rows=br)
                            for x, y in zip(ops["x"], ops["y"])])

    return ProgramBinding(
        graph=graph, programs=programs, iterations=sp["streams"],
        mem_reads=mem_reads,
        finalize=lambda sinks: torch.stack(sinks["reduce"]),
        reference=reference, atol=0.0)
