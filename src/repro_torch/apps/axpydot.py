"""AxpyDot (r = (a·x + y)·w) — the fused two-stage HBM workload.

The interesting composition: an axpy shard stage feeds a dot shard stage
over real FIFO channels while *both* stages read their own operands from
HBM banks — memory channels and inter-task channels active at once, the
configuration the bank/link dual accounting exists for.  The reduce sink
folds the partials in shard order (``fold_partials``), matching the fused
monolithic ``axpydot_op`` bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph
from .axpy import (ELEM_BYTES, VEC_BYTES, on_device, shard_rows, shard_spec,
                   shards_for, vector_inputs)


def build_graph(ndev: int) -> TaskGraph:
    S = shards_for(ndev)
    g = TaskGraph(f"axpydot-s{S}x{ndev}")
    shard_bytes = VEC_BYTES // S
    for i in range(S):
        g.add_task(Task(
            f"axpy{i}",
            ResourceProfile({"LUT": 18000, "DSP": 16, "BRAM": 8}),
            hbm_bytes=2 * shard_bytes,           # x + y shards
            meta={"shard": i}))
        g.add_task(Task(
            f"dot{i}",
            ResourceProfile({"LUT": 14000, "DSP": 24, "BRAM": 8}),
            hbm_bytes=shard_bytes,               # w shard
            meta={"shard": i}))
    g.add_task(Task("reduce",
                    ResourceProfile({"LUT": 3000, "DSP": 8, "BRAM": 2})))
    for i in range(S):
        g.add_channel(f"axpy{i}", f"dot{i}", width_bits=512,
                      bytes_per_step=shard_bytes)
        g.add_channel(f"dot{i}", "reduce", width_bits=32,
                      bytes_per_step=ELEM_BYTES)
    return g


def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The operands :func:`bind_programs` streams: ``x``, ``y`` then ``w``,
    each [streams, rows, lanes] fp32 standard normal from ``spec["seed"]``."""
    return vector_inputs(graph, spec, "axpy", ("x", "y", "w"))


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    from ..exec.programs import ProgramBinding, resolve_device
    from ..kernels import (axpy_op, axpydot_op, dot_partials_op,
                           fold_partials)

    device = resolve_device(device)
    sp = shard_spec(graph, spec, "axpy")
    S, br, a = sp["S"], sp["br"], sp["a"]
    ops = on_device(make_inputs(graph, spec), device)

    mem_reads = {}
    for i in range(S):
        mem_reads[f"axpy{i}"] = {
            "x": [shard_rows(x, i, br) for x in ops["x"]],
            "y": [shard_rows(y, i, br) for y in ops["y"]]}
        mem_reads[f"dot{i}"] = {
            "w": [shard_rows(w, i, br) for w in ops["w"]]}

    def axpy_body(inputs):
        return axpy_op(a, inputs["x"], inputs["y"], block_rows=br)

    def dot_body_for(i):
        def body(inputs):
            return dot_partials_op(inputs[f"axpy{i}"], inputs["w"],
                                   block_rows=br)[0, 0]
        return body

    def reduce_body(inputs):
        return fold_partials([inputs[f"dot{i}"] for i in range(S)])

    programs = {}
    for i in range(S):
        programs[f"axpy{i}"] = axpy_body
        programs[f"dot{i}"] = dot_body_for(i)
    programs["reduce"] = reduce_body

    def reference():
        return torch.stack([axpydot_op(a, x, y, w, block_rows=br)
                            for x, y, w in zip(ops["x"], ops["y"], ops["w"])])

    return ProgramBinding(
        graph=graph, programs=programs, iterations=sp["streams"],
        mem_reads=mem_reads,
        finalize=lambda sinks: torch.stack(sinks["reduce"]),
        reference=reference, atol=0.0)
