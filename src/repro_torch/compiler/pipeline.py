"""`CompilerPipeline` + the one-call `compile()` entry point."""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

from ..core.graph import TaskGraph
from ..core.topology import Cluster
from .artifact import CompiledDesign, PassRecord
from .options import CompileOptions
from .passes import PASS_REGISTRY, CompileError, CompileState

# The full TAPA-CS flow, in paper order: unit shaping, Eq. 1–2 inter-device
# partition, Eq. 4 per-device floorplan, §4.6 interconnect pipelining, §5
# cost-model schedule.
DEFAULT_PASSES: Tuple[str, ...] = (
    "normalize_units",
    "partition",
    "floorplan",
    "pipeline_interconnect",
    "schedule",
)

# With an explicit network fabric (options.fabric), the §4.3 congestion
# feedback runs right after partition so floorplan/pipelining/schedule see
# the (possibly repartitioned) congestion-controlled assignment.
FABRIC_PASSES: Tuple[str, ...] = (
    "normalize_units",
    "partition",
    "congestion_feedback",
    "floorplan",
    "pipeline_interconnect",
    "schedule",
)


class CompilerPipeline:
    """An ordered sequence of registered passes over one CompileState."""

    def __init__(self, passes: Sequence[str] = DEFAULT_PASSES):
        unknown = [p for p in passes if p not in PASS_REGISTRY]
        if unknown:
            raise CompileError(
                f"unknown pass(es) {unknown}; registered: "
                f"{sorted(PASS_REGISTRY)}")
        self.passes: Tuple[str, ...] = tuple(passes)

    def run(self, graph: TaskGraph, cluster: Cluster,
            options: Optional[CompileOptions] = None) -> CompiledDesign:
        options = options or CompileOptions()
        if (options.passes is not None
                and tuple(options.passes) != self.passes):
            raise CompileError(
                f"options.passes={tuple(options.passes)} conflicts with "
                f"this pipeline's passes={self.passes}; drop one of the "
                "two specifications (compile() builds the pipeline from "
                "options.passes)")
        state = CompileState(graph=graph, cluster=cluster, options=options)
        records = []
        for name in self.passes:
            t0 = time.perf_counter()
            detail = PASS_REGISTRY[name](state) or {}
            records.append(PassRecord(name, time.perf_counter() - t0,
                                      dict(detail)))
        return CompiledDesign(
            graph=graph,
            cluster=cluster,
            options=options,
            partition=state.partition,
            floorplans=dict(state.floorplans),
            pipeline_report=state.pipeline_report,
            schedule=state.schedule,
            unit_scale=dict(state.unit_scale),
            pass_records=tuple(records),
            fabric=state.fabric if state.fabric is not None
            else options.fabric,
            congestion=state.congestion,
            mem_config=state.mem_config if state.mem_config is not None
            else options.mem,
            mem_contention=state.mem_contention,
            bank_map=dict(state.bank_map) if state.bank_map else None)


def compile(graph: TaskGraph, cluster: Cluster,  # noqa: A001 - deliberate
            options: Optional[CompileOptions] = None) -> CompiledDesign:
    """Compile ``graph`` onto ``cluster`` through the whole TAPA-CS flow.

    The one entry point replacing the hand-wired partition → floorplan →
    pipeline → schedule chains.  ``options.passes`` selects a sub-pipeline
    when a caller only needs part of the flow (e.g. launch/plan.py skips
    floorplan + schedule).
    """
    options = options or CompileOptions()
    if options.passes is not None:
        passes = options.passes
    else:
        passes = FABRIC_PASSES if options.fabric is not None \
            else DEFAULT_PASSES
        if options.mem is not None:
            # Bank demand is charged right after the (possibly
            # congestion-repartitioned) assignment settles, and before
            # floorplan/schedule consume it.
            passes = list(passes)
            anchor = ("congestion_feedback" if "congestion_feedback"
                      in passes else "partition")
            passes.insert(passes.index(anchor) + 1, "memory_feedback")
            passes = tuple(passes)
    return CompilerPipeline(passes).run(graph, cluster, options)
