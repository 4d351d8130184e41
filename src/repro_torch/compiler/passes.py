"""Registered compiler passes + the mutable state threaded through them.

Each pass is a plain function ``fn(state: CompileState) -> detail-dict``
registered under a name with :func:`register_pass`.  The pipeline runs the
requested names in order and records per-pass wall time plus the returned
detail dict in the artifact's ``pass_records``.

Adding a future pass (e.g. congestion-aware re-partition) is::

    @register_pass("repartition_congested")
    def repartition_congested(state):
        ...
        return {"moved": n}

and then ``CompileOptions(passes=(..., "repartition_congested", ...))``.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core import floorplan as _floorplan
from ..core import partitioner as _partitioner
from ..core import pipelining as _pipelining
from ..core.costmodel import ScheduleResult, simulate
from ..core.floorplan import Floorplan, TPU_POD_GRID, U55C_GRID
from ..core.graph import ResourceProfile, TaskGraph
from ..core.partitioner import Partition
from ..core.pipelining import PipelineReport
from ..core.topology import Cluster
from .options import CompileOptions


class CompileError(RuntimeError):
    """A pass could not run (bad pipeline order / missing prerequisite)."""


@dataclasses.dataclass
class CompileState:
    """Mutable scratchpad threaded through the passes of one compile()."""

    graph: TaskGraph                     # caller's graph, original units
    cluster: Cluster                     # caller's cluster, never mutated
    options: CompileOptions
    # Solver-facing views (scaled copies); identical to the originals until
    # the normalize_units pass runs.  work_graph shares the original's
    # Channel objects so pipelining depths land on the caller's graph.
    work_graph: TaskGraph = None  # type: ignore[assignment]
    work_cluster: Cluster = None  # type: ignore[assignment]
    unit_scale: Dict[str, float] = dataclasses.field(default_factory=dict)
    partition: Optional[Partition] = None
    floorplans: Dict[int, Floorplan] = dataclasses.field(default_factory=dict)
    pipeline_report: Optional[PipelineReport] = None
    schedule: Optional[ScheduleResult] = None
    # Network fabric + projected per-link traffic (congestion_feedback pass;
    # typed loosely to keep repro.compiler importable without repro.net).
    fabric: Optional[object] = None          # net.fabric.Fabric
    congestion: Optional[object] = None      # net.congestion.CongestionReport
    # HBM bank model + projected per-bank demand (memory_feedback pass;
    # loosely typed for the same import-cycle reason as fabric above).
    mem_config: Optional[object] = None      # mem.banks.MemConfig
    mem_contention: Optional[object] = None  # mem.contention.MemContentionReport
    bank_map: Optional[Dict[str, int]] = None
    # Per-compile() memo of solver inputs (pair-cost matrix, per-task area
    # vectors, topological order) so the passes stop recomputing them.
    _memo: Dict[object, object] = dataclasses.field(default_factory=dict,
                                                    repr=False)

    def __post_init__(self):
        if self.work_graph is None:
            self.work_graph = self.graph
        if self.work_cluster is None:
            self.work_cluster = self.cluster

    def scale_vector(self, kinds) -> np.ndarray:
        return np.array([self.unit_scale.get(k, 1.0) for k in kinds])

    # -- memoized solver inputs (valid for the lifetime of one compile()) --
    def pair_cost_matrix(self) -> np.ndarray:
        """dist×λ matrix of the cluster — identical for ``cluster`` and
        ``work_cluster`` (normalization only rescales device resources)."""
        key = ("pair_cost", id(self.work_cluster))
        if key not in self._memo:
            # The cluster reference in the value pins the id against reuse
            # (a freed object's id can be recycled by a later allocation).
            self._memo[key] = (
                self.work_cluster,
                _partitioner._pair_cost_matrix(self.work_cluster))
        return self._memo[key][1]

    def areas(self, kinds: Tuple[str, ...]) -> Dict[str, np.ndarray]:
        """Per-task resource vectors of ``work_graph`` over ``kinds``.

        Keyed by the work_graph identity AND the kinds tuple: normalize_units
        may swap work_graph mid-pipeline (custom pass orders), and the
        partition pass uses the graph's own resource kinds while the
        floorplan pass uses the device's.  Callers must not mutate the
        returned dict or its vectors.
        """
        key = ("areas", id(self.work_graph), tuple(kinds))
        if key not in self._memo:
            # Graph reference pins the id against reuse, as above.
            self._memo[key] = (self.work_graph,
                               _partitioner._areas(self.work_graph, kinds))
        return self._memo[key][1]

    def topo_order(self) -> List[str]:
        """Topological task order — shared by the pipelining and schedule
        passes (``work_graph`` shares the caller's channels and task order,
        so one order serves both views)."""
        if "topo_order" not in self._memo:
            self._memo["topo_order"] = self.graph.topo_order()
        return self._memo["topo_order"]


PassFn = Callable[[CompileState], Optional[Mapping[str, object]]]
PASS_REGISTRY: Dict[str, PassFn] = {}


def register_pass(name: str) -> Callable[[PassFn], PassFn]:
    def deco(fn: PassFn) -> PassFn:
        if name in PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        PASS_REGISTRY[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# normalize_units — solver-safe unit scaling (replaces the in-place area /
# capacity mutation that used to live in launch/plan.py).
# ---------------------------------------------------------------------------

# HiGHS is comfortable with coefficients up to ~1e7; raw TPU-scale values
# (bytes ~1e13, flops ~1e15) trip its numeric guards.  Anything already at
# FPGA scale (LUT counts ≤ ~8.4e6) passes through untouched, so scaling is
# the identity on the paper's own workloads.
_SAFE_MAX = 2.0 ** 24


def _pow2_scale(max_val: float) -> float:
    """Power-of-two s such that max_val/s lands in [1, _SAFE_MAX].

    Powers of two divide IEEE floats exactly, so area/s*s == area bit-for-bit
    — the round-trip guarantee the normalization tests assert.
    """
    if max_val <= 0.0:
        return 1.0
    if max_val > _SAFE_MAX:
        return 2.0 ** math.ceil(math.log2(max_val / _SAFE_MAX))
    if max_val < 1.0:
        return 2.0 ** math.floor(math.log2(max_val))
    return 1.0


@register_pass("normalize_units")
def normalize_units(state: CompileState):
    opts = state.options
    graph, cluster = state.graph, state.cluster

    # Work on a copy of the device resources: capacity overrides and
    # relaxations must never leak into the caller's (often module-global,
    # e.g. TPU_V5E) DeviceSpec.
    resources = dict(cluster.device.resources)
    if opts.capacity_override:
        resources.update(opts.capacity_override)
    for k in opts.relax_capacity_kinds:
        total = sum(t.area[k] for t in graph.tasks.values())
        resources[k] = opts.relax_capacity_slack * total

    scale: Dict[str, float] = {}
    if opts.normalize_units:
        for k in dict.fromkeys(list(graph.resource_kinds()) + list(resources)):
            peak = max([t.area[k] for t in graph.tasks.values()]
                       + [resources.get(k, 0.0)], default=0.0)
            scale[k] = _pow2_scale(peak)

    work_resources = {k: v / scale.get(k, 1.0) for k, v in resources.items()}
    work_device = dataclasses.replace(cluster.device,
                                      resources=work_resources)
    state.work_cluster = dataclasses.replace(cluster, device=work_device)

    if any(s != 1.0 for s in scale.values()):
        wg = TaskGraph(graph.name)
        for name, t in graph.tasks.items():
            wg.tasks[name] = dataclasses.replace(t, area=ResourceProfile(
                {k: v / scale.get(k, 1.0)
                 for k, v in t.area.amounts.items()}))
        wg.channels = graph.channels      # shared: depths reach the original
        state.work_graph = wg
    state.unit_scale = scale
    return {"scaled_kinds": sorted(k for k, s in scale.items() if s != 1.0),
            "overridden": sorted(opts.capacity_override or ()),
            "relaxed": sorted(opts.relax_capacity_kinds)}


# ---------------------------------------------------------------------------
# partition — inter-device ILP (Eq. 1–2).
# ---------------------------------------------------------------------------

@register_pass("partition")
def run_partition(state: CompileState):
    opts = state.options
    part = _partitioner.partition(
        state.work_graph, state.work_cluster,
        balance_kind=opts.balance_kind,
        balance_tol=opts.balance_tol,
        pins=dict(opts.pins) if opts.pins else None,
        exact_limit=opts.exact_limit,
        time_limit=opts.partition_time_limit,
        pair_cost=state.pair_cost_matrix(),
        areas=state.areas(state.work_graph.resource_kinds()))
    # Invariant: comm_cost and stats.objective come from the same
    # _objective evaluation — any drift means a broken Partition producer.
    if part.stats.objective != part.comm_cost:
        raise CompileError(
            f"Partition.stats.objective ({part.stats.objective}) drifted "
            f"from comm_cost ({part.comm_cost})")
    # Scale usage back to the caller's units (exact: power-of-two factors).
    if state.unit_scale:
        part = dataclasses.replace(
            part, usage=part.usage * state.scale_vector(part.kinds))
    state.partition = part
    return {"method": part.stats.method,
            "comm_cost": part.comm_cost,
            "objective": part.stats.objective,
            "solver_wall_time_s": part.stats.wall_time_s,
            "cut_channels": len(part.cut_channels)}


# ---------------------------------------------------------------------------
# floorplan — per-device slot placement (Eq. 4).
# ---------------------------------------------------------------------------

def _default_grid(cluster: Cluster):
    return (TPU_POD_GRID if cluster.device.name.startswith("tpu")
            else U55C_GRID)


@register_pass("floorplan")
def run_floorplan(state: CompileState):
    opts = state.options
    if state.partition is None:
        raise CompileError("floorplan pass requires a partition pass first")
    part = state.partition
    grid = opts.grid or _default_grid(state.cluster)
    # The interconnect IP (paper §4.4, Table 10) is pre-placed area: the
    # floorplanner packs tasks into the device net of it.
    capacity = state.work_cluster.effective_resources()
    hbm_set = set(opts.hbm_tasks)
    if opts.floorplan_devices is not None:
        # An explicitly requested device must be plannable: an empty or
        # out-of-range entry would otherwise surface much later as a bare
        # KeyError on design.floorplans[d].
        bad = [d for d in opts.floorplan_devices
               if not (0 <= d < part.num_devices())
               or not part.device_tasks(d)]
        if bad:
            raise CompileError(
                f"floorplan_devices {bad} received no tasks (cluster has "
                f"{part.num_devices()} devices); drop them or leave "
                "floorplan_devices unset to plan every occupied device")
        devices = opts.floorplan_devices
    else:
        devices = range(part.num_devices())
    for d in devices:
        tasks = part.device_tasks(d)
        if not tasks:
            continue
        fp = _floorplan.floorplan_device(
            state.work_graph, tasks, capacity,
            grid=grid,
            threshold=opts.floorplan_threshold,
            hbm_tasks=[t for t in tasks if t in hbm_set],
            time_limit=opts.floorplan_time_limit,
            strict=opts.floorplan_strict,
            areas=state.areas(tuple(capacity.keys())))
        if state.unit_scale:
            fp = dataclasses.replace(
                fp, usage=fp.usage * state.scale_vector(fp.kinds))
        state.floorplans[d] = fp
    return {"devices": sorted(state.floorplans),
            "congested": sorted(d for d, fp in state.floorplans.items()
                                if fp.congested),
            "total_wirelength": sum(fp.wirelength
                                    for fp in state.floorplans.values())}


# ---------------------------------------------------------------------------
# pipeline_interconnect — §4.6 register insertion + cut-set balancing.
# ---------------------------------------------------------------------------

@register_pass("pipeline_interconnect")
def run_pipeline_interconnect(state: CompileState):
    if state.partition is None:
        # The core function tolerates partition=None (all co-located), but
        # inside the pipeline that composition is a mistake: it would
        # silently write min-depth FIFOs onto the caller's graph.
        raise CompileError(
            "pipeline_interconnect pass requires a partition pass first")
    rep = _pipelining.pipeline_interconnect(
        state.graph, state.partition,
        floorplans=state.floorplans or None,
        cluster=state.cluster,
        min_depth=state.options.min_depth,
        order=state.topo_order())
    state.pipeline_report = rep
    return {"num_crossings": rep.num_crossings,
            "max_crossing": rep.max_crossing}


# ---------------------------------------------------------------------------
# congestion_feedback — §4.3 congestion control over the network fabric
# (repro_torch.net).  The body lives in repro_torch.net.calibrate; the
# deferred import keeps the pass registered even when repro_torch.net is
# never touched and avoids a compiler<->net import cycle.
# ---------------------------------------------------------------------------

@register_pass("congestion_feedback")
def run_congestion_feedback(state: CompileState):
    if state.partition is None:
        raise CompileError(
            "congestion_feedback pass requires a partition pass first")
    from ..net.calibrate import congestion_feedback_pass
    try:
        return congestion_feedback_pass(state)
    except RuntimeError as e:               # fabric/cluster mismatch etc.
        raise CompileError(str(e)) from e


# ---------------------------------------------------------------------------
# memory_feedback — HBM bank-bandwidth demand charged into the partition
# (repro_torch.mem).  Deferred import: avoids a compiler<->mem import cycle.
# ---------------------------------------------------------------------------

@register_pass("memory_feedback")
def run_memory_feedback(state: CompileState):
    if state.partition is None:
        raise CompileError(
            "memory_feedback pass requires a partition pass first")
    from ..mem.calibrate import memory_feedback_pass
    try:
        return memory_feedback_pass(state)
    except RuntimeError as e:
        raise CompileError(str(e)) from e


# ---------------------------------------------------------------------------
# schedule — event-driven cost-model simulation (§5).
# ---------------------------------------------------------------------------

@register_pass("schedule")
def run_schedule(state: CompileState):
    opts = state.options
    if state.partition is None:
        raise CompileError("schedule pass requires a partition pass first")
    ndev = state.cluster.num_devices
    freq = opts.freq_hz
    if freq is None:
        f = state.cluster.device.max_freq_hz or 1.0
        freqs = {d: f for d in range(ndev)}
    elif isinstance(freq, collections.abc.Mapping):
        freqs = {int(d): float(f) for d, f in freq.items()}
    else:
        freqs = {d: float(freq) for d in range(ndev)}
    state.schedule = simulate(
        state.graph, state.partition, state.cluster, freqs,
        overlap=opts.overlap, hbm_efficiency=opts.hbm_efficiency,
        order=state.topo_order())
    return {"makespan_s": state.schedule.makespan,
            "comm_time_s": state.schedule.comm_time}
