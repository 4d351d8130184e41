"""Memory feedback into the compiler — bank-bandwidth demand charged next
to link demand, the way the network layer's ``net.calibrate`` charges
congestion.  A copy of the JAX package's ``mem/calibrate.py``.

The partitioner's Eq. 1 caps per-device *area*; nothing in the seed flow
stopped it from stacking every HBM reader on one device — or the bank
binder from stacking them on one bank.  This module closes that loop:

* :func:`rebalance_bank_map` — deterministic LPT (longest-processing-time)
  bin packing of each device's HBM readers over its banks: heaviest
  declared demand first, always onto the least-loaded bank.  This is the
  cheap fix — §4.5 channel binding redone against measured demand — and
  it overrides a task's declared ``meta["hbm_bank"]`` pin.
* :func:`membound_pair_partition` — when even a perfect per-device spread
  leaves a bank hot (the *device aggregate* exceeds its banks' service),
  re-run the Eq. 1–2 partition with a synthetic ``hbm_bank_frac``
  resource: each task demands ``hbm_bytes / (bank_bandwidth × step)``
  bank-fractions, each device caps at ``threshold × banks_per_device`` —
  bank bandwidth becomes a first-class Eq. 1 capacity alongside LUTs.
  Accepted repartitions re-tag ``partition.stats.method`` with
  ``"-membound"``.
* :func:`memory_feedback_pass` — the registered compiler pass stringing
  the two together: project → re-map → (if still hot) re-partition →
  re-map, keeping whichever stage last improved the projection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..core.graph import ResourceProfile, TaskGraph
from .banks import MemConfig
from .contention import MemContentionReport, default_bank_map, project

# Synthetic resource kind for the membound repartition: per-task demand in
# *bank fractions* (offered utilization of one bank), per-device capacity in
# banks.  Dimensionless and O(1–10), so it never needs unit normalization.
MEM_KIND = "hbm_bank_frac"


def rebalance_bank_map(graph: TaskGraph, assignment: Dict[str, int],
                       config: MemConfig) -> Dict[str, int]:
    """LPT bin packing of each device's HBM readers over its banks."""
    by_dev: Dict[int, List[str]] = {}
    for name, task in graph.tasks.items():
        if task.hbm_bytes > 0:
            by_dev.setdefault(assignment[name], []).append(name)
    out: Dict[str, int] = {}
    for dev, names in by_dev.items():
        # Heaviest first; name tie-break keeps the map deterministic.
        names.sort(key=lambda n: (-graph.tasks[n].hbm_bytes, n))
        loads = [0.0] * config.banks_per_device
        for n in names:
            bank = loads.index(min(loads))
            out[n] = bank
            loads[bank] += graph.tasks[n].hbm_bytes
    return out


def _bank_fraction(task, config: MemConfig, step_time_s: float) -> float:
    return float(task.hbm_bytes) / (config.bank_bandwidth_Bps * step_time_s)


def membound_pair_partition(state, config: MemConfig, *,
                            threshold: float, step_time_s: float):
    """Re-run Eq. 1–2 with bank bandwidth as a capacity (see module doc).

    Returns the new :class:`~repro_torch.core.partitioner.Partition` (usage in
    solver units — the caller rescales), or None when the augmented model
    cannot be made feasible (a single task demanding more than a whole
    device's banks: no partition can fix that).
    """
    from ..core import partitioner as _partitioner
    graph, cluster = state.work_graph, state.work_cluster
    fracs = {n: _bank_fraction(t, config, step_time_s)
             for n, t in graph.tasks.items()}
    demand = sum(fracs.values())
    ndev = cluster.num_devices
    # Cap at threshold × banks so a feasible spread leaves every bank cool
    # after LPT; floor at what feasibility itself requires.
    cap = max(threshold * config.banks_per_device,
              1.01 * demand / max(1, ndev),
              1.001 * max(fracs.values(), default=0.0))
    if max(fracs.values(), default=0.0) > config.banks_per_device:
        return None                    # one task outruns a whole device
    aug = TaskGraph(graph.name)
    for name, t in graph.tasks.items():
        amounts = dict(t.area.amounts)
        amounts[MEM_KIND] = fracs[name]
        aug.tasks[name] = dataclasses.replace(
            t, area=ResourceProfile(amounts))
    aug.channels = graph.channels        # shared, like normalize_units
    # Eq. 1 rows use cluster.capacity(kind) = raw × (1 - overhead) × T;
    # invert that derating so the solver's effective cap is exactly `cap`.
    derate = ((1.0 - cluster.interconnect_overhead_frac(MEM_KIND))
              * cluster.utilization_threshold)
    device = dataclasses.replace(
        cluster.device,
        resources={**cluster.device.resources, MEM_KIND: cap / derate})
    aug_cluster = dataclasses.replace(cluster, device=device)
    opts = state.options
    return _partitioner.partition(
        aug, aug_cluster,
        balance_kind=opts.balance_kind,
        balance_tol=opts.balance_tol,
        pins=dict(opts.pins) if opts.pins else None,
        exact_limit=opts.exact_limit,
        time_limit=opts.partition_time_limit,
        pair_cost=state.pair_cost_matrix())


def memory_feedback_pass(state) -> Dict[str, object]:
    """Body of the registered ``memory_feedback`` compiler pass.

    ``state`` is a ``repro_torch.compiler.passes.CompileState``
    (duck-typed, as in the network layer's ``congestion_feedback_pass``).
    """
    opts = state.options
    if state.partition is None:
        raise RuntimeError(
            "memory_feedback pass requires a partition pass first")
    config: MemConfig = getattr(opts, "mem", None) or MemConfig()
    threshold = opts.mem_threshold
    step_time = opts.mem_step_time_s or config.sweep_time_s

    assignment = state.partition.assignment
    bank_map = default_bank_map(state.graph, assignment, config)
    report = project(state.graph, assignment, config,
                     bank_map=bank_map, step_time_s=step_time)
    before_util = report.max_utilization
    before_cost = state.partition.comm_cost
    detail: Dict[str, object] = {
        "threshold": threshold,
        "max_utilization_before": before_util,
        "hotspots_before": [b.name for b in report.hotspots(threshold)],
        "remapped": False,
        "repartitioned": False,
    }

    # Stage 1 — re-map task→bank within each device (cheap, no solver).
    if report.hotspots(threshold):
        new_map = rebalance_bank_map(state.graph, assignment, config)
        new_report = project(state.graph, assignment, config,
                             bank_map=new_map, step_time_s=step_time)
        if new_report.max_utilization < report.max_utilization:
            bank_map, report = new_map, new_report
            detail["remapped"] = True

    # Stage 2 — the device aggregate itself is the problem: repartition
    # with bank bandwidth as an Eq. 1 capacity, then re-map on the result.
    if report.hotspots(threshold) and opts.mem_repartition:
        part = membound_pair_partition(state, config, threshold=threshold,
                                       step_time_s=step_time)
        if part is not None:
            new_map = rebalance_bank_map(state.graph, part.assignment,
                                         config)
            new_report = project(state.graph, part.assignment, config,
                                 bank_map=new_map, step_time_s=step_time)
            if new_report.max_utilization < report.max_utilization:
                if state.unit_scale:
                    part = dataclasses.replace(
                        part,
                        usage=part.usage * state.scale_vector(part.kinds))
                part = dataclasses.replace(
                    part, stats=dataclasses.replace(
                        part.stats,
                        method=part.stats.method + "-membound"))
                state.partition = part
                bank_map, report = new_map, new_report
                detail["repartitioned"] = True

    state.mem_config = config
    state.mem_contention = report
    state.bank_map = bank_map
    detail.update({
        "max_utilization_after": report.max_utilization,
        "hotspots_after": [b.name for b in report.hotspots(threshold)],
        "comm_cost_before": before_cost,
        "comm_cost_after": state.partition.comm_cost,
        "method": state.partition.stats.method,
        "bank_map": dict(bank_map),
    })
    return detail
