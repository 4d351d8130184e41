"""Congestion feedback into the compiler — §4.3's claim made executable.

The partitioner prices a cut channel at ``width × dist × λ`` (Eq. 2) with λ
a per-protocol *constant*.  This module closes the loop the way TAPA's
measured-interconnect feedback closes it for floorplanning:

* :func:`route_comm_cost` re-evaluates Eq. 2 **per link** over a fabric
  route (Σ width × λ(link)) — identical to the constant form on a uniform
  fabric, and the ground truth for the λ cross-check (a PCIe Gen3x16 route
  must cost exactly 12.5× the 100 G Ethernet route on identical traffic);
* :func:`calibrated_pair_cost` turns a per-link congestion report into a
  new device-pair cost matrix: every link's λ is inflated by its measured
  (or projected) excess utilization, so routes through hotspots look as
  expensive to the solver as they are on the wire;
* :func:`congestion_feedback_pass` is the registered compiler pass
  (``CompileOptions(passes=(..., "congestion_feedback", ...))`` or any
  compile with ``options.fabric`` set): project per-link traffic from the
  current partition, and when a link exceeds ``congestion_threshold``,
  re-run the partition against the calibrated pair costs — on a shared
  bus additionally dropping the compute-balance band (§4.3: congestion
  control takes precedence over load balancing when the two conflict).
  Accepted retries re-tag ``partition.stats.method`` with ``"-congested"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import partitioner as _partitioner
from ..core.topology import lam
from .congestion import CongestionReport, project
from .fabric import Fabric, cluster_fabric


def route_comm_cost(fabric: Fabric, i: int, j: int,
                    width_bits: float) -> float:
    """Eq. 2 for one logical channel, evaluated link by link."""
    return fabric.route_cost(i, j, width_bits)


def lambda_crosscheck(fabric_a: Fabric, fabric_b: Fabric,
                      traffic: List[Tuple[int, int, float]]
                      ) -> Dict[str, float]:
    """Cost ratio of two fabrics on identical routed traffic.

    ``traffic`` is ``[(src_dev, dst_dev, width_bits)]``.  For the paper's
    protocols the Ethernet-vs-PCIe ratio must be λ(PCIe)/λ(Ethernet) = 12.5
    exactly (same routes, per-link λ scaling only).
    """
    cost_a = sum(route_comm_cost(fabric_a, s, d, w) for s, d, w in traffic)
    cost_b = sum(route_comm_cost(fabric_b, s, d, w) for s, d, w in traffic)
    return {"cost_a": cost_a, "cost_b": cost_b,
            "ratio": cost_b / cost_a if cost_a else float("inf")}


def calibrated_pair_cost(fabric: Fabric, report: CongestionReport, *,
                         threshold: float,
                         penalty: float = 2.0) -> np.ndarray:
    """Device-pair cost matrix with per-link congestion inflation.

    cost[i, j] = Σ_{l ∈ route(i,j)} λ(l) × (1 + penalty × excess(l)) where
    ``excess`` is the link's utilization overshoot past ``threshold``
    (0 for cool links — the matrix degrades to the fabric's exact Eq. 2
    valuation, which on uniform fabrics equals the cluster's dist×λ).
    """
    inflation = [1.0 + penalty
                 * max(0.0, report.link(l.index).utilization - threshold)
                 / max(threshold, 1e-12)
                 for l in fabric.links]
    n = fabric.num_devices
    m = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                m[i, j] = sum(lam(fabric.links[li].protocol) * inflation[li]
                              for li in fabric.route(i, j))
    return m


def _uniform_scaling(pair: np.ndarray, base: np.ndarray) -> bool:
    """True when ``pair`` is one scalar multiple of ``base`` on every
    off-diagonal entry — such a calibration cannot change the partition
    MILP's argmin (the objective just rescales)."""
    mask = base > 0
    if not mask.any():
        return True
    ratios = pair[mask] / base[mask]
    return bool(np.all(np.abs(ratios - ratios.flat[0]) < 1e-12))


def congestion_feedback_pass(state) -> Dict[str, object]:
    """Body of the registered ``congestion_feedback`` compiler pass.

    ``state`` is a ``repro_torch.compiler.passes.CompileState`` (duck-typed here
    to keep ``repro_torch.net`` importable without the compiler package).
    """
    opts = state.options
    if state.partition is None:
        raise RuntimeError(
            "congestion_feedback pass requires a partition pass first")
    fabric: Optional[Fabric] = getattr(opts, "fabric", None)
    if fabric is None:
        fabric = cluster_fabric(state.cluster)
    if fabric.num_devices != state.cluster.num_devices:
        raise RuntimeError(
            f"options.fabric spans {fabric.num_devices} devices but the "
            f"cluster has {state.cluster.num_devices}")
    state.fabric = fabric
    threshold = opts.congestion_threshold
    step_time = opts.congestion_step_time_s

    # state.graph shares Channel objects with work_graph, and channel
    # payloads are never unit-scaled — project on the caller's graph.
    report = project(state.graph, state.partition.assignment, fabric,
                     step_time_s=step_time)
    before_util = report.max_utilization
    before_cost = state.partition.comm_cost
    hotspots = [l.name for l in report.hotspots(threshold)]
    detail: Dict[str, object] = {
        "threshold": threshold,
        "max_utilization_before": before_util,
        "hotspots_before": hotspots,
        "retries": 0,
        "repartitioned": False,
    }
    # A repartition can only help if the calibrated costs change the
    # objective's argmin or the constraint set changes (the balance band
    # dropping).  Uniformly scaled pair costs — symmetric traffic heating
    # every used link by the same relative excess — provably cannot, so
    # skip the (expensive) re-solve outright in that case.
    base_pair = calibrated_pair_cost(
        fabric, report, threshold=float("inf"), penalty=0.0)
    balance_drops = (opts.congestion_relax_balance
                     and opts.balance_kind is not None)

    retries = 0
    while (report.hotspots(threshold)
           and retries < opts.congestion_max_retries):
        pair = calibrated_pair_cost(fabric, report, threshold=threshold,
                                    penalty=opts.congestion_penalty)
        if not balance_drops and _uniform_scaling(pair, base_pair):
            detail["calibration_uniform"] = True
            break
        retries += 1
        # §4.3: when congestion control and load balancing conflict, the
        # paper resolves for congestion — drop the balance band so the
        # solver may consolidate traffic off the hot links.
        balance = (None if opts.congestion_relax_balance
                   else opts.balance_kind)
        part = _partitioner.partition(
            state.work_graph, state.work_cluster,
            balance_kind=balance,
            balance_tol=opts.balance_tol,
            pins=dict(opts.pins) if opts.pins else None,
            exact_limit=opts.exact_limit,
            time_limit=opts.partition_time_limit,
            pair_cost=pair,
            areas=state.areas(state.work_graph.resource_kinds()))
        new_report = project(state.graph, part.assignment, fabric,
                             step_time_s=step_time)
        if new_report.max_utilization >= report.max_utilization:
            break                              # no improvement — keep best
        if state.unit_scale:
            part = dataclasses.replace(
                part, usage=part.usage * state.scale_vector(part.kinds))
        part = dataclasses.replace(
            part, stats=dataclasses.replace(
                part.stats, method=part.stats.method + "-congested"))
        state.partition = part
        report = new_report
        detail["repartitioned"] = True
    state.congestion = report
    detail.update({
        "retries": retries,
        "max_utilization_after": report.max_utilization,
        "hotspots_after": [l.name for l in report.hotspots(threshold)],
        "comm_cost_before": before_cost,
        "comm_cost_after": state.partition.comm_cost,
        "method": state.partition.stats.method,
    })
    return detail
