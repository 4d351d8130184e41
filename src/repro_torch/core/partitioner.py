"""Inter-device ILP partitioner — paper §4.3 (C2), Eq. 1–2.

Assign every task v to a device F_d minimizing

    Σ_{e_ij ∈ E}  e_ij.width × dist(F_i, F_j) × λ            (Eq. 2)

subject to per-device, per-resource-kind capacity (Eq. 1):

    Σ_{v on d} v_area[k]  <  T × capacity[d, k]

plus an optional compute-balance band (the paper's "compute-load between the
multiple FPGAs is balanced").  Exact solution via HiGHS branch-and-cut with
the standard product linearization; recursive two-way partitioning (the
paper's intra-FPGA scheme, §4.5) for large instances; KL polish either way.

The partitioner deliberately does NOT always return the min-cut: a module is
moved off-chip when keeping it co-located would violate the congestion
threshold (paper §4.3 last paragraph) — that is exactly the Eq. 1 constraint
binding.

Fast path (PR 3): the exact model is emitted through the bulk COO APIs of
:class:`repro.core.ilp.Model`; symmetric ``pair_cost`` matrices (every
ring/mesh/daisy-chain cluster) get one linearization variable per *unordered*
device pair (half the w-vars); and a first-fit-decreasing + KL warm start is
computed up front so a branch-and-cut ``time_limit`` degrades gracefully to a
feasible solution instead of raising :class:`ILPError`.  The original
dict-row construction is kept as ``_solve_exact_reference`` — the golden
baseline for ``benchmarks/perf.py`` and the equivalence tests — selected via
``partition(..., use_reference=True)`` together with
:func:`repro.core.ilp.kl_refine_reference`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import TaskGraph, Channel
from .ilp import (ILPError, Model, SolveStats, add_abs_diff_cost_vars,
                  add_cut_cost_vars, kl_refine, kl_refine_reference)
from .topology import Cluster


@dataclasses.dataclass
class Partition:
    """Result of inter-device partitioning.

    ``comm_cost`` and ``stats.objective`` are both derived from the single
    :func:`_objective` evaluation in :func:`partition` — they must stay
    equal; ``repro.compiler``'s partition pass enforces that invariant.
    """

    assignment: Dict[str, int]            # task -> device id
    comm_cost: float                      # Eq. 2 objective value
    cut_channels: List[Channel]           # channels crossing devices
    usage: np.ndarray                     # [device, kind] resource usage
    kinds: Tuple[str, ...]
    stats: SolveStats

    def device_tasks(self, d: int) -> List[str]:
        return [t for t, dd in self.assignment.items() if dd == d]

    def num_devices(self) -> int:
        """True cluster size, including devices that received no tasks.

        Derived from the usage matrix (one row per cluster device) rather
        than ``max(assignment)+1``, which undercounted clusters whose
        highest-indexed devices were left empty.
        """
        usage = np.asarray(self.usage)
        if usage.ndim == 2:
            return int(usage.shape[0])
        return int(max(self.assignment.values())) + 1 if self.assignment else 0


def _pair_cost_matrix(cluster: Cluster) -> np.ndarray:
    n = cluster.num_devices
    m = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            m[i, j] = cluster.comm_cost(i, j, width_bits=1.0)
    return m


def _areas(graph: TaskGraph, kinds: Sequence[str]) -> Dict[str, np.ndarray]:
    return {name: np.array([t.area[k] for k in kinds], dtype=float)
            for name, t in graph.tasks.items()}


def _objective(graph: TaskGraph, assign: Dict[str, int],
               cluster: Cluster) -> float:
    return sum(cluster.comm_cost(assign[c.src], assign[c.dst], c.width_bits)
               for c in graph.channels)


def _usage(graph: TaskGraph, assign: Dict[str, int], kinds: Sequence[str],
           ndev: int, areas: Optional[Dict[str, np.ndarray]] = None
           ) -> np.ndarray:
    u = np.zeros((ndev, len(kinds)))
    if areas is None:
        areas = _areas(graph, kinds)
    for v, d in assign.items():
        u[d] += areas[v]
    return u


def _check_capacity(usage: np.ndarray, caps: np.ndarray) -> bool:
    return bool(np.all(usage <= caps + 1e-6))


def partition(graph: TaskGraph, cluster: Cluster, *,
              balance_kind: Optional[str] = None,
              balance_tol: float = 0.35,
              pins: Optional[Dict[str, int]] = None,
              exact_limit: int = 20000,
              time_limit: float = 60.0,
              pair_cost: Optional[np.ndarray] = None,
              areas: Optional[Dict[str, np.ndarray]] = None,
              use_reference: bool = False) -> Partition:
    """Partition ``graph`` onto ``cluster`` (Eq. 1–2).

    balance_kind: resource kind whose per-device totals must stay within
        ±balance_tol of the mean (compute-load balancing).
    pins: task -> device pre-assignments (e.g. HBM-reading sources on the
        device owning the data, paper Fig. 4's blue modules).
    exact_limit: max (#edges × #device-pairs) for the exact product
        formulation; larger instances use recursive bisection + KL polish.
    pair_cost / areas: optional precomputed ``_pair_cost_matrix(cluster)`` /
        ``_areas(graph, kinds)`` — the compiler pipeline memoizes them per
        compile() so repeated passes stop recomputing.
    use_reference: run the legacy dict-row exact model + pure-Python KL
        refiner (golden baseline for perf/equivalence testing).
    """
    graph.validate()
    t0 = time.perf_counter()
    ndev = cluster.num_devices
    kinds = graph.resource_kinds()
    pins = pins or {}
    if areas is None:
        areas = _areas(graph, kinds)

    if ndev == 1:
        assign = {v: 0 for v in graph.tasks}
        usage = _usage(graph, assign, kinds, 1, areas)
        stats = SolveStats(graph.name, len(graph.tasks), 1,
                           time.perf_counter() - t0, 0.0, "trivial")
        return Partition(assign, 0.0, [], usage, kinds, stats)

    if pair_cost is None:
        pair_cost = _pair_cost_matrix(cluster)
    npairs = ndev * (ndev - 1) // 2
    problem_size = max(1, len(graph.channels)) * npairs
    if problem_size <= exact_limit:
        if use_reference:
            assign, method = _solve_exact_reference(
                graph, cluster, kinds, balance_kind, balance_tol, pins,
                time_limit)
        else:
            assign, method = _solve_exact(
                graph, cluster, kinds, balance_kind, balance_tol, pins,
                time_limit, areas, pair_cost)
    else:
        assign, method = _solve_recursive(graph, cluster, kinds, balance_kind,
                                          balance_tol, pins, time_limit,
                                          areas, use_reference=use_reference,
                                          pair_cost=pair_cost)

    # KL polish (never worsens comm; respects capacity).  Skipped when a
    # balance band is active — single-move refinement is blind to it and
    # would re-merge everything onto one device.
    caps = np.array([[cluster.capacity(k) for k in kinds]
                     for _ in range(ndev)])
    if balance_kind is None:
        edges = [(c.src, c.dst, float(c.width_bits)) for c in graph.channels]
        pinned = set(pins)
        refine = kl_refine_reference if use_reference else kl_refine
        movable_assign = refine(
            {v: d for v, d in assign.items() if v not in pinned},
            [(u, v, w) for (u, v, w) in edges
             if u not in pinned and v not in pinned],
            pair_cost, areas, caps)
        assign.update(movable_assign)

    usage = _usage(graph, assign, kinds, ndev, areas)
    if not _check_capacity(usage, caps):
        raise ILPError("partition violates Eq.1 capacity after refinement")
    obj = _objective(graph, assign, cluster)
    cut = [c for c in graph.channels if assign[c.src] != assign[c.dst]]
    # One _objective evaluation feeds BOTH Partition.comm_cost and
    # stats.objective so the two can never drift.
    stats = SolveStats(graph.name, len(graph.tasks), ndev,
                       time.perf_counter() - t0, obj, method)
    return Partition(assign, obj, cut, usage, kinds, stats)


# ---------------------------------------------------------------------------
# Exact product-linearized MILP (vectorized COO build + KL warm start).
# ---------------------------------------------------------------------------

def _build_exact_model(graph: TaskGraph, cluster: Cluster, kinds,
                       balance_kind, balance_tol, pins,
                       areas: Dict[str, np.ndarray],
                       pair_cost: np.ndarray):
    """Emit the Eq. 1–2 MILP through the bulk COO APIs.

    Returns ``(model, xcols, cut, nodes, e_src, e_dst)`` where ``xcols`` is
    the ``[task, device]`` matrix of assignment-variable ids and ``cut``
    describes the linearization block (None for edge-free graphs).
    """
    ndev = cluster.num_devices
    nodes = graph.task_names()
    nv = len(nodes)
    nidx = {v: i for i, v in enumerate(nodes)}
    amat = (np.stack([areas[v] for v in nodes])
            if nodes else np.zeros((0, len(kinds))))

    m = Model(f"partition[{graph.name}]")
    xstart = m.add_vars(nv * ndev, 0.0, 1.0, integer=True)
    xcols = (xstart + np.arange(nv * ndev, dtype=np.intp)).reshape(nv, ndev)
    m.add_eq_rows(xcols, np.ones((nv, ndev)), 1.0)
    for v, d in pins.items():
        m.add_eq({int(xcols[nidx[v], d]): 1.0}, 1.0)

    # Eq. 1 capacity rows: one block of len(kinds) rows per device.
    caps = np.array([cluster.capacity(k) for k in kinds])
    if nv and kinds:
        for d in range(ndev):
            m.add_le_rows(np.broadcast_to(xcols[:, d], (len(kinds), nv)),
                          amat.T, caps)

    # Optional compute-balance band.
    if balance_kind is not None and balance_kind in kinds:
        ki = kinds.index(balance_kind)
        mean = amat[:, ki].sum() / ndev
        for d in range(ndev):
            m.add_rows(xcols[:, d][None, :], amat[:, ki][None, :],
                       (1 - balance_tol) * mean, (1 + balance_tol) * mean)

    # Eq. 2 objective via the shared linearization emitter (one w per
    # unordered device pair on symmetric clusters).
    e_src = np.array([nidx[c.src] for c in graph.channels], dtype=np.intp)
    e_dst = np.array([nidx[c.dst] for c in graph.channels], dtype=np.intp)
    e_w = np.array([float(c.width_bits) for c in graph.channels])
    cut = add_cut_cost_vars(m, xcols, e_src, e_dst, e_w, pair_cost)
    return m, xcols, cut, nodes, e_src, e_dst


def _warm_start_assign(graph: TaskGraph, cluster: Cluster, kinds,
                       areas: Dict[str, np.ndarray],
                       pair_cost: np.ndarray, balance_kind, balance_tol,
                       pins) -> Optional[Dict[str, int]]:
    """Cheap Eq. 1-feasible assignment: first-fit decreasing onto the
    least-loaded device, honoring pins, then KL polish.  None when greedy
    can't find a feasible placement (the MILP must decide feasibility)."""
    ndev = cluster.num_devices
    caps = np.array([[cluster.capacity(k) for k in kinds]
                     for _ in range(ndev)])
    usage = np.zeros_like(caps)
    assign: Dict[str, int] = {}
    for v, d in pins.items():
        assign[v] = d
        usage[d] += areas[v]
    if np.any(usage > caps + 1e-9):
        return None
    norm = np.maximum(caps[0], 1e-12) if kinds else np.ones(1)
    rest = sorted((v for v in graph.task_names() if v not in assign),
                  key=lambda v: -float((areas[v] / norm).max())
                  if kinds else 0.0)
    for v in rest:
        order = np.argsort((usage / norm[None, :]).max(axis=1),
                           kind="stable") if kinds else range(ndev)
        for d in order:
            if np.all(usage[d] + areas[v] <= caps[d] + 1e-9):
                assign[v] = int(d)
                usage[d] += areas[v]
                break
        else:
            return None
    if balance_kind is not None and balance_kind in kinds:
        ki = kinds.index(balance_kind)
        mean = sum(areas[v][ki] for v in graph.tasks) / ndev
        if (np.any(usage[:, ki] < (1 - balance_tol) * mean - 1e-9)
                or np.any(usage[:, ki] > (1 + balance_tol) * mean + 1e-9)):
            return None
    else:
        pinned = set(pins)
        polished = kl_refine(
            {v: d for v, d in assign.items() if v not in pinned},
            [(c.src, c.dst, float(c.width_bits)) for c in graph.channels
             if c.src not in pinned and c.dst not in pinned],
            pair_cost, areas, caps)
        assign.update(polished)
    return assign


def _solve_exact(graph: TaskGraph, cluster: Cluster, kinds, balance_kind,
                 balance_tol, pins, time_limit,
                 areas: Dict[str, np.ndarray],
                 pair_cost: np.ndarray) -> Tuple[Dict[str, int], str]:
    m, xcols, cut, nodes, e_src, e_dst = _build_exact_model(
        graph, cluster, kinds, balance_kind, balance_tol, pins, areas,
        pair_cost)
    warm_vec = None
    warm = _warm_start_assign(graph, cluster, kinds, areas, pair_cost,
                              balance_kind, balance_tol, pins)
    if warm is not None:
        warm_vec = np.zeros(m.num_vars)
        asg = np.array([warm[v] for v in nodes], dtype=np.intp)
        warm_vec[xcols[np.arange(len(nodes)), asg]] = 1.0
        if cut is not None:
            nw = cut.num_edges * cut.npairs
            warm_vec[cut.start:cut.start + nw] = cut.warm_values(
                asg[e_src], asg[e_dst])
    sol = m.solve(time_limit=time_limit, warm_start=warm_vec)
    assign = {v: int(np.argmax(sol[xcols[i]])) for i, v in enumerate(nodes)}
    suffix = {"optimal": "", "incumbent": "-incumbent",
              "warm_start": "-klwarm"}.get(m.last_status, "")
    return assign, "milp-exact" + suffix


def _build_exact_model_reference(graph: TaskGraph, cluster: Cluster, kinds,
                                 balance_kind, balance_tol, pins):
    """Original dict-per-row model build (ordered device pairs).  Kept
    verbatim as the golden baseline: ``benchmarks/perf.py`` times it against
    :func:`_build_exact_model` and the equivalence tests assert both produce
    the same Eq. 2 objective."""
    ndev = cluster.num_devices
    nodes = graph.task_names()
    areas = _areas(graph, kinds)
    pair_cost = _pair_cost_matrix(cluster)
    m = Model(f"partition[{graph.name}]")

    x: Dict[Tuple[str, int], int] = {}
    for v in nodes:
        for d in range(ndev):
            x[v, d] = m.add_binary()
        m.add_eq({x[v, d]: 1.0 for d in range(ndev)}, 1.0)
    for v, d in pins.items():
        m.add_eq({x[v, d]: 1.0}, 1.0)

    # Eq. 1 capacity rows.
    for d in range(ndev):
        for ki, k in enumerate(kinds):
            coeffs = {x[v, d]: areas[v][ki] for v in nodes if areas[v][ki]}
            if coeffs:
                m.add_le(coeffs, cluster.capacity(k))

    # Optional compute-balance band.
    if balance_kind is not None and balance_kind in kinds:
        ki = kinds.index(balance_kind)
        total = sum(areas[v][ki] for v in nodes)
        mean = total / ndev
        for d in range(ndev):
            coeffs = {x[v, d]: areas[v][ki] for v in nodes if areas[v][ki]}
            m.add_constraint(coeffs, (1 - balance_tol) * mean,
                             (1 + balance_tol) * mean)

    # Eq. 2 objective via pair variables w[e,a,b] >= x[src,a]+x[dst,b]-1.
    for c in graph.channels:
        for a in range(ndev):
            for b in range(ndev):
                if a == b:
                    continue
                cost = c.width_bits * pair_cost[a, b]
                if cost == 0:
                    continue
                w = m.add_var(0.0, 1.0, integer=False, obj=cost)
                m.add_ge({w: 1.0, x[c.src, a]: -1.0, x[c.dst, b]: -1.0}, -1.0)
    return m, x


def _solve_exact_reference(graph: TaskGraph, cluster: Cluster, kinds,
                           balance_kind, balance_tol, pins,
                           time_limit) -> Tuple[Dict[str, int], str]:
    """Legacy exact path: dict-row build, no warm start (raises on a
    time-limit stop without incumbent, as the seed did)."""
    ndev = cluster.num_devices
    nodes = graph.task_names()
    m, x = _build_exact_model_reference(graph, cluster, kinds, balance_kind,
                                        balance_tol, pins)
    sol = m.solve(time_limit=time_limit)
    assign = {}
    for v in nodes:
        d = int(np.argmax([sol[x[v, d]] for d in range(ndev)]))
        assign[v] = d
    return assign, "milp-exact-reference"


# ---------------------------------------------------------------------------
# Recursive two-way partitioning (paper §4.5 scheme applied inter-device).
# ---------------------------------------------------------------------------

def _solve_recursive(graph: TaskGraph, cluster: Cluster, kinds, balance_kind,
                     balance_tol, pins, time_limit,
                     areas: Optional[Dict[str, np.ndarray]] = None,
                     use_reference: bool = False,
                     pair_cost: Optional[np.ndarray] = None
                     ) -> Tuple[Dict[str, int], str]:
    ndev = cluster.num_devices
    nodes = graph.task_names()
    if areas is None:
        areas = _areas(graph, kinds)

    band_relaxed = False

    def bisect(node_set: List[str], devs: List[int]) -> Dict[str, int]:
        nonlocal band_relaxed
        if len(devs) == 1:
            return {v: devs[0] for v in node_set}
        half = len(devs) // 2
        left_devs, right_devs = devs[:half], devs[half:]
        assign, relaxed = _two_way_ilp(graph, node_set, left_devs,
                                       right_devs, areas, kinds, cluster,
                                       balance_kind, balance_tol, pins,
                                       time_limit,
                                       use_reference=use_reference,
                                       pair_cost=pair_cost)
        band_relaxed = band_relaxed or relaxed
        left = [v for v in node_set if assign[v] == 0]
        right = [v for v in node_set if assign[v] == 1]
        out = {}
        out.update(bisect(left, left_devs))
        out.update(bisect(right, right_devs))
        return out

    out = bisect(nodes, list(range(ndev)))
    method = ("milp-recursive-bisect-bandrelaxed" if band_relaxed
              else "milp-recursive-bisect")
    return out, method


def _two_way_ilp(graph, node_set, left_devs, right_devs, areas, kinds,
                 cluster, balance_kind, balance_tol, pins, time_limit,
                 use_reference: bool = False,
                 pair_cost: Optional[np.ndarray] = None
                 ) -> Tuple[Dict[str, int], bool]:
    """One bisection level.  Returns (side assignment, band_relaxed).

    ``use_reference`` emits the cut-cost block through the legacy per-edge
    dict-row API (identical vars/rows, so both paths stay deterministic and
    comparable) — the baseline ``benchmarks/perf.py`` times on the
    recursive-bisect configs.  ``pair_cost`` overrides the representative
    inter-group edge cost (its [i, j] equals ``cluster.comm_cost(i, j, 1)``
    for the baseline matrix, so passing it is behavior-preserving; the
    congestion_feedback pass passes a calibrated matrix so hot links stay
    expensive on the recursive path too).
    """
    node_in = set(node_set)

    def build(use_balance: bool) -> Tuple[Model, Dict[str, int]]:
        m = Model("bisect")
        side: Dict[str, int] = {}
        for v in node_set:
            side[v] = m.add_binary()  # 0 = left, 1 = right
        for v, d in (pins or {}).items():
            if v in node_in:
                if d in left_devs:
                    m.add_eq({side[v]: 1.0}, 0.0)
                elif d in right_devs:
                    m.add_eq({side[v]: 1.0}, 1.0)

        # Capacity per side (aggregate of member devices).
        for ki, k in enumerate(kinds):
            cap_l = cluster.capacity(k) * len(left_devs)
            cap_r = cluster.capacity(k) * len(right_devs)
            tot = sum(areas[v][ki] for v in node_set)
            coeffs = {side[v]: areas[v][ki] for v in node_set
                      if areas[v][ki]}
            if coeffs:
                m.add_le(coeffs, cap_r)                   # right usage
                m.add_ge(coeffs, tot - cap_l)             # left usage
        if use_balance and balance_kind in kinds:
            ki = kinds.index(balance_kind)
            tot = sum(areas[v][ki] for v in node_set)
            frac_r = len(right_devs) / (len(left_devs) + len(right_devs))
            mean_r = tot * frac_r
            coeffs = {side[v]: areas[v][ki] for v in node_set
                      if areas[v][ki]}
            if coeffs:
                m.add_constraint(coeffs, (1 - balance_tol) * mean_r,
                                 (1 + balance_tol) * mean_r)

        # Cut edges cost: representative inter-group distance.
        if pair_cost is not None:
            rep_cost = float(pair_cost[left_devs[-1], right_devs[0]])
        else:
            rep_cost = cluster.comm_cost(left_devs[-1], right_devs[0], 1.0)
        in_edges = [(side[c.src], side[c.dst], float(c.width_bits))
                    for c in graph.channels
                    if c.src in node_in and c.dst in node_in]
        if in_edges:
            if use_reference:
                for (u_var, v_var, w) in in_edges:
                    y = m.add_var(0.0, 1.0, integer=False, obj=w * rep_cost)
                    m.add_ge({y: 1.0, u_var: -1.0, v_var: 1.0}, 0.0)
                    m.add_ge({y: 1.0, u_var: 1.0, v_var: -1.0}, 0.0)
            else:
                add_abs_diff_cost_vars(
                    m,
                    np.array([e[0] for e in in_edges], dtype=np.intp),
                    np.array([e[1] for e in in_edges], dtype=np.intp),
                    np.array([e[2] for e in in_edges]) * rep_cost)
        return m, side

    m, side = build(use_balance=True)
    relaxed = False
    try:
        sol = m.solve(time_limit=time_limit)
    except ILPError:
        # Deep bisection levels can make the balance band unsatisfiable
        # (e.g. one oversized task vs a band needing work on both sides).
        # Balance is a preference, Eq. 1 is the law: on *proven*
        # infeasibility retry without the band so the recursion degrades
        # instead of crashing (a timeout or numeric failure still raises,
        # and the relaxation is surfaced in the '-bandrelaxed' method tag).
        if balance_kind not in kinds or m.last_status != "infeasible":
            raise
        m, side = build(use_balance=False)
        sol = m.solve(time_limit=time_limit)
        relaxed = True
    return {v: int(round(sol[side[v]])) for v in node_set}, relaxed
