"""Intra-device floorplanning — paper §4.5 (C4), Eq. 4.

Each device is presented as a grid of slots (Alveo U55C: 2 columns × 3 rows
bounded by hard-IP columns; TPU pod: sub-rectangles of the 2-D ICI torus).
Tasks assigned to a device are placed into slots minimizing

    Σ_{e_ij} e_ij.width × (|v_i.row − v_j.row| + |v_i.col − v_j.col|)   (Eq. 4)

under per-slot capacity, by recursive two-way ILP partitioning (row cuts then
column cuts) exactly as the paper describes ("we continue such a two-way
ILP-based partitioning scheme until we divide each FPGA into eight grids").

The paper's "HBM channel binding exploration" maps on TPU to choosing which
mesh axis each HBM-resident tensor family is sharded over — emitted here as
``slot_affinity`` hints consumed by launch/shardings.py.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import TaskGraph
from .ilp import (ILPError, Model, SolveStats, add_abs_diff_cost_vars,
                  add_cut_cost_vars, kl_refine)


@dataclasses.dataclass(frozen=True)
class SlotGrid:
    """Slot geometry of one device."""

    rows: int
    cols: int
    # Per-slot capacity scale (1.0 = full share).  Models hard IPs / static
    # regions consuming part of a slot (paper §2: HBM controllers pinned to
    # the bottom die of the U55C).
    slot_scale: Optional[np.ndarray] = None
    # Slots adjacent to HBM channels (bottom row on U55C).
    hbm_rows: Tuple[int, ...] = (0,)

    @property
    def num_slots(self) -> int:
        return self.rows * self.cols

    def coords(self, s: int) -> Tuple[int, int]:
        return divmod(s, self.cols)

    def slot_id(self, r: int, c: int) -> int:
        return r * self.cols + c

    def dist(self, s1: int, s2: int) -> int:
        (r1, c1), (r2, c2) = self.coords(s1), self.coords(s2)
        return abs(r1 - r2) + abs(c1 - c2)

    def scale(self, s: int) -> float:
        if self.slot_scale is None:
            return 1.0
        return float(self.slot_scale.flat[s])


# U55C is presented "as a grid with 6 slots divided into two columns and 3
# rows" (§4.5); recursive bisection continues to 8 grids for larger parts.
U55C_GRID = SlotGrid(rows=3, cols=2)
# TPU pod: a 16×16 ICI torus viewed as 4×2 = 8 coarse slots ("divide each
# FPGA into eight grids").
TPU_POD_GRID = SlotGrid(rows=4, cols=2, hbm_rows=(0, 1, 2, 3))


@dataclasses.dataclass
class Floorplan:
    slot_of: Dict[str, int]              # task -> slot id
    grid: SlotGrid
    wirelength: float                    # Eq. 4 objective
    usage: np.ndarray                    # [slot, kind]
    kinds: Tuple[str, ...]
    stats: SolveStats
    threshold_used: float = 0.70
    congested: bool = False              # fed to FreqModel.estimate

    def max_slot_util(self, capacity: Dict[str, float]) -> float:
        """Worst slot utilization fraction across kinds (vs full slot)."""
        out = 0.0
        nslots = self.grid.num_slots
        for ki, k in enumerate(self.kinds):
            cap = capacity[k] / nslots
            if cap > 0:
                out = max(out, float(self.usage[:, ki].max()) / cap)
        return out

    def slot_tasks(self, s: int) -> List[str]:
        return [t for t, ss in self.slot_of.items() if ss == s]


def _areas(graph: TaskGraph, tasks: Sequence[str], kinds) -> Dict[str, np.ndarray]:
    return {v: np.array([graph.tasks[v].area[k] for k in kinds], dtype=float)
            for v in tasks}


def floorplan_device(graph: TaskGraph, tasks: Sequence[str],
                     capacity: Dict[str, float], *,
                     grid: SlotGrid = U55C_GRID,
                     threshold: float = 0.70,
                     hbm_tasks: Sequence[str] = (),
                     time_limit: float = 30.0,
                     strict: bool = False,
                     areas: Optional[Dict[str, np.ndarray]] = None
                     ) -> Floorplan:
    """Floorplan the ``tasks`` resident on one device into ``grid`` slots.

    capacity: whole-device resources (paper Table 2); each slot gets
        capacity/num_slots × slot_scale × threshold.
    hbm_tasks: tasks that access HBM — pinned (softly) to HBM-adjacent rows,
        the paper's channel-binding consideration.
    areas: optional precomputed per-task resource vectors over
        ``tuple(capacity.keys())`` (may cover more tasks than ``tasks``) —
        the compiler pipeline memoizes these per compile() so per-device
        calls stop rebuilding them; never mutated here.

    Slot-level bin packing can be infeasible even when device-level Eq. 1
    holds (slot quantization wastes capacity).  Real CAD doesn't crash — it
    produces a congested placement with degraded fmax.  We model that:
    escalate the threshold (0.85, 0.95, 1.1), and as a last resort place
    greedily, flagging ``congested`` so FreqModel derates the clock.
    ``strict=True`` restores the hard-failure behaviour for tests.
    """
    t0 = time.perf_counter()
    tasks = list(tasks)
    kinds = tuple(capacity.keys())
    nslots = grid.num_slots
    in_set = set(tasks)
    edges = [(c.src, c.dst, float(c.width_bits)) for c in graph.channels
             if c.src in in_set and c.dst in in_set]
    pair = np.array([[grid.dist(a, b) for b in range(nslots)]
                     for a in range(nslots)], dtype=float)
    base_areas = ({v: np.asarray(areas[v], dtype=float) for v in tasks}
                  if areas is not None else _areas(graph, tasks, kinds))

    thresholds = [threshold] if strict else [threshold, 0.85, 0.95, 1.1]
    last_err: Optional[Exception] = None
    for ti, th in enumerate(thresholds):
        caps = np.array([[capacity[k] / nslots * grid.scale(s) * th
                          for k in kinds] for s in range(nslots)])
        # A module larger than one slot spans adjacent slots ("a single die
        # can contain any number of modules, and modules spanning across
        # multiple dies are pipelined sufficiently" — paper §6.2).  Clamped
        # into fresh vectors so the memoized base areas stay pristine.
        slot_min = caps.min(axis=0)
        areas = {v: np.minimum(base_areas[v], slot_min * 0.95)
                 for v in tasks}
        try:
            if len(tasks) * nslots <= 2000:
                slot_of, method = _exact_slot_ilp(
                    tasks, edges, areas, kinds, grid, caps, hbm_tasks,
                    time_limit, pair=pair)
            else:
                slot_of, method = _recursive_slots(
                    tasks, edges, areas, kinds, grid, caps, hbm_tasks,
                    time_limit)
        except ILPError as e:
            last_err = e
            continue
        slot_of = kl_refine(slot_of, edges, pair, areas, caps)
        usage = np.zeros((nslots, len(kinds)))
        for v, s in slot_of.items():
            usage[s] += areas[v]
        if np.any(usage > caps + 1e-6):
            last_err = ILPError("refinement violated slot capacity")
            continue
        wl = sum(w * grid.dist(slot_of[u], slot_of[v]) for u, v, w in edges)
        stats = SolveStats(graph.name, len(tasks), nslots,
                           time.perf_counter() - t0, wl, method)
        return Floorplan(slot_of, grid, wl, usage, kinds, stats,
                         threshold_used=th, congested=ti > 0)
    if strict:
        raise last_err or ILPError("floorplan infeasible")
    # Greedy congested fallback: least-loaded-slot placement.
    areas = base_areas
    norm = np.array([max(capacity[k] / nslots, 1e-9) for k in kinds])
    usage = np.zeros((nslots, len(kinds)))
    slot_of = {}
    for v in sorted(tasks, key=lambda t: -float((areas[t] / norm).max())):
        s = int(np.argmin((usage / norm).max(axis=1)))
        slot_of[v] = s
        usage[s] += areas[v]
    slot_of = kl_refine(slot_of, edges, pair, areas,
                        np.tile(norm * 10.0, (nslots, 1)))
    usage = np.zeros((nslots, len(kinds)))
    for v, s in slot_of.items():
        usage[s] += areas[v]
    wl = sum(w * grid.dist(slot_of[u], slot_of[v]) for u, v, w in edges)
    stats = SolveStats(graph.name, len(tasks), nslots,
                       time.perf_counter() - t0, wl, "greedy-congested")
    return Floorplan(slot_of, grid, wl, usage, kinds, stats,
                     threshold_used=float("inf"), congested=True)


def _exact_slot_ilp(tasks, edges, areas, kinds, grid: SlotGrid, caps,
                    hbm_tasks, time_limit, pair=None):
    """Eq. 4 slot-assignment MILP, emitted through the bulk COO APIs with
    one linearization var per unordered slot pair (Manhattan distance is
    symmetric).  ``pair``: optional precomputed slot-distance matrix."""
    nslots = grid.num_slots
    tasks = list(tasks)
    nt = len(tasks)
    tidx = {v: i for i, v in enumerate(tasks)}
    m = Model("floorplan")
    hbm_slots = {grid.slot_id(r, c)
                 for r in grid.hbm_rows for c in range(grid.cols)}
    hbm_set = set(hbm_tasks)
    # Soft HBM binding: tiny objective bonus for HBM tasks in HBM rows.
    pen = np.zeros((nt, nslots))
    for v in hbm_set & set(tasks):
        row = 1e-3 * float(np.sum(areas[v])) + 1.0
        for s in range(nslots):
            if s not in hbm_slots:
                pen[tidx[v], s] = row
    xstart = m.add_vars(nt * nslots, 0.0, 1.0, integer=True,
                        obj=pen.ravel())
    xcols = (xstart + np.arange(nt * nslots,
                                dtype=np.intp)).reshape(nt, nslots)
    m.add_eq_rows(xcols, np.ones((nt, nslots)), 1.0)
    amat = np.stack([areas[v] for v in tasks]) if nt else np.zeros((0, 1))
    if nt and kinds:
        for s in range(nslots):
            m.add_le_rows(np.broadcast_to(xcols[:, s], (len(kinds), nt)),
                          amat.T, caps[s])
    if edges:
        if pair is None:
            pair = np.array([[grid.dist(a, b) for b in range(nslots)]
                             for a in range(nslots)], dtype=float)
        e_src = np.array([tidx[u] for u, v, w in edges], dtype=np.intp)
        e_dst = np.array([tidx[v] for u, v, w in edges], dtype=np.intp)
        e_w = np.array([w for u, v, w in edges])
        add_cut_cost_vars(m, xcols, e_src, e_dst, e_w, pair)
    sol = m.solve(time_limit=time_limit)
    out = {v: int(np.argmax(sol[xcols[i]])) for i, v in enumerate(tasks)}
    return out, "milp-exact"


def _recursive_slots(tasks, edges, areas, kinds, grid: SlotGrid, caps,
                     hbm_tasks, time_limit):
    """Recursive bisection: cut rows, then columns (paper's two-way scheme)."""

    def bisect(tset: List[str], slots: List[int]) -> Dict[str, int]:
        if len(slots) == 1:
            return {v: slots[0] for v in tset}
        # Split slots into two spatially-contiguous halves.
        coords = sorted(slots, key=lambda s: grid.coords(s))
        half = len(coords) // 2
        left_s, right_s = coords[:half], coords[half:]
        m = Model("slot-bisect")
        side = {v: m.add_binary() for v in tset}
        in_set = set(tset)
        cap_l = caps[left_s].sum(axis=0)
        cap_r = caps[right_s].sum(axis=0)
        for ki in range(len(kinds)):
            tot = sum(areas[v][ki] for v in tset)
            coeffs = {side[v]: areas[v][ki] for v in tset if areas[v][ki]}
            if coeffs:
                m.add_le(coeffs, cap_r[ki])
                m.add_ge(coeffs, tot - cap_l[ki])
        in_edges = [(side[u], side[v], w) for (u, v, w) in edges
                    if u in in_set and v in in_set]
        if in_edges:
            add_abs_diff_cost_vars(
                m,
                np.array([e[0] for e in in_edges], dtype=np.intp),
                np.array([e[1] for e in in_edges], dtype=np.intp),
                np.array([e[2] for e in in_edges]))
        sol = m.solve(time_limit=time_limit)
        left_t = [v for v in tset if sol[side[v]] < 0.5]
        right_t = [v for v in tset if sol[side[v]] >= 0.5]
        out = {}
        out.update(bisect(left_t, left_s))
        out.update(bisect(right_t, right_s))
        return out

    return bisect(list(tasks), list(range(grid.num_slots))), \
        "milp-recursive-bisect"
