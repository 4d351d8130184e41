"""Thin ILP layer over scipy.optimize.milp (HiGHS branch-and-cut).

The paper solves its floorplanning formulations with Python-MIP or Gurobi
(§5).  Offline we use HiGHS via scipy — a real exact MILP solver — wrapped in
a tiny incremental model builder, plus a Kernighan–Lin style refinement
heuristic used as a fast fallback / polish for very large graphs.

Performance notes (PR 3)
------------------------
* :class:`Model` accumulates constraint coefficients as COO triplets
  (``data``/``rows``/``cols``) instead of per-row Python dicts, and exposes
  vectorized ``add_vars`` / ``add_rows`` / ``add_le_rows`` / ``add_eq_rows`` /
  ``add_ge_rows`` bulk APIs so the solvers can emit whole constraint blocks
  as numpy arrays.  The legacy per-row dict API is kept (same semantics) and
  serves as the build-time baseline in ``benchmarks/perf.py``.
* :meth:`Model.solve` degrades gracefully under a ``time_limit``: if HiGHS
  stops at the limit with an integer-feasible incumbent, that incumbent is
  returned; otherwise a caller-supplied ``warm_start`` solution (e.g. the KL
  heuristic's assignment) is feasibility-checked and returned.  Only when
  neither exists does it raise :class:`ILPError`.  scipy's milp wrapper
  cannot inject an incumbent into HiGHS, so the warm start acts as the
  guaranteed-feasible fallback rather than a true MIP start.
* :func:`kl_refine` is a vectorized *incremental* refiner: CSR adjacency
  over integer node ids, a ``[node, device]`` cost matrix built with one
  ``pair_cost``-indexed reduction, and delta-updates of neighbor costs after
  each accepted move.  The original pure-Python implementation is kept as
  :func:`kl_refine_reference`; the two make identical greedy decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import optimize as sopt
from scipy import sparse as ssp


class ILPError(RuntimeError):
    pass


class Model:
    """Incremental 0/1-or-continuous LP/ILP model (COO-triplet backed)."""

    def __init__(self, name: str = "ilp"):
        self.name = name
        # How the last solve() produced its result:
        # "unsolved" | "optimal" | "incumbent" | "warm_start"
        self.last_status = "unsolved"
        self._num_vars = 0
        self._num_rows = 0
        self._obj: List[float] = []
        self._integrality: List[int] = []
        self._lb: List[float] = []
        self._ub: List[float] = []
        # COO triplets: scalars appended by the per-row API ...
        self._sdata: List[float] = []
        self._srows: List[int] = []
        self._scols: List[int] = []
        # ... and array chunks appended by the bulk APIs.
        self._chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # per-row bounds (parallel to row ids)
        self._lo: List[float] = []
        self._hi: List[float] = []

    # -- variables ---------------------------------------------------------
    def add_var(self, lb: float = 0.0, ub: float = 1.0,
                integer: bool = True, obj: float = 0.0) -> int:
        idx = self._num_vars
        self._num_vars += 1
        self._integrality.append(1 if integer else 0)
        self._lb.append(lb)
        self._ub.append(ub)
        self._obj.append(obj)
        return idx

    def add_binary(self, obj: float = 0.0) -> int:
        return self.add_var(0.0, 1.0, True, obj)

    def add_vars(self, n: int, lb: float = 0.0, ub: float = 1.0,
                 integer: bool = True,
                 obj: Optional[np.ndarray] = None) -> int:
        """Bulk-allocate ``n`` variables; returns the first index."""
        start = self._num_vars
        self._num_vars += n
        self._integrality.extend([1 if integer else 0] * n)
        self._lb.extend([lb] * n)
        self._ub.extend([ub] * n)
        if obj is None:
            self._obj.extend([0.0] * n)
        else:
            obj = np.asarray(obj, dtype=float).ravel()
            if obj.shape[0] != n:
                raise ValueError(f"obj has {obj.shape[0]} entries, need {n}")
            self._obj.extend(obj.tolist())
        return start

    def set_obj(self, var: int, coeff: float) -> None:
        self._obj[var] = coeff

    # -- constraints (per-row dict API, kept for compatibility) ------------
    def add_constraint(self, coeffs: Dict[int, float],
                       lo: float = -np.inf, hi: float = np.inf) -> None:
        r = self._num_rows
        self._num_rows += 1
        for v, cf in coeffs.items():
            self._srows.append(r)
            self._scols.append(v)
            self._sdata.append(cf)
        self._lo.append(lo)
        self._hi.append(hi)

    def add_eq(self, coeffs: Dict[int, float], rhs: float) -> None:
        self.add_constraint(coeffs, rhs, rhs)

    def add_le(self, coeffs: Dict[int, float], rhs: float) -> None:
        self.add_constraint(coeffs, -np.inf, rhs)

    def add_ge(self, coeffs: Dict[int, float], rhs: float) -> None:
        self.add_constraint(coeffs, rhs, np.inf)

    # -- constraints (vectorized bulk API) ---------------------------------
    def add_rows(self, cols: np.ndarray, coeffs: np.ndarray,
                 lo=-np.inf, hi=np.inf) -> None:
        """Add ``R`` rows at once.

        cols/coeffs: ``[R, K]`` variable-index / coefficient arrays (every
        row has the same width; explicit zero coefficients are allowed).
        lo/hi: scalars or ``[R]`` arrays of row bounds.
        """
        cols = np.asarray(cols, dtype=np.intp)
        coeffs = np.asarray(coeffs, dtype=float)
        if cols.ndim == 1:
            cols = cols[None, :]
            coeffs = coeffs[None, :]
        if cols.shape != coeffs.shape:
            raise ValueError(f"cols {cols.shape} != coeffs {coeffs.shape}")
        r, k = cols.shape
        rows = np.repeat(
            np.arange(self._num_rows, self._num_rows + r, dtype=np.intp), k)
        self._chunks.append((coeffs.ravel(), rows, cols.ravel()))
        self._lo.extend(np.broadcast_to(np.asarray(lo, float), (r,)).tolist())
        self._hi.extend(np.broadcast_to(np.asarray(hi, float), (r,)).tolist())
        self._num_rows += r

    def add_eq_rows(self, cols, coeffs, rhs) -> None:
        self.add_rows(cols, coeffs, rhs, rhs)

    def add_le_rows(self, cols, coeffs, rhs) -> None:
        self.add_rows(cols, coeffs, -np.inf, rhs)

    def add_ge_rows(self, cols, coeffs, rhs) -> None:
        self.add_rows(cols, coeffs, rhs, np.inf)

    # -- assembly / solve --------------------------------------------------
    @property
    def num_vars(self) -> int:
        return self._num_vars

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def _assemble(self) -> Optional[ssp.csr_matrix]:
        if not self._num_rows:
            return None
        parts_d = [np.asarray(self._sdata, dtype=float)]
        parts_r = [np.asarray(self._srows, dtype=np.intp)]
        parts_c = [np.asarray(self._scols, dtype=np.intp)]
        for d, r, c in self._chunks:
            parts_d.append(d)
            parts_r.append(r)
            parts_c.append(c)
        return ssp.csr_matrix(
            (np.concatenate(parts_d),
             (np.concatenate(parts_r), np.concatenate(parts_c))),
            shape=(self._num_rows, self._num_vars))

    def _is_feasible(self, x: np.ndarray, a: Optional[ssp.csr_matrix],
                     tol: float = 1e-6) -> bool:
        x = np.asarray(x, dtype=float)
        if x.shape[0] != self._num_vars:
            return False
        lb, ub = np.asarray(self._lb), np.asarray(self._ub)
        if np.any(x < lb - tol) or np.any(x > ub + tol):
            return False
        integ = np.asarray(self._integrality, dtype=bool)
        if np.any(np.abs(x[integ] - np.round(x[integ])) > tol):
            return False
        if a is not None:
            ax = a @ x
            if (np.any(ax < np.asarray(self._lo) - tol)
                    or np.any(ax > np.asarray(self._hi) + tol)):
                return False
        return True

    def solve(self, time_limit: Optional[float] = None,
              mip_rel_gap: float = 1e-6,
              warm_start: Optional[np.ndarray] = None) -> np.ndarray:
        """Solve; on a time-limit stop, fall back to the incumbent or to a
        caller-supplied feasible ``warm_start`` instead of raising."""
        n = self._num_vars
        c = np.asarray(self._obj, dtype=float)
        a = self._assemble()
        if a is not None:
            constraints = sopt.LinearConstraint(
                a, np.asarray(self._lo), np.asarray(self._hi))
        else:
            constraints = ()
        opts: Dict[str, object] = {"mip_rel_gap": mip_rel_gap}
        if time_limit is not None:
            opts["time_limit"] = time_limit
        res = sopt.milp(
            c=c,
            constraints=constraints,
            integrality=np.array(self._integrality),
            bounds=sopt.Bounds(np.array(self._lb), np.array(self._ub)),
            options=opts,
        )
        if res.success and res.x is not None:
            self.last_status = "optimal"
            return res.x
        # Graceful degradation at the time/iteration limit (status 1): HiGHS
        # may still hold an integer-feasible incumbent.
        if (getattr(res, "status", None) == 1 and res.x is not None
                and self._is_feasible(res.x, a)):
            self.last_status = "incumbent"
            return res.x
        if warm_start is not None and self._is_feasible(warm_start, a):
            self.last_status = "warm_start"
            return np.asarray(warm_start, dtype=float)
        # status 2 = proven infeasible; anything else (timeout with no
        # incumbent, numeric failure) is "failed" — callers relaxing
        # constraints must distinguish the two.
        self.last_status = ("infeasible"
                            if getattr(res, "status", None) == 2 else "failed")
        raise ILPError(f"ILP infeasible/failed: {res.message}")


# ---------------------------------------------------------------------------
# Shared product-linearization emitter for assignment-with-edge-cost models.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CutVars:
    """Layout of the linearization block added by :func:`add_cut_cost_vars`.

    ``w`` var ``start + e * npairs + p`` covers edge ``e`` and location pair
    ``(a[p], b[p])`` — one var per *unordered* pair when ``symmetric``.
    """

    start: int
    a: np.ndarray
    b: np.ndarray
    symmetric: bool
    num_edges: int

    @property
    def npairs(self) -> int:
        return int(self.a.shape[0])

    def warm_values(self, loc_src: np.ndarray,
                    loc_dst: np.ndarray) -> np.ndarray:
        """w values induced by a concrete assignment (for warm starts)."""
        sa = np.asarray(loc_src)[:, None]
        sb = np.asarray(loc_dst)[:, None]
        hit = (sa == self.a[None, :]) & (sb == self.b[None, :])
        if self.symmetric:
            hit |= (sa == self.b[None, :]) & (sb == self.a[None, :])
        return hit.astype(float).ravel()


def add_cut_cost_vars(m: Model, xcols: np.ndarray, src: np.ndarray,
                      dst: np.ndarray, weights: np.ndarray,
                      pair_cost: np.ndarray) -> Optional[CutVars]:
    """Emit the Eq. 2 product linearization for all edges at once.

    xcols: ``[num_nodes, num_locations]`` matrix of x-variable indices;
    src/dst/weights: ``[E]`` integer endpoints + edge weights;
    pair_cost: ``[L, L]`` per-location-pair cost (width-1 units).

    For every (edge, location pair) with nonzero cost a continuous w in
    [0, 1] is added with objective ``weight × pair_cost`` and the standard
    ``w ≥ x[src,a] + x[dst,b] − 1`` rows.  When ``pair_cost`` is symmetric
    (every ring/mesh/daisy-chain cluster), one w per *unordered* pair covers
    both orientations via two rows — halving the linearization variables at
    the same row count.
    """
    src = np.asarray(src, dtype=np.intp)
    dst = np.asarray(dst, dtype=np.intp)
    weights = np.asarray(weights, dtype=float)
    nloc = pair_cost.shape[0]
    symmetric = bool(np.array_equal(pair_cost, pair_cost.T))
    if symmetric:
        a, b = np.triu_indices(nloc, k=1)
    else:
        off = ~np.eye(nloc, dtype=bool)
        a, b = np.nonzero(off)
    keep = pair_cost[a, b] != 0.0
    a, b = a[keep], b[keep]
    num_e, npairs = src.shape[0], a.shape[0]
    if num_e == 0 or npairs == 0:
        return None
    cost = weights[:, None] * pair_cost[a, b][None, :]          # [E, P]
    start = m.add_vars(num_e * npairs, 0.0, 1.0, integer=False,
                       obj=cost.ravel())
    widx = (start + np.arange(num_e * npairs,
                              dtype=np.intp)).reshape(num_e, npairs)
    coeffs = np.broadcast_to(np.array([1.0, -1.0, -1.0]),
                             (num_e * npairs, 3))
    cols_ab = np.stack([widx, xcols[src[:, None], a[None, :]],
                        xcols[dst[:, None], b[None, :]]],
                       axis=-1).reshape(-1, 3)
    m.add_ge_rows(cols_ab, coeffs, -1.0)
    if symmetric:
        cols_ba = np.stack([widx, xcols[src[:, None], b[None, :]],
                            xcols[dst[:, None], a[None, :]]],
                           axis=-1).reshape(-1, 3)
        m.add_ge_rows(cols_ba, coeffs, -1.0)
    return CutVars(start, a, b, symmetric, num_e)


def add_abs_diff_cost_vars(m: Model, u: np.ndarray, v: np.ndarray,
                           obj: np.ndarray) -> int:
    """Bulk-emit ``y_i = |u_i − v_i|`` cost terms for 0/1 variable pairs.

    For each pair adds a continuous y in [0, 1] with objective ``obj_i`` and
    the rows ``y ≥ u − v`` / ``y ≥ v − u`` (interleaved, matching the legacy
    per-edge emission order).  The two-way bisection cut costs in both the
    partitioner and the floorplanner use this.  Returns the first y index.
    """
    u = np.asarray(u, dtype=np.intp)
    v = np.asarray(v, dtype=np.intp)
    ne = u.shape[0]
    if ne == 0:
        return m.num_vars
    ystart = m.add_vars(ne, 0.0, 1.0, integer=False,
                        obj=np.asarray(obj, dtype=float))
    y = ystart + np.arange(ne, dtype=np.intp)
    cols = np.repeat(np.stack([y, u, v], axis=-1), 2, axis=0)
    coeffs = np.tile(np.array([[1.0, -1.0, 1.0],
                               [1.0, 1.0, -1.0]]), (ne, 1))
    m.add_ge_rows(cols, coeffs, 0.0)
    return ystart


# ---------------------------------------------------------------------------
# Kernighan–Lin style refinement for k-way assignments (fallback / polish).
# ---------------------------------------------------------------------------

def kl_refine_reference(assign: Dict[str, int],
                        edges: Sequence[Tuple[str, str, float]],
                        pair_cost: "np.ndarray",
                        area: Dict[str, np.ndarray],
                        caps: np.ndarray,
                        max_passes: int = 8) -> Dict[str, int]:
    """Greedy single-move refinement (original pure-Python implementation).

    Kept verbatim as the golden reference for :func:`kl_refine` and as the
    baseline timed by ``benchmarks/perf.py``.

    assign: node -> device; edges: (u, v, weight); pair_cost[d1, d2]:
    dist×λ between devices; area[node]: resource vector; caps[d, k]:
    remaining-capacity-aware limits (absolute, already scaled by T).
    """
    assign = dict(assign)
    ndev = pair_cost.shape[0]
    nodes = list(assign.keys())
    # per-device usage
    nk = next(iter(area.values())).shape[0] if area else 0
    usage = np.zeros((ndev, nk))
    for v, d in assign.items():
        usage[d] += area[v]
    adj: Dict[str, List[Tuple[str, float]]] = {n: [] for n in nodes}
    for u, v, w in edges:
        adj[u].append((v, w))
        adj[v].append((u, w))

    def node_cost(v: str, d: int) -> float:
        return sum(w * pair_cost[d, assign[o]] for o, w in adj[v] if o != v)

    for _ in range(max_passes):
        improved = False
        for v in nodes:
            d0 = assign[v]
            base = node_cost(v, d0)
            best_d, best_gain = d0, 0.0
            for d in range(ndev):
                if d == d0:
                    continue
                if nk and np.any(usage[d] + area[v] > caps[d] + 1e-9):
                    continue
                gain = base - node_cost(v, d)
                if gain > best_gain + 1e-12:
                    best_gain, best_d = gain, d
            if best_d != d0:
                usage[d0] -= area[v]
                usage[best_d] += area[v]
                assign[v] = best_d
                improved = True
        if not improved:
            break
    return assign


def kl_refine(assign: Dict[str, int],
              edges: Sequence[Tuple[str, str, float]],
              pair_cost: "np.ndarray",
              area: Dict[str, np.ndarray],
              caps: np.ndarray,
              max_passes: int = 8,
              pinned: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Vectorized incremental greedy single-move refinement.

    Same greedy decision sequence as :func:`kl_refine_reference` (same node
    order, same capacity guard, same strict-improvement tie-breaking), but:

    * nodes are mapped to integer ids and the symmetric adjacency is stored
      in CSR form;
    * per-node, per-device costs live in one ``[node, device]`` matrix
      initialized by a single ``pair_cost``-indexed numpy reduction;
    * after each accepted move only the mover's neighbors' cost rows are
      delta-updated (``w × (pair_cost[:, new] − pair_cost[:, old])``)
      instead of recomputing ``node_cost`` from scratch per candidate.

    ``pinned`` nodes participate in every cost (their edges pull neighbors)
    but are never moved themselves.
    """
    pair_cost = np.asarray(pair_cost, dtype=float)
    ndev = pair_cost.shape[0]
    nodes = list(assign.keys())
    nv = len(nodes)
    if nv == 0:
        return {}
    idx = {n: i for i, n in enumerate(nodes)}
    asg = np.fromiter((assign[n] for n in nodes), dtype=np.intp, count=nv)
    nk = next(iter(area.values())).shape[0] if area else 0
    if nk:
        amat = np.stack([np.asarray(area[n], dtype=float) for n in nodes])
        caps = np.asarray(caps, dtype=float)
        usage = np.zeros((ndev, nk))
        np.add.at(usage, asg, amat)
        # headroom[v, d, k]: usage[d] must stay ≤ this for v to enter d.
        headroom = caps[None, :, :] - amat[:, None, :] + 1e-9
    movable = np.ones(nv, dtype=bool)
    if pinned:
        for n in pinned:
            if n in idx:
                movable[idx[n]] = False

    # Symmetric CSR adjacency (self-loops dropped, duplicates kept).
    e_src: List[int] = []
    e_dst: List[int] = []
    e_w: List[float] = []
    for u, v, w in edges:
        if u == v:
            continue
        e_src.append(idx[u])
        e_dst.append(idx[v])
        e_w.append(float(w))
    if e_src:
        half_s = np.asarray(e_src, dtype=np.intp)
        half_d = np.asarray(e_dst, dtype=np.intp)
        half_w = np.asarray(e_w, dtype=float)
        csr_s = np.concatenate([half_s, half_d])
        csr_d = np.concatenate([half_d, half_s])
        csr_w = np.concatenate([half_w, half_w])
        order = np.argsort(csr_s, kind="stable")
        csr_s, csr_d, csr_w = csr_s[order], csr_d[order], csr_w[order]
        indptr = np.searchsorted(csr_s, np.arange(nv + 1))
    else:
        csr_d = np.zeros(0, dtype=np.intp)
        csr_w = np.zeros(0, dtype=float)
        indptr = np.zeros(nv + 1, dtype=np.intp)

    # cost[v, d] = Σ_nbr w(v, nbr) × pair_cost[d, asg[nbr]]
    pc_by_nbr = np.ascontiguousarray(pair_cost.T)   # [nbr_dev, d]
    cost = np.zeros((nv, ndev))
    if csr_d.shape[0]:
        np.add.at(cost, csr_s, csr_w[:, None] * pc_by_nbr[asg[csr_d]])

    eps_gain = 1e-12                # headroom already carries the 1e-9 slack
    for _ in range(max_passes):
        improved = False
        for vi in range(nv):
            if not movable[vi]:
                continue
            d0 = asg[vi]
            row = cost[vi]
            gains = row[d0] - row
            if not np.any(gains > eps_gain):
                continue                     # no device can beat staying put
            if nk:
                feas = np.all(usage <= headroom[vi], axis=1)
            best_d, best_gain = d0, 0.0
            for d in range(ndev):
                if d == d0:
                    continue
                if nk and not feas[d]:
                    continue
                g = gains[d]
                if g > best_gain + eps_gain:
                    best_gain, best_d = g, d
            if best_d != d0:
                if nk:
                    usage[d0] -= amat[vi]
                    usage[best_d] += amat[vi]
                asg[vi] = best_d
                lo, hi = indptr[vi], indptr[vi + 1]
                if hi > lo:
                    delta = pc_by_nbr[best_d] - pc_by_nbr[d0]
                    np.add.at(cost, csr_d[lo:hi],
                              csr_w[lo:hi, None] * delta[None, :])
                improved = True
        if not improved:
            break
    return {n: int(asg[i]) for i, n in enumerate(nodes)}


@dataclasses.dataclass
class SolveStats:
    """Timing record — reproduces the paper's §5.6 overhead table."""

    name: str
    num_tasks: int
    num_devices: int
    wall_time_s: float
    objective: float
    method: str
