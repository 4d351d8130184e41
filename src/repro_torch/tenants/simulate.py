"""Virtual-time serving simulation — load sweeps the executor can't afford.

The real co-execution path (:mod:`repro_torch.tenants.server`) runs a
handful of requests with full flit/bank fidelity and *asserts* the substrate's
properties (bit-identity, exact conservation, weighted shares).  A latency
-vs-offered-load curve needs thousands of requests across a dozen load
points — so this module serves the same tenants in **virtual time** over a
fluid model of the substrate those assertions just validated:

* the shared fabric is a work-conserving server of ``capacity_Bps``
  (calibrated from a measured co-run: delivered bytes / (sweeps ×
  sweep_time) — see ``benchmarks/perf.py``);
* backlogged tenants share it by **generalized processor sharing**: tenant
  *i* receives ``capacity × w_i / Σ_active w`` — the fluid limit of the
  weighted-DRR arbiter in :mod:`repro_torch.net.transport`, redistributing
  idle tenants' shares exactly like the deficit counter does;
* within a tenant, service is FIFO over a bounded in-service window; the
  :class:`~repro_torch.tenants.slo.AdmissionController` fronts the window
  with admit / queue / reject and deadline-aware priority aging.

Everything advances by exact event arithmetic on arrival instants and
head-of-line completions — no wall clock, no hidden RNG: a (config, seed)
pair names one curve forever.  Goodput counts only work that finished
inside its deadline; a late completion burned capacity but serves nobody,
which is exactly how an SLO curve should fold over at saturation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .slo import ADMIT, SLO, AdmissionController
from .traffic import Request, TrafficConfig, generate, merge

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One simulated tenant: its SLO and its offered traffic."""

    name: str
    slo: SLO
    traffic: TrafficConfig


@dataclasses.dataclass
class TenantStats:
    """What one tenant experienced across a simulation."""

    name: str
    offered: int = 0
    offered_bytes: float = 0.0
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    completed_in_slo: int = 0
    done_bytes: float = 0.0
    goodput_bytes: float = 0.0     # bytes of work finished inside deadline
    latencies: List[float] = dataclasses.field(default_factory=list)

    def percentile(self, p: float) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies), p))

    def summary(self, horizon_s: float) -> Dict[str, object]:
        return {
            "offered": self.offered,
            "offered_Bps": self.offered_bytes / horizon_s,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "completed_in_slo": self.completed_in_slo,
            "p50_latency_s": self.percentile(50),
            "p99_latency_s": self.percentile(99),
            "goodput_Bps": self.goodput_bytes / horizon_s,
            "throughput_Bps": self.done_bytes / horizon_s,
        }


@dataclasses.dataclass
class SimResult:
    """One simulation run: per-tenant stats + the shared horizon."""

    tenants: Dict[int, TenantStats]
    horizon_s: float
    capacity_Bps: float

    def stats(self, name: str) -> TenantStats:
        for st in self.tenants.values():
            if st.name == name:
                return st
        raise KeyError(name)

    def summary(self) -> Dict[str, object]:
        return {
            "capacity_Bps": self.capacity_Bps,
            "horizon_s": self.horizon_s,
            "tenants": {st.name: st.summary(self.horizon_s)
                        for st in self.tenants.values()},
        }


def fair_share(capacity_Bps: float, weights: Dict[int, float],
               tenant: int) -> float:
    """The tenant's GPS guarantee when everyone is backlogged."""
    return capacity_Bps * weights[tenant] / sum(weights.values())


def simulate(loads: Dict[int, TenantLoad], capacity_Bps: float, *,
             seed: int = 0) -> SimResult:
    """Serve every tenant's generated stream over the fluid substrate."""
    if capacity_Bps <= 0:
        raise ValueError("capacity must be positive")
    weights = {t: ld.slo.weight for t, ld in loads.items()}
    ctrl = AdmissionController(
        {t: ld.slo for t, ld in loads.items()},
        {t: fair_share(capacity_Bps, weights, t) for t in loads})
    streams = {t: generate(ld.traffic, t, np.random.default_rng([seed, t]))
               for t, ld in loads.items()}
    arrivals = merge(list(streams.values()))
    stats = {t: TenantStats(name=ld.name) for t, ld in loads.items()}
    for t, s in streams.items():
        stats[t].offered = len(s)
        stats[t].offered_bytes = sum(r.size for r in s)

    # Per-tenant FIFO service window: [request, remaining work].
    service: Dict[int, List[List]] = {t: [] for t in loads}
    now = 0.0
    idx = 0                        # next arrival to process

    def rates() -> Dict[int, float]:
        active = [t for t in loads if service[t]]
        if not active:
            return {}
        wsum = sum(weights[t] for t in active)
        return {t: capacity_Bps * weights[t] / wsum for t in active}

    def start(r: Request) -> None:
        service[r.tenant].append([r, r.size])

    def finish(t: int, r: Request) -> None:
        st = stats[t]
        st.completed += 1
        st.done_bytes += r.size
        lat = now - r.t_arrival
        st.latencies.append(lat)
        if now <= loads[t].slo.deadline(r) + _EPS:
            st.completed_in_slo += 1
            st.goodput_bytes += r.size
        ctrl.complete(r)
        while True:
            nxt = ctrl.release(now)
            if nxt is None:
                break
            start(nxt)

    while idx < len(arrivals) or any(service.values()) or ctrl.pending:
        r = rates()
        # Next head-of-line completion under the current GPS rates.
        next_done: Optional[Tuple[float, int]] = None
        for t, q in service.items():
            if q:
                dt = q[0][1] / r[t]
                if next_done is None or dt < next_done[0] - _EPS:
                    next_done = (dt, t)
        next_arrival = (arrivals[idx].t_arrival - now
                        if idx < len(arrivals) else None)
        if next_done is None and next_arrival is None:
            # No service, no arrivals — only pending work remains.  The
            # controller sheds what expired and hands back what is still
            # worth serving (its slot is certainly free now).
            nxt = ctrl.release(now)
            if nxt is None:
                break
            start(nxt)
            continue
        if next_done is None or (next_arrival is not None
                                 and next_arrival <= next_done[0] + _EPS):
            # Advance to the arrival, draining fluid service on the way.
            dt = max(0.0, next_arrival)
            for t, q in service.items():
                if q:
                    q[0][1] -= r[t] * dt
            now = arrivals[idx].t_arrival
            req = arrivals[idx]
            idx += 1
            if ctrl.offer(req, now) == ADMIT:
                start(req)
            # QUEUE: the controller holds it; released on a future finish.
            # REJECT: shed — the controller's tally carries it.
            # Zero-remaining heads (the arrival landed exactly on a
            # completion) fall through to the completion branch next loop.
            continue
        dt, t = next_done
        for u, q in service.items():
            if q:
                q[0][1] -= r[u] * dt
        now += dt
        req = service[t][0][0]
        service[t].pop(0)
        finish(t, req)

    for t in loads:
        # The controller is the source of truth for decisions (it also
        # sheds queue-expired requests, which arrival-time tallies miss).
        stats[t].admitted = ctrl.stats[t].admitted + ctrl.stats[t].released
        stats[t].rejected = ctrl.stats[t].rejected
    horizon = max((ld.traffic.duration_s for ld in loads.values()),
                  default=0.0)
    horizon = max(horizon, now, _EPS)
    return SimResult(tenants=stats, horizon_s=horizon,
                     capacity_Bps=capacity_Bps)


def load_sweep(loads: Dict[int, TenantLoad], capacity_Bps: float,
               factors: List[float], *, seed: int = 0
               ) -> List[Dict[str, object]]:
    """One simulation per load factor (every tenant's rate scaled); rows
    carry offered load, p50/p99 and goodput per tenant — the ``serve``
    bench section's curve."""
    rows: List[Dict[str, object]] = []
    for f in factors:
        scaled = {t: dataclasses.replace(ld, traffic=ld.traffic.scaled(f))
                  for t, ld in loads.items()}
        res = simulate(scaled, capacity_Bps, seed=seed)
        rows.append({"load_factor": f, **res.summary()})
    return rows


def isolation_check(capacity_Bps: float, *, seed: int = 0,
                    mean_size: Optional[float] = None,
                    duration_s: float = 30.0,
                    n_requests: int = 30_000) -> Dict[str, object]:
    """The acceptance invariant: tenant A oversubscribes its fair share
    2×, tenant B offers exactly its fair share — B's goodput must stay
    ≥ 90% of that share.  Returns the measured figures (callers assert).

    The default ``mean_size`` scales with capacity so the offered stream
    is ~``n_requests`` total whatever the calibrated capacity — shares and
    latency targets are ratios of capacity, so the verdict is
    scale-invariant while the runtime stays bounded."""
    weights = {0: 1.0, 1: 1.0}
    share = {t: fair_share(capacity_Bps, weights, t) for t in weights}
    if mean_size is None:
        # Offered rate is 1.5 × capacity in bytes/s; pick the size that
        # turns that into n_requests over the horizon.
        mean_size = 1.5 * capacity_Bps * duration_s / n_requests
    mk = lambda t, over: TenantLoad(  # noqa: E731 - local table helper
        name=f"tenant{t}",
        slo=SLO(target_latency_s=8 * mean_size / share[t], weight=1.0,
                deadline_factor=4.0, max_inflight=8),
        traffic=TrafficConfig(
            rate_rps=over * share[t] / mean_size, mean_size=mean_size,
            duration_s=duration_s, tail_shape=2.5))
    res = simulate({0: mk(0, 2.0), 1: mk(1, 1.0)}, capacity_Bps, seed=seed)
    b = res.tenants[1]
    goodput = b.goodput_bytes / res.horizon_s
    return {
        "capacity_Bps": capacity_Bps,
        "fair_share_Bps": share[1],
        "victim_goodput_Bps": goodput,
        "victim_share_frac": goodput / share[1],
        "aggressor": res.tenants[0].summary(res.horizon_s),
        "victim": b.summary(res.horizon_s),
        "isolated": bool(goodput >= 0.9 * share[1]),
    }
