"""Admission control + SLO bookkeeping — the front door of the tenant layer.

Every tenant declares an :class:`SLO`: a latency target, a weight (its
fair share of the substrate, the same weight the link arbiter enforces),
and a deadline factor bounding how late a request may finish before it
was pointless to serve.  The :class:`AdmissionController` makes the
three-way call the tentpole names for every offered request:

* **admit** — the request enters service (or the head of the service
  window) immediately;
* **queue** — the substrate is busy but the request can still make its
  deadline; it waits in the pending queue;
* **reject** — even an immediate start could not meet the deadline given
  the work already queued ahead of it at the tenant's weighted service
  rate; open-loop load that the system cannot carry is shed at the door
  instead of poisoning every queue behind it.

Release order uses **deadline-aware priority aging**: a pending request's
priority is its age normalized by its tenant's latency target — a request
against a 10 ms target ages ten times faster than one against 100 ms, so
tight-SLO tenants overtake loose ones as they wait, but a loose-SLO
request can never be starved forever (its priority grows without bound —
the aging part).  Ties break deterministically by (arrival, tenant, rid).

The controller is pure bookkeeping over *virtual* time — the serving
simulation (:mod:`repro_torch.tenants.simulate`) and the live tenant
server both drive it with their own clocks; it never reads a wall clock.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from .traffic import Request

ADMIT, QUEUE, REJECT = "admit", "queue", "reject"


@dataclasses.dataclass(frozen=True)
class SLO:
    """One tenant's service-level objective."""

    target_latency_s: float        # p-line latency target
    weight: float = 1.0            # fair-share weight (drives the arbiter)
    deadline_factor: float = 4.0   # reject if finish > factor × target late
    max_inflight: int = 4          # service-window slots (rest queues)

    def __post_init__(self):
        if self.target_latency_s <= 0 or self.weight <= 0:
            raise ValueError("target latency and weight must be positive")
        if self.deadline_factor < 1.0:
            raise ValueError("deadline_factor must be >= 1")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")

    def deadline(self, r: Request) -> float:
        return r.t_arrival + self.deadline_factor * self.target_latency_s


@dataclasses.dataclass
class AdmissionStats:
    """Per-tenant decision tally."""

    offered: int = 0
    admitted: int = 0
    queued: int = 0
    rejected: int = 0
    released: int = 0              # queued requests later moved to service


class AdmissionController:
    """Deadline-aware admit / queue / reject with priority aging.

    ``slos`` maps tenant flow id → :class:`SLO`.  The caller tells the
    controller the tenant's **service rate** (bytes of work per second it
    can expect under its weight — e.g. capacity × weight / Σ weights) so
    the deadline feasibility test prices queued work in seconds.
    """

    def __init__(self, slos: Dict[int, SLO],
                 service_rate: Dict[int, float]):
        self.slos = dict(slos)
        self.rate = dict(service_rate)
        for t, r in self.rate.items():
            if r <= 0:
                raise ValueError(f"tenant {t}: service rate must be positive")
        self.stats: Dict[int, AdmissionStats] = {
            t: AdmissionStats() for t in self.slos}
        self.inflight: Dict[int, int] = {t: 0 for t in self.slos}
        self._queued_work: Dict[int, float] = {t: 0.0 for t in self.slos}
        # Live observability signal (repro_torch.obs.slo): a tenant burning
        # its error budget has its effective service rate discounted, so
        # the deadline feasibility test turns pessimistic *while* the burn
        # is happening instead of after the post-hoc report.  1.0 = no
        # signal.
        self._rate_scale: Dict[int, float] = {}
        # Pending heap keyed by deterministic FIFO order; priorities are
        # recomputed against `now` at release time (aging is a function of
        # age, so the *relative* order only changes across tenants).
        self._pending: List[Tuple[float, int, int, Request]] = []

    # -- the three-way call --------------------------------------------------
    def offer(self, r: Request, now: float) -> str:
        """Decide one arriving request; returns ADMIT / QUEUE / REJECT."""
        slo = self.slos[r.tenant]
        st = self.stats[r.tenant]
        st.offered += 1
        # Work ahead of this request at the tenant's weighted rate: its own
        # in-service + queued bytes, priced in seconds.  The rate is
        # discounted by the live burn-rate signal (see note_burn).
        rate = self.rate[r.tenant] * self._rate_scale.get(r.tenant, 1.0)
        backlog_s = self._queued_work[r.tenant] / rate
        finish = now + backlog_s + r.size / rate
        if finish > slo.deadline(r):
            st.rejected += 1
            return REJECT
        self._queued_work[r.tenant] += r.size
        if self.inflight[r.tenant] < slo.max_inflight:
            self.inflight[r.tenant] += 1
            st.admitted += 1
            return ADMIT
        heapq.heappush(self._pending,
                       (r.t_arrival, r.tenant, r.rid, r))
        st.queued += 1
        return QUEUE

    # -- priority aging ------------------------------------------------------
    def priority(self, r: Request, now: float) -> float:
        """Age normalized by the tenant's target — bigger is more urgent."""
        return (now - r.t_arrival) / self.slos[r.tenant].target_latency_s

    def release(self, now: float) -> Optional[Request]:
        """Move the most-urgent pending request into a freed service slot.

        Returns it (caller starts serving), or None if nothing pends or
        every pending tenant's window is full.  A pending request whose
        deadline already passed is shed here — late release would burn
        capacity on work nobody can use (counted as rejected).
        """
        # Full scan: pending sets are small (bounded by max_inflight churn)
        # and aging reorders across tenants, so a static heap can't rank it.
        while True:
            best_i, best_p = -1, None
            for i, (_, tenant, _rid, r) in enumerate(self._pending):
                if self.inflight[tenant] >= self.slos[tenant].max_inflight:
                    continue
                p = self.priority(r, now)
                key = (p, -r.t_arrival, -r.tenant, -r.rid)
                if best_p is None or key > best_p:
                    best_i, best_p = i, key
            if best_i < 0:
                return None
            _, tenant, _rid, r = self._pending.pop(best_i)
            heapq.heapify(self._pending)
            if now > self.slos[tenant].deadline(r):
                # Expired in the queue: shed, try the next one.
                self._queued_work[tenant] -= r.size
                self.stats[tenant].rejected += 1
                self.stats[tenant].queued -= 1
                continue
            self.inflight[tenant] += 1
            self.stats[tenant].released += 1
            return r

    def complete(self, r: Request) -> None:
        """A request finished service: free its slot and its queued work."""
        self.inflight[r.tenant] -= 1
        self._queued_work[r.tenant] -= r.size

    # -- live observability signal -------------------------------------------
    def note_burn(self, tenant: int, burn_rate: float) -> None:
        """Feed one tenant's error-budget burn rate from the online SLO
        monitor (:meth:`repro_torch.obs.slo.SLOMonitor.feed`).  A burn rate
        above 1.0 (budget exhausted at the observed pace) discounts the
        tenant's effective service rate proportionally, so admission sheds
        load it can no longer carry *now*; burn <= 1.0 restores the full
        declared rate.  Unknown tenants are ignored (the monitor may see
        flows the controller never admitted)."""
        if tenant not in self.slos:
            return
        self._rate_scale[tenant] = 1.0 / max(1.0, float(burn_rate))

    def rate_scale(self, tenant: int) -> float:
        return self._rate_scale.get(tenant, 1.0)

    # -- queries -------------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._pending)

    def summary(self) -> Dict[int, Dict[str, int]]:
        return {t: dataclasses.asdict(s) for t, s in self.stats.items()}
