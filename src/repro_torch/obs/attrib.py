"""Per-tenant cost attribution — the exact ledger over a shared substrate.

A ``repro_torch.tenants.TenantServer`` run leaves every cost it incurred
split by flow:
the transport's per-(link, flow) goodput *and* fault counters (PR 10
extended the ARQ/recall accounting so wasted retransmissions, recall
reclassifications, backoff sweeps, and window stalls land in per-flow
buckets too), the memory system's per-(bank, flow) bytes/bursts/requests,
and — when a tracer recorded the run — the critical-path pass's per-flow
sweep decomposition.  :func:`build_ledger` folds all of it into one
:class:`CostLedger`: a row per tenant *incarnation* saying exactly what
its compute, network, memory, fault-recovery, and restore costs were.

The ledger is *exact*, not estimated: every integer column sums to the
matching global counter with integer equality
(:func:`assert_ledger_consistent` checks the identities against the raw
substrate counters, a :class:`~repro_torch.obs.critpath.CritPath`, and a
:class:`~repro_torch.obs.metrics.MetricsRegistry`).  That is what makes the two
headline claims checkable rather than aspirational:

* a lossy link shared by two weighted tenants charges each tenant's
  fault-recovery budget in proportion to its weight (the DRR arbiter
  spends service attempts by weight, so wasted attempts split the same
  way — ``tests/test_conservation_properties.py`` fuzzes the identity);
* a tenant-layer ``DeviceKill`` restore is charged to the
  killed tenant's *lineage* (the reborn ``name+recovered`` incarnation
  maps back to its root tenant), and its peers' fault columns are exactly
  zero.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .critpath import CritPath
from .metrics import MetricsRegistry


def lineage_root(name: str) -> str:
    """Root tenant of an incarnation name: ``a+recovered+recovered → a``."""
    while name.endswith("+recovered"):
        name = name[: -len("+recovered")]
    return name


@dataclasses.dataclass(frozen=True)
class LedgerRow:
    """One tenant incarnation's exact cost line."""

    tenant: str                    # incarnation name (e.g. "a+recovered")
    lineage: str                   # root tenant the cost is charged to
    flow: int
    status: str                    # running | done | killed | rejected
    weight: float
    recovered_via: Optional[str]   # "restore" | "recompile" | None
    # -- sweep buckets (critical-path decomposition; zero without a trace)
    compute_sweeps: int = 0
    network_sweeps: int = 0
    memory_sweeps: int = 0
    fault_sweeps: int = 0
    blocked_sweeps: int = 0
    idle_sweeps: int = 0
    tasks: int = 0
    # -- network ledger (exact per-flow link counters)
    net_bytes: int = 0             # goodput, hop-weighted
    net_flits: int = 0
    retransmit_bytes: int = 0      # fault-recovery wire bytes
    retransmit_flits: int = 0
    backoff_sweeps: int = 0        # Σ scheduled ARQ backoff delays
    arq_stalls: int = 0            # submissions refused: window full
    cancelled_bytes: int = 0       # in-flight payload abandoned at a kill
    # -- memory ledger (exact per-flow bank counters)
    mem_bytes: int = 0
    mem_bursts: int = 0
    mem_requests: int = 0
    # -- restore ledger: sweeps the incarnation exists *because of* a kill
    restore_sweeps: int = 0

    _INT_FIELDS = (
        "compute_sweeps", "network_sweeps", "memory_sweeps", "fault_sweeps",
        "blocked_sweeps", "idle_sweeps", "tasks", "net_bytes", "net_flits",
        "retransmit_bytes", "retransmit_flits", "backoff_sweeps",
        "arq_stalls", "cancelled_bytes", "mem_bytes", "mem_bursts",
        "mem_requests", "restore_sweeps")

    def fault_cost(self) -> Dict[str, int]:
        """The columns that exist only because something went wrong."""
        return {"fault_sweeps": self.fault_sweeps,
                "retransmit_bytes": self.retransmit_bytes,
                "retransmit_flits": self.retransmit_flits,
                "backoff_sweeps": self.backoff_sweeps,
                "arq_stalls": self.arq_stalls,
                "cancelled_bytes": self.cancelled_bytes,
                "restore_sweeps": self.restore_sweeps}

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CostLedger:
    """The full per-tenant cost attribution of one server run."""

    rows: List[LedgerRow]
    sweeps: int                    # the run's total sweeps (0 if unknown)

    def row(self, tenant: str) -> LedgerRow:
        for r in self.rows:
            if r.tenant == tenant:
                return r
        raise KeyError(tenant)

    def totals(self) -> Dict[str, int]:
        """Σ over rows of every integer column — the global side of the
        exact-sum identities."""
        out = {k: 0 for k in LedgerRow._INT_FIELDS}
        for r in self.rows:
            for k in LedgerRow._INT_FIELDS:
                out[k] += getattr(r, k)
        return out

    def by_lineage(self) -> Dict[str, Dict[str, int]]:
        """Costs re-charged to root tenants: a kill's restore incarnation
        bills its *victim's* account, never a peer's."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.rows:
            acc = out.setdefault(r.lineage,
                                 {k: 0 for k in LedgerRow._INT_FIELDS})
            for k in LedgerRow._INT_FIELDS:
                acc[k] += getattr(r, k)
        return out

    def to_json(self) -> Dict[str, Any]:
        return {"format": "cost-ledger/v1", "sweeps": self.sweeps,
                "rows": [r.to_json() for r in self.rows],
                "totals": self.totals(),
                "by_lineage": self.by_lineage()}

    def to_registry(self) -> MetricsRegistry:
        """``attrib.tenant.*`` series — the ledger in registry form, so
        the regression diff gate watches attribution like any metric."""
        reg = MetricsRegistry()
        for r in self.rows:
            reg.gauge_set("attrib.tenant.flow", r.flow, tenant=r.tenant)
            reg.gauge_set("attrib.tenant.weight", r.weight, tenant=r.tenant)
            for k in LedgerRow._INT_FIELDS:
                reg.counter_add(f"attrib.tenant.{k}", getattr(r, k),
                                tenant=r.tenant, lineage=r.lineage)
        return reg


def build_ledger(server, *, crit: Optional[CritPath] = None) -> CostLedger:
    """Fold a finished :class:`~repro_torch.tenants.TenantServer` (and
    optionally its run's :func:`~repro_torch.obs.critpath.analyze` result) into
    the exact per-tenant cost ledger.

    Without ``crit`` the sweep-bucket columns stay zero (byte/fault
    ledgers never need a trace); with it, each row's buckets are that
    flow's critical-path decomposition, summing per task to the run's
    makespan exactly.
    """
    tp = server.transport
    per_flow_crit = crit.per_flow() if crit is not None else {}
    rows: List[LedgerRow] = []
    for rec in server.records:
        flow = rec.flow
        faults = tp.flow_fault_totals(flow)
        net_flits = sum(c.flow_flits.get(flow, 0) for c in tp.counters)
        mem = (server.memsys.flow_mem_totals(flow)
               if server.memsys is not None
               else {"bytes": 0, "bursts": 0, "requests": 0})
        buckets = per_flow_crit.get(flow, {})
        restore = 0
        if rec.recovered_via is not None and rec.end_sweep is not None:
            # The reborn incarnation only exists because its predecessor
            # was killed: every sweep it ran is restore cost.
            restore = rec.end_sweep - rec.start_sweep
        rows.append(LedgerRow(
            tenant=rec.name,
            lineage=lineage_root(rec.name),
            flow=flow,
            status=rec.status,
            weight=rec.tenant.slo.weight,
            recovered_via=rec.recovered_via,
            compute_sweeps=buckets.get("compute", 0),
            network_sweeps=buckets.get("network", 0),
            memory_sweeps=buckets.get("memory", 0),
            fault_sweeps=buckets.get("fault", 0),
            blocked_sweeps=buckets.get("blocked_other", 0),
            idle_sweeps=buckets.get("idle", 0),
            tasks=buckets.get("tasks", 0),
            net_bytes=tp.flow_link_bytes(flow),
            net_flits=net_flits,
            retransmit_bytes=faults["retransmit_bytes"],
            retransmit_flits=faults["retransmit_flits"],
            backoff_sweeps=faults["backoff_sweeps"],
            arq_stalls=faults["arq_stalls"],
            cancelled_bytes=tp.cancelled_flow_bytes.get(flow, 0),
            mem_bytes=mem["bytes"],
            mem_bursts=mem["bursts"],
            mem_requests=mem["requests"],
            restore_sweeps=restore,
        ))
    sweeps = crit.sweeps if crit is not None else 0
    return CostLedger(rows=rows, sweeps=sweeps)


def substrate_metrics(server) -> MetricsRegistry:
    """Global + per-flow series straight off the shared substrate's
    counters (``net.link.*`` / ``mem.bank.*``) — the registry the ledger's
    exact-sum identities are checked against."""
    reg = MetricsRegistry()
    for li, c in enumerate(server.transport.counters):
        reg.counter_add("net.link.goodput_bytes", c.bytes, link=li)
        reg.counter_add("net.link.flits", c.flits, link=li)
        reg.counter_add("net.link.retransmit_bytes", c.retransmit_bytes,
                        link=li)
        reg.counter_add("net.link.retransmit_flits", c.retransmit_flits,
                        link=li)
        reg.counter_add("net.link.backoff_sweeps", c.backoff_sweeps, link=li)
        reg.counter_add("net.link.arq_stalls", c.arq_stalls, link=li)
        for flow, b in sorted(c.flow_bytes.items()):
            reg.counter_add("net.link.flow_bytes", b, link=li, flow=flow)
        for flow, b in sorted(c.flow_retransmit_bytes.items()):
            reg.counter_add("net.link.flow_retransmit_bytes", b,
                            link=li, flow=flow)
    if server.memsys is not None:
        for bid, c in enumerate(server.memsys.counters):
            reg.counter_add("mem.bank.bytes", c.bytes, bank=bid)
            reg.counter_add("mem.bank.bursts", c.bursts, bank=bid)
            reg.counter_add("mem.bank.requests", c.requests, bank=bid)
            for flow, b in sorted(c.flow_bytes.items()):
                reg.counter_add("mem.bank.flow_bytes", b,
                                bank=bid, flow=flow)
    return reg


def assert_ledger_consistent(ledger: CostLedger, server, *,
                             crit: Optional[CritPath] = None,
                             registry: Optional[MetricsRegistry] = None
                             ) -> None:
    """Every ledger column sums to its global counter with **integer
    equality** — against the raw substrate counters always, against the
    critical path and a registry when given.  Raises AssertionError on
    the first violated identity (this is a checked invariant, not a
    report)."""
    tp = server.transport
    tot = ledger.totals()
    # -- network: Σ rows == Σ links, exact ints ------------------------------
    assert tot["net_bytes"] == sum(c.bytes for c in tp.counters), \
        "ledger net_bytes != Σ link goodput bytes"
    assert tot["net_flits"] == sum(c.flits for c in tp.counters), \
        "ledger net_flits != Σ link goodput flits"
    assert tot["retransmit_bytes"] == \
        sum(c.retransmit_bytes for c in tp.counters), \
        "ledger retransmit_bytes != Σ link retransmit bytes"
    assert tot["retransmit_flits"] == \
        sum(c.retransmit_flits for c in tp.counters), \
        "ledger retransmit_flits != Σ link retransmit flits"
    assert tot["backoff_sweeps"] == \
        sum(c.backoff_sweeps for c in tp.counters), \
        "ledger backoff_sweeps != Σ link backoff sweeps"
    assert tot["arq_stalls"] == sum(c.arq_stalls for c in tp.counters), \
        "ledger arq_stalls != Σ link window stalls"
    assert tot["cancelled_bytes"] == tp.cancelled_bytes, \
        "ledger cancelled_bytes != transport cancelled bytes"
    # Per link, too: every flow bucket sums back to its link's global.
    for li, c in enumerate(tp.counters):
        assert sum(c.flow_bytes.values()) == c.bytes, f"link {li} bytes"
        assert sum(c.flow_retransmit_bytes.values()) == \
            c.retransmit_bytes, f"link {li} retransmit bytes"
        assert sum(c.flow_retransmit_flits.values()) == \
            c.retransmit_flits, f"link {li} retransmit flits"
        assert sum(c.flow_backoff_sweeps.values()) == \
            c.backoff_sweeps, f"link {li} backoff sweeps"
        assert sum(c.flow_arq_stalls.values()) == c.arq_stalls, \
            f"link {li} arq stalls"
    # -- memory --------------------------------------------------------------
    if server.memsys is not None:
        banks = server.memsys.counters
        assert tot["mem_bytes"] == sum(c.bytes for c in banks), \
            "ledger mem_bytes != Σ bank bytes"
        assert tot["mem_bursts"] == sum(c.bursts for c in banks), \
            "ledger mem_bursts != Σ bank bursts"
        assert tot["mem_requests"] == sum(c.requests for c in banks), \
            "ledger mem_requests != Σ bank requests"
        for bid, c in enumerate(banks):
            assert sum(c.flow_requests.values()) == c.requests, \
                f"bank {bid} requests"
    # -- critical path: rows' buckets ARE the per-flow decomposition ---------
    if crit is not None:
        per_flow = crit.per_flow()
        keymap = {"compute_sweeps": "compute", "network_sweeps": "network",
                  "memory_sweeps": "memory", "fault_sweeps": "fault",
                  "blocked_sweeps": "blocked_other", "idle_sweeps": "idle",
                  "tasks": "tasks"}
        for r in ledger.rows:
            buckets = per_flow.get(r.flow, {k: 0 for k in keymap.values()})
            for col, key in keymap.items():
                assert getattr(r, col) == buckets.get(key, 0), \
                    f"tenant {r.tenant}: {col} != critpath {key}"
            # The decomposition identity per flow: buckets fill each of
            # the flow's task-sweep cells exactly once.
            assert (r.compute_sweeps + r.network_sweeps + r.memory_sweeps
                    + r.fault_sweeps + r.blocked_sweeps + r.idle_sweeps
                    ) == crit.sweeps * r.tasks, \
                f"tenant {r.tenant}: buckets != sweeps × tasks"
        for col, key in keymap.items():
            assert tot[col] == sum(b.get(key, 0)
                                   for b in per_flow.values()), \
                f"ledger Σ {col} != critpath Σ {key}"
    # -- registry ------------------------------------------------------------
    if registry is not None:
        pairs = [("net_bytes", "net.link.goodput_bytes"),
                 ("net_flits", "net.link.flits"),
                 ("retransmit_bytes", "net.link.retransmit_bytes"),
                 ("retransmit_flits", "net.link.retransmit_flits"),
                 ("backoff_sweeps", "net.link.backoff_sweeps"),
                 ("arq_stalls", "net.link.arq_stalls")]
        if server.memsys is not None:
            pairs += [("mem_bytes", "mem.bank.bytes"),
                      ("mem_bursts", "mem.bank.bursts"),
                      ("mem_requests", "mem.bank.requests")]
        for col, metric in pairs:
            if not registry.series(metric):
                continue   # the registry never tracked this metric
            assert tot[col] == int(registry.total(metric)), \
                f"ledger Σ {col} != registry {metric} total"


def assert_peers_uncharged(ledger: CostLedger, victims: List[str]) -> None:
    """After a :class:`DeviceKill` on a clean fabric, every tenant whose
    lineage was NOT killed must show an exactly-zero fault column set —
    the 'blast radius is the victim' acceptance identity."""
    victim_roots = {lineage_root(v) for v in victims}
    for lineage, cost in ledger.by_lineage().items():
        if lineage in victim_roots:
            continue
        for k in ("fault_sweeps", "retransmit_bytes", "retransmit_flits",
                  "backoff_sweeps", "arq_stalls", "cancelled_bytes",
                  "restore_sweeps"):
            assert cost[k] == 0, \
                f"peer lineage {lineage} charged nonzero {k}={cost[k]}"
