"""Online SLO monitoring — watching the trace *while* the server sweeps.

PR 9's registry and critical path only speak after a run finishes; this
module closes the loop the ROADMAP asks for: an :class:`SLOMonitor`
handed to :meth:`TenantServer.run(monitor=...)
<TenantServer.run>` consumes the shared tracer
*incrementally* — one pass over the events appended since its last call,
never a rescan — and maintains, per tenant flow, inside a sliding sweep
window:

* **message latency** p50/p99 (``channel_push → channel_pop`` pairing,
  per flow, converted to seconds by the fabric's sweep time);
* **goodput** (delivered message bytes per second over the window);
* **error-budget burn rate** — elapsed time over the tenant's admission
  deadline (``target_latency_s × deadline_factor``, the same budget
  the tenant layer's ``AdmissionController`` priced the tenant at).
  Burn 1.0 = the deadline is spent.

Threshold crossings emit typed ``slo_alert`` events **into the same
trace** (debounced per (flow, metric) by a cooldown), so alerts land in
the Chrome export timeline next to the activity that caused them.
:meth:`SLOMonitor.feed` forwards live burn rates into
:meth:`AdmissionController.note_burn` — admission sees pressure while it
builds, not in the post-mortem.

The monitor is read-only over the substrate: it touches nothing but the
tracer (reads events, appends alerts), so a monitored run is
bit-identical to an unmonitored one (the JAX package's
``benchmarks/perf.py`` v8 asserts identity and bounds the overhead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


def _percentile(sorted_vals: List[int], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (q in [0, 1])."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return float(sorted_vals[idx])


@dataclasses.dataclass
class _FlowWindow:
    """One tenant flow's live state inside the monitor."""

    name: str
    slo: Any                          # the tenant layer's SLO
    start_sweep: int
    #: (channel, src, dst) → FIFO of (push_sweep, nbytes) awaiting pop.
    pending: Dict[Tuple[int, str, str], List[Tuple[int, int]]] = \
        dataclasses.field(default_factory=dict)
    #: Completed messages: (pop_sweep, latency_sweeps, nbytes).
    completed: List[Tuple[int, int, int]] = \
        dataclasses.field(default_factory=list)
    done_sweep: Optional[int] = None
    alerts: int = 0
    #: metric → last sweep an alert fired (cooldown debounce).
    last_alert: Dict[str, int] = dataclasses.field(default_factory=dict)


class SLOMonitor:
    """Windowed per-tenant SLO telemetry, computed live from the trace.

    ``window`` is the sliding window in sweeps; ``latency_limit_s``
    optionally overrides the per-message p99 alert threshold (default:
    the tenant's own ``target_latency_s`` — a single message taking the
    whole job budget is unambiguously pathological); ``burn_alert`` is
    the burn-rate threshold (1.0 = alert when the admission deadline is
    spent); ``cooldown`` debounces repeated alerts per (flow, metric).
    """

    def __init__(self, *, window: int = 64,
                 latency_limit_s: Optional[float] = None,
                 burn_alert: float = 1.0,
                 cooldown: int = 32):
        if window < 1 or cooldown < 0 or burn_alert <= 0:
            raise ValueError("window >= 1, cooldown >= 0, burn_alert > 0")
        self.window = int(window)
        self.latency_limit_s = latency_limit_s
        self.burn_alert = float(burn_alert)
        self.cooldown = int(cooldown)
        self.flows: Dict[int, _FlowWindow] = {}
        self.alerts: List[Dict[str, Any]] = []
        self._idx = 0                 # tracer.events consumed so far
        self._sweep_time_s = 1e-6

    # -- the per-sweep hook (called inside TenantServer.run) -----------------
    def observe(self, server, sweep: int) -> List[Dict[str, Any]]:
        """Consume the events appended since the last call, refresh every
        flow's window, and emit alerts for fresh threshold crossings.
        Returns the alerts raised *this* sweep."""
        tracer = server.tracer
        self._sweep_time_s = server.net_config.sweep_time_s
        self._register(server, sweep)
        events = tracer.events
        for i in range(self._idx, len(events)):
            e = events[i]
            kind = e[0]
            if kind == "channel_push":
                fw = self.flows.get(e[6])
                if fw is not None:
                    fw.pending.setdefault((e[2], e[3], e[4]), []) \
                        .append((e[1], e[5]))
            elif kind == "channel_pop":
                fw = self.flows.get(e[5])
                if fw is not None:
                    q = fw.pending.get((e[2], e[3], e[4]))
                    if q:
                        push_sweep, nbytes = q.pop(0)
                        fw.completed.append(
                            (e[1], e[1] - push_sweep, nbytes))
        self._idx = len(events)
        raised: List[Dict[str, Any]] = []
        horizon = sweep - self.window
        for flow, fw in self.flows.items():
            if fw.done_sweep is not None:
                continue
            # Trim the sliding window (completions are in pop order).
            while fw.completed and fw.completed[0][0] <= horizon:
                fw.completed.pop(0)
            snap = self.snapshot(flow, sweep)
            limit = (self.latency_limit_s if self.latency_limit_s
                     is not None else fw.slo.target_latency_s)
            if snap["completed"] and snap["p99_latency_s"] > limit:
                raised += self._alert(tracer, sweep, flow, "p99_latency_s",
                                      snap["p99_latency_s"], limit)
            if snap["burn_rate"] > self.burn_alert:
                raised += self._alert(tracer, sweep, flow, "burn_rate",
                                      snap["burn_rate"], self.burn_alert)
        return raised

    def _register(self, server, sweep: int) -> None:
        """Adopt flows the server admitted since the last call (including
        re-admissions after a kill) and retire finished/killed ones."""
        for rec in server.records:
            fw = self.flows.get(rec.flow)
            if fw is None:
                fw = _FlowWindow(name=rec.name, slo=rec.tenant.slo,
                                 start_sweep=rec.start_sweep)
                self.flows[rec.flow] = fw
            if rec.status != "running" and fw.done_sweep is None:
                fw.done_sweep = rec.end_sweep if rec.end_sweep is not None \
                    else sweep

    def _alert(self, tracer, sweep: int, flow: int, metric: str,
               value: float, threshold: float) -> List[Dict[str, Any]]:
        fw = self.flows[flow]
        last = fw.last_alert.get(metric)
        if last is not None and sweep - last < self.cooldown:
            return []
        fw.last_alert[metric] = sweep
        fw.alerts += 1
        alert = {"sweep": sweep, "flow": flow, "tenant": fw.name,
                 "metric": metric, "value": value, "threshold": threshold}
        self.alerts.append(alert)
        if tracer.enabled:
            tracer.slo_alert(sweep, flow, fw.name, metric, value, threshold)
        return [alert]

    # -- queries -------------------------------------------------------------
    def snapshot(self, flow: int, sweep: int) -> Dict[str, Any]:
        """One flow's windowed telemetry at ``sweep``."""
        fw = self.flows[flow]
        lat = sorted(c[1] for c in fw.completed)
        window_bytes = sum(c[2] for c in fw.completed)
        window_s = self.window * self._sweep_time_s
        end = fw.done_sweep if fw.done_sweep is not None else sweep
        elapsed_s = max(0, end - fw.start_sweep) * self._sweep_time_s
        budget_s = fw.slo.target_latency_s * fw.slo.deadline_factor
        return {
            "tenant": fw.name,
            "completed": len(lat),
            "p50_latency_s": _percentile(lat, 0.50) * self._sweep_time_s,
            "p99_latency_s": _percentile(lat, 0.99) * self._sweep_time_s,
            "goodput_Bps": window_bytes / window_s if window_s else 0.0,
            "burn_rate": elapsed_s / budget_s if budget_s else 0.0,
            "alerts": fw.alerts,
        }

    def burn_rates(self, sweep: int) -> Dict[int, float]:
        return {flow: self.snapshot(flow, sweep)["burn_rate"]
                for flow in self.flows}

    def feed(self, controller, sweep: int) -> None:
        """Forward live burn rates into
        ``AdmissionController.note_burn`` — the
        monitor-to-admission signal path."""
        for flow, burn in self.burn_rates(sweep).items():
            controller.note_burn(flow, burn)

    def summary(self, sweep: int) -> Dict[str, Any]:
        """JSON-ready monitor state (smoke artifacts)."""
        return {
            "window": self.window,
            "alerts": list(self.alerts),
            "tenants": {self.flows[f].name: self.snapshot(f, sweep)
                        for f in sorted(self.flows)},
        }
