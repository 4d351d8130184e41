"""Critical-path attribution — *where did the sweeps go?*

Post-hoc analysis over a recorded :class:`~repro_torch.obs.trace.Tracer`.  The
executor emits, for every task at every sweep it considered, either a
``task_fire`` or a ``task_wait`` with the blocking reason — the head of
the blocking chain the tracer observed (task waited on a channel → the
channel waited on link credits → the link waited on ARQ/arbitration →
the read waited on a bank).  Folding those per-task, per-sweep records
gives an **exact integer decomposition** of the measured makespan:

``compute + network + memory + fault + blocked_other + idle == sweeps``

* ``compute`` — sweeps the task fired;
* ``network`` — input starved on in-flight fabric traffic (reasons
  ``net``/``transit``) at sweeps with *no* ARQ activity on the task's
  flow;
* ``fault`` — the same network waits at sweeps where the flow had ARQ
  activity (retransmit, backoff, reclassify, link death, reroute): the
  fabric was busy *re-sending*, so the stall is fault recovery, not
  capacity;
* ``memory`` — a memory response was pending (reason ``mem``);
* ``blocked_other`` — §4.6 starvation, downstream backpressure, or a
  plain dataflow dependency (reasons ``starve``/``backpressure``/
  ``upstream``);
* ``idle`` — sweeps with no event for the task (drained, or finished
  early); the residual, asserted non-negative.

:func:`analyze` builds the per-task table; ``critical()`` is the least
idle task — the measured critical path.  :func:`makespan_row` /
:func:`format_table` produce the predicted-vs-measured makespan table
against the §5 schedule pass, making the ROADMAP's flat-λ scheduling
error a printed, testable number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .trace import FAULT_KINDS, Tracer

#: task_wait reasons attributed to the network bucket (pre fault carve-out).
NET_REASONS = ("net", "transit")


@dataclasses.dataclass(frozen=True)
class TaskAttribution:
    """One task's exact sweep decomposition (all fields in sweeps)."""

    task: str
    flow: int
    device: int
    makespan: int              # total sweeps of the run
    compute: int               # task_fire events
    network: int               # net/transit waits outside fault sweeps
    memory: int                # mem waits
    fault: int                 # net/transit waits during ARQ activity
    blocked_other: int         # starve + backpressure + upstream
    idle: int                  # residual (>= 0 by assertion)
    reasons: Dict[str, int]    # raw per-reason wait counts

    def buckets(self) -> Dict[str, int]:
        return {"compute": self.compute, "network": self.network,
                "memory": self.memory, "fault": self.fault,
                "blocked_other": self.blocked_other, "idle": self.idle}

    @property
    def busy(self) -> int:
        """Non-idle sweeps — the tie-breaker for the critical path."""
        return self.makespan - self.idle

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["busy"] = self.busy
        return d


@dataclasses.dataclass(frozen=True)
class CritPath:
    """The full attribution for one run."""

    sweeps: int
    tasks: List[TaskAttribution]
    #: link → number of distinct sweeps with ARQ/fault events on it.
    fault_link_sweeps: Dict[int, int]

    def critical(self, flow: Optional[int] = None) -> TaskAttribution:
        """The least-idle task — the measured critical path (per flow
        when given)."""
        cand = [t for t in self.tasks if flow is None or t.flow == flow]
        if not cand:
            raise ValueError(f"no tasks traced for flow {flow!r}")
        return max(cand, key=lambda t: (t.busy, t.compute, t.task))

    def flows(self) -> List[int]:
        return sorted({t.flow for t in self.tasks})

    def per_flow(self) -> Dict[int, Dict[str, int]]:
        """Summed buckets per tenant flow (per-tenant attribution)."""
        out: Dict[int, Dict[str, int]] = {}
        for t in self.tasks:
            acc = out.setdefault(t.flow, {
                "compute": 0, "network": 0, "memory": 0, "fault": 0,
                "blocked_other": 0, "idle": 0, "tasks": 0})
            for k, v in t.buckets().items():
                acc[k] += v
            acc["tasks"] += 1
        return out

    def decomposition(self, flow: Optional[int] = None) -> Dict[str, int]:
        """The critical task's buckets — sums to ``sweeps`` exactly."""
        crit = self.critical(flow)
        out = dict(crit.buckets())
        out["task"] = crit.task            # type: ignore[assignment]
        out["sweeps"] = crit.makespan      # type: ignore[assignment]
        return out

    def to_json(self) -> Dict[str, Any]:
        return {
            "sweeps": self.sweeps,
            "critical": self.critical().to_json() if self.tasks else None,
            "tasks": [t.to_json() for t in self.tasks],
            "fault_link_sweeps": {str(k): v for k, v in
                                  sorted(self.fault_link_sweeps.items())},
            "per_flow": {str(k): v for k, v in self.per_flow().items()},
        }


def analyze(tracer: Tracer, *, sweeps: int) -> CritPath:
    """Fold a recorded trace into the exact makespan decomposition.

    ``sweeps`` is the measured makespan (``report.sweeps``).  Raises if
    the residual idle of any task would be negative — that would mean a
    task logged more than one event per sweep, i.e. an instrumentation
    bug, not a measurement.
    """
    # Sweeps with fault activity, per flow (link_death hits every flow).
    fault_sweeps_flow: Dict[int, set] = {}
    fault_sweeps_all: set = set()
    fault_link_sweeps: Dict[int, set] = {}
    for e in tracer.events:
        kind = e[0]
        if kind not in FAULT_KINDS:
            continue
        sweep = e[1]
        if kind == "link_death":
            fault_sweeps_all.add(sweep)
            fault_link_sweeps.setdefault(e[2], set()).add(sweep)
            continue
        if kind == "reroute":
            fault_sweeps_flow.setdefault(e[3], set()).add(sweep)
            continue
        # retransmit / arq_backoff / flit_reclassify: (link, x, flow, ...)
        fault_sweeps_flow.setdefault(e[4], set()).add(sweep)
        fault_link_sweeps.setdefault(e[2], set()).add(sweep)

    fired: Dict[Tuple[int, str], List[Any]] = {}
    for e in tracer.events:
        kind = e[0]
        if kind == "task_fire":
            _, sweep, task, device, _busy, flow = e
            rec = fired.setdefault((flow, task), [device, 0, {}, set()])
            rec[0] = device
            rec[1] += 1
        elif kind == "task_wait":
            _, sweep, task, device, reason, flow = e
            rec = fired.setdefault((flow, task), [device, 0, {}, set()])
            rec[0] = device
            rec[2][reason] = rec[2].get(reason, 0) + 1
            if reason in NET_REASONS:
                rec[3].add(sweep)

    tasks: List[TaskAttribution] = []
    for (flow, task), (device, nfired, reasons, net_sweeps) in \
            sorted(fired.items()):
        faulty = fault_sweeps_flow.get(flow, set()) | fault_sweeps_all
        fault = sum(1 for s in net_sweeps if s in faulty)
        # net_sweeps is a set of sweeps but a task waits at most once per
        # sweep, so its size equals the net+transit reason counts.
        network = sum(reasons.get(r, 0) for r in NET_REASONS) - fault
        memory = reasons.get("mem", 0)
        other = (reasons.get("starve", 0) + reasons.get("backpressure", 0)
                 + reasons.get("upstream", 0))
        idle = sweeps - nfired - network - memory - fault - other
        if idle < 0:
            raise AssertionError(
                f"task {task!r} (flow {flow}) over-attributed: "
                f"{-idle} sweeps more events than the run had")
        tasks.append(TaskAttribution(
            task=task, flow=flow, device=device, makespan=sweeps,
            compute=nfired, network=network, memory=memory, fault=fault,
            blocked_other=other, idle=idle, reasons=dict(reasons)))
    return CritPath(
        sweeps=sweeps, tasks=tasks,
        fault_link_sweeps={li: len(s) for li, s in
                           sorted(fault_link_sweeps.items())})


# -- predicted-vs-measured makespan table -------------------------------------

def makespan_row(app: str, design, report, crit: CritPath,
                 *, sweep_time_s: float = 1e-6) -> Dict[str, Any]:
    """One table row: the §5 schedule pass's predicted makespan against
    the measured one, with the critical task's trace-derived shares.

    ``error_pct`` is the flat-λ scheduling error the ROADMAP calls out —
    predicted uses a single calibration λ, measured includes the per-link
    contention the fabric actually produced.
    """
    predicted = design.schedule.makespan if design.schedule else None
    measured = report.sweeps * sweep_time_s
    dec = crit.decomposition()
    total = sum(v for k, v in dec.items()
                if k not in ("task", "sweeps"))
    assert total == report.sweeps, (
        f"decomposition {total} != measured makespan {report.sweeps}")
    return {
        "app": app,
        "predicted_s": predicted,
        "measured_s": measured,
        "measured_sweeps": report.sweeps,
        "error_pct": (100.0 * (measured - predicted) / predicted
                      if predicted else None),
        "critical_task": dec["task"],
        "compute": dec["compute"], "network": dec["network"],
        "memory": dec["memory"], "fault": dec["fault"],
        "blocked_other": dec["blocked_other"], "idle": dec["idle"],
    }


def format_table(rows: List[Dict[str, Any]]) -> str:
    """Render the predicted-vs-measured table for printing."""
    cols = ("app", "predicted_s", "measured_s", "error_pct",
            "critical_task", "compute", "network", "memory", "fault",
            "blocked_other", "idle")
    head = ("app", "predicted(s)", "measured(s)", "err%", "crit task",
            "comp", "net", "mem", "fault", "other", "idle")

    def fmt(row: Dict[str, Any], col: str) -> str:
        v = row[col]
        if v is None:
            return "-"
        if col in ("predicted_s", "measured_s"):
            return f"{v:.3e}"
        if col == "error_pct":
            return f"{v:+.1f}"
        return str(v)

    table = [head] + [tuple(fmt(r, c) for c in cols) for r in rows]
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths))
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
