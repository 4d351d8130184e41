"""`MetricsRegistry` — one ``layer.object.metric`` namespace for every
counter the stack keeps.

Each runtime layer historically grew its own ad-hoc counters
(``congestion_waits`` on the executor, ``retransmit_bytes`` on link
counters, ``flow_bytes`` on banks, …).  The registry *subsumes* them:
:func:`from_report` folds one :class:`~repro_torch.exec.report.ExecutionReport`
into named, labeled series —

====================  =====================================================
prefix                series
====================  =====================================================
``exec.task.*``       ``congestion_waits``, ``mem_waits``,
                      ``starvation_events`` — labeled ``task=``
``exec.device.*``     ``fired`` (counter), ``busy_s`` (gauge) — ``device=``
``exec.channel.*``    ``tokens``, ``bytes``, ``net_bytes``,
                      ``max_occupancy`` — ``channel=`` (inter-device only)
``net.link.*``        ``goodput_bytes``, ``flits``, ``retransmit_bytes``,
                      ``retransmit_flits``, ``drops``, ``crc_errors``,
                      ``down_losses``, ``arq_stalls``, ``stalled_flits``
                      (counters) and ``utilization`` (gauge) — ``link=``
``mem.bank.*``        ``bytes``, ``bursts``, ``requests``,
                      ``saturated_sweeps`` (counters), ``utilization``
                      (gauge) — ``device=``, ``bank=``
``tenant.flow.*``     per-tenant views (``TenantServer.metrics()``):
                      ``net_bytes``, ``mem_bytes``, ``sweeps``,
                      ``restores`` — ``tenant=``
====================  =====================================================

The registry is a *view*, not a second source of truth:
:func:`assert_registry_consistent` re-derives every total from the legacy
report fields and requires exact equality (ints compare with ``==``,
floats with ``math.isclose(rel_tol=0, abs_tol=0)`` — i.e. also exact), and
:func:`assert_trace_report_consistent` closes the loop against the
recorded trace.  Migrating call sites read
``report.metrics.total("net.link.retransmit_bytes")`` instead of the
deprecated ``report.net_retransmit_bytes`` shim.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional, Tuple

_TYPES = ("counter", "gauge", "histogram")

LabelKey = Tuple[Tuple[str, Any], ...]


def _labelkey(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Named counters / gauges / histograms with sorted-tuple label keys.

    A metric name is ``layer.object.metric``; a series is one (name,
    labels) pair.  Counters add, gauges set, histograms keep the
    count/total/min/max digest (enough for overhead and latency summaries
    without storing samples).
    """

    def __init__(self) -> None:
        # name -> (type, {labelkey: value-or-digest})
        self._metrics: Dict[str, Tuple[str, Dict[LabelKey, Any]]] = {}

    # -- write ---------------------------------------------------------------
    def _series(self, name: str, mtype: str) -> Dict[LabelKey, Any]:
        got = self._metrics.get(name)
        if got is None:
            got = (mtype, {})
            self._metrics[name] = got
        elif got[0] != mtype:
            raise TypeError(
                f"metric {name!r} is a {got[0]}, not a {mtype}")
        return got[1]

    def counter_add(self, name: str, value: float = 1, **labels) -> None:
        s = self._series(name, "counter")
        k = _labelkey(labels)
        s[k] = s.get(k, 0) + value

    def gauge_set(self, name: str, value: float, **labels) -> None:
        self._series(name, "gauge")[_labelkey(labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        s = self._series(name, "histogram")
        k = _labelkey(labels)
        d = s.get(k)
        if d is None:
            s[k] = {"count": 1, "total": value, "min": value, "max": value}
        else:
            d["count"] += 1
            d["total"] += value
            d["min"] = min(d["min"], value)
            d["max"] = max(d["max"], value)

    # -- read ----------------------------------------------------------------
    def names(self) -> Iterable[str]:
        return sorted(self._metrics)

    def kind(self, name: str) -> str:
        return self._metrics[name][0]

    def series(self, name: str) -> Dict[LabelKey, Any]:
        """All label→value series of one metric (empty if never written)."""
        got = self._metrics.get(name)
        return dict(got[1]) if got else {}

    def value(self, name: str, default: Any = None, **labels) -> Any:
        got = self._metrics.get(name)
        if got is None:
            return default
        return got[1].get(_labelkey(labels), default)

    def total(self, name: str) -> float:
        """Sum of a counter/gauge over all label sets (0 if absent)."""
        got = self._metrics.get(name)
        if got is None:
            return 0
        if got[0] == "histogram":
            return sum(d["total"] for d in got[1].values())
        return sum(got[1].values())

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in self.names():
            mtype, series = self._metrics[name]
            out[name] = {
                "type": mtype,
                "series": [{"labels": dict(k), "value": v}
                           for k, v in sorted(series.items(),
                                              key=lambda kv: repr(kv[0]))],
            }
        return out


def from_report(report) -> MetricsRegistry:
    """Fold one :class:`~repro_torch.exec.report.ExecutionReport` into the
    unified namespace (see module table)."""
    reg = MetricsRegistry()
    for task, n in report.task_congestion_waits.items():
        reg.counter_add("exec.task.congestion_waits", n, task=task)
    for task, n in report.task_mem_waits.items():
        reg.counter_add("exec.task.mem_waits", n, task=task)
    for task, n in report.starvation_events.items():
        reg.counter_add("exec.task.starvation_events", n, task=task)
    for dev, n in report.device_fired.items():
        reg.counter_add("exec.device.fired", n, device=dev)
    for dev, s in report.device_busy_s.items():
        reg.gauge_set("exec.device.busy_s", s, device=dev)
    for c in report.channels:
        if not c.inter_device:
            continue
        reg.counter_add("exec.channel.tokens", c.tokens, channel=c.index)
        reg.counter_add("exec.channel.bytes", c.measured_bytes,
                        channel=c.index)
        reg.counter_add("exec.channel.net_bytes", c.net_bytes,
                        channel=c.index)
        reg.gauge_set("exec.channel.max_occupancy", c.max_occupancy,
                      channel=c.index)
    if report.used_fabric:
        for l in report.congestion.links:
            reg.counter_add("net.link.goodput_bytes", int(l.bytes),
                            link=l.index)
            reg.counter_add("net.link.flits", l.flits, link=l.index)
            reg.gauge_set("net.link.utilization", l.utilization,
                          link=l.index)
            for fld in ("retransmit_bytes", "retransmit_flits", "drops",
                        "crc_errors", "down_losses", "arq_stalls",
                        "stalled_flits"):
                reg.counter_add(f"net.link.{fld}", getattr(l, fld),
                                link=l.index)
    if report.used_mem:
        for b in report.mem_contention.banks:
            reg.counter_add("mem.bank.bytes", int(b.bytes),
                            device=b.device, bank=b.bank)
            reg.counter_add("mem.bank.bursts", b.bursts,
                            device=b.device, bank=b.bank)
            reg.counter_add("mem.bank.requests", b.requests,
                            device=b.device, bank=b.bank)
            reg.counter_add("mem.bank.saturated_sweeps", b.saturated_sweeps,
                            device=b.device, bank=b.bank)
            reg.gauge_set("mem.bank.utilization", b.utilization,
                          device=b.device, bank=b.bank)
    return reg


def from_trace(tracer) -> MetricsRegistry:
    """Fold a recorded trace into the same namespace (trace-derived
    series get a ``trace.`` prefix to keep provenance explicit)."""
    reg = MetricsRegistry()
    for e in tracer.events:
        kind = e[0]
        if kind == "task_fire":
            reg.counter_add("trace.exec.task.fired", 1, task=e[2])
        elif kind == "task_wait":
            reg.counter_add("trace.exec.task.waits", 1,
                            task=e[2], reason=e[4])
        elif kind == "flit_hop":
            reg.counter_add("trace.net.link.goodput_bytes", e[3], link=e[2])
        elif kind == "flit_reclassify":
            # Route repair moved these crossings goodput -> retransmit;
            # mirror the counter arithmetic on both series.
            reg.counter_add("trace.net.link.goodput_bytes", -e[3],
                            link=e[2])
            reg.counter_add("trace.net.link.retransmit_bytes", e[3],
                            link=e[2])
        elif kind == "retransmit":
            reg.counter_add("trace.net.link.retransmit_bytes", e[3],
                            link=e[2])
        elif kind == "bank_burst":
            reg.counter_add("trace.mem.bank.bytes", e[4], bank=e[2])
    return reg


def _exact(a: float, b: float, what: str) -> None:
    if not math.isclose(float(a), float(b), rel_tol=0.0, abs_tol=0.0):
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def assert_registry_consistent(reg: MetricsRegistry, report) -> None:
    """Exact consistency of the registry view against the legacy report
    fields it subsumes — nothing may drift."""
    _exact(reg.total("exec.task.congestion_waits"),
           sum(report.task_congestion_waits.values()),
           "exec.task.congestion_waits")
    _exact(reg.total("exec.task.mem_waits"),
           sum(report.task_mem_waits.values()), "exec.task.mem_waits")
    _exact(reg.total("exec.device.fired"),
           sum(report.device_fired.values()), "exec.device.fired")
    _exact(reg.total("exec.channel.bytes"), report.measured_inter_bytes,
           "exec.channel.bytes")
    if report.used_fabric:
        _exact(reg.total("net.link.goodput_bytes"),
               report.congestion.total_bytes, "net.link.goodput_bytes")
        _exact(reg.total("net.link.retransmit_bytes"),
               report.net_retransmit_bytes_total,
               "net.link.retransmit_bytes")
        for l in report.congestion.links:
            _exact(reg.value("net.link.goodput_bytes", 0, link=l.index),
                   l.bytes, f"net.link.goodput_bytes[link={l.index}]")
    if report.used_mem:
        _exact(reg.total("mem.bank.bytes"), report.mem_bank_bytes,
               "mem.bank.bytes")


def assert_trace_report_consistent(tracer, report) -> None:
    """Exact agreement of the recorded trace with the report's counters:

    * per-link trace goodput (hop bytes − reclassified bytes) equals the
      report's per-link goodput, byte for byte;
    * per-bank trace bytes equal the report's per-bank bytes;
    * ``task_wait(reason="net")`` / ``(reason="mem")`` event counts equal
      the legacy congestion/mem wait tallies per task;
    * ``task_fire`` counts per device equal ``device_fired``.
    """
    if not getattr(tracer, "enabled", False):
        return
    if report.used_fabric:
        goodput = tracer.link_goodput_bytes()
        for l in report.congestion.links:
            _exact(goodput.get(l.index, 0), l.bytes,
                   f"trace goodput link {l.index}")
        # Counter retransmit bytes = wasted transmissions + route-repair
        # reclassifications, so the trace side sums both event kinds.
        retx = (sum(e[3] for e in tracer.iter_kind("retransmit"))
                + sum(e[3] for e in tracer.iter_kind("flit_reclassify")))
        _exact(retx, report.net_retransmit_bytes_total, "trace retransmit")
    if report.used_mem:
        bank_bytes = tracer.bank_bytes()
        bpd = len(report.mem_contention.banks) // max(
            1, report.num_devices)
        for b in report.mem_contention.banks:
            bid = b.device * bpd + b.bank
            _exact(bank_bytes.get(bid, 0), b.bytes,
                   f"trace bank {bid} bytes")
    waits: Dict[Tuple[str, str], int] = {}
    fired: Dict[int, int] = {}
    for e in tracer.events:
        if e[0] == "task_wait":
            key = (e[2], e[4])
            waits[key] = waits.get(key, 0) + 1
        elif e[0] == "task_fire":
            fired[e[3]] = fired.get(e[3], 0) + 1
    for task, n in report.task_congestion_waits.items():
        _exact(waits.get((task, "net"), 0), n, f"net waits for {task}")
    for task, n in report.task_mem_waits.items():
        _exact(waits.get((task, "mem"), 0), n, f"mem waits for {task}")
    for dev, n in report.device_fired.items():
        _exact(fired.get(dev, 0), n, f"device {dev} fired")


def tenant_metrics(server) -> MetricsRegistry:
    """``tenant.flow.*`` per-tenant series from a finished
    :class:`~repro_torch.tenants.TenantServer` run (also reachable as
    ``server.metrics()``)."""
    reg = MetricsRegistry()
    for rec in getattr(server, "records", []):
        name = rec.name
        reg.gauge_set("tenant.flow.id", rec.flow, tenant=name)
        reg.counter_add("tenant.flow.admissions", 1, tenant=name)
        reg.counter_add("tenant.flow.kills",
                        1 if rec.status == "killed" else 0, tenant=name)
        reg.counter_add("tenant.flow.restores",
                        1 if rec.recovered_via == "restore" else 0,
                        tenant=name)
        reg.counter_add("tenant.flow.recompiles",
                        1 if rec.recovered_via == "recompile" else 0,
                        tenant=name)
        if rec.result is not None:
            rep = rec.result.report
            reg.counter_add("tenant.flow.sweeps", rep.sweeps, tenant=name)
            reg.counter_add("tenant.flow.net_bytes",
                            sum(c.net_bytes for c in rep.channels),
                            tenant=name)
            reg.counter_add("tenant.flow.mem_bytes",
                            sum(m.delivered_bytes for m in rep.mem_channels),
                            tenant=name)
            reg.counter_add("tenant.flow.congestion_waits",
                            sum(rep.task_congestion_waits.values()),
                            tenant=name)
            reg.counter_add("tenant.flow.mem_waits",
                            sum(rep.task_mem_waits.values()), tenant=name)
    return reg
