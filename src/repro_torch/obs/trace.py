"""Sweep-granular tracing — typed events from every runtime layer.

A :class:`Tracer` records what each layer *did* at each executor sweep:
task firings and waits (``repro_torch.exec``), channel pushes/pops,
flit-hop crossings, ARQ retransmits/backoffs, link deaths and route
repairs (``repro_torch.net``), bank bursts and memory-request issues
(``repro_torch.mem``), tenant admissions/cancellations
(``repro_torch.tenants``), and checkpoint barriers
(``repro_torch.exec.snapshot``).  Events are plain tuples
``(kind, sweep, *fields)`` — field order per kind in :data:`EVENT_FIELDS`
— appended to ``Tracer.events``; nothing else is touched, so a traced run
is bit-identical to an untraced one by construction (the tests assert it
anyway).

The default is :data:`NULL_TRACER`, a :class:`NullTracer` whose ``enabled``
flag is False and whose emit methods are no-ops: instrumented hot paths
guard with ``if tracer.enabled:`` so the untraced path allocates nothing
and stays measurably unchanged (the JAX package's ``benchmarks/perf.py``
asserts the overhead bound).

Byte accounting mirrors the counters exactly: per link,
``Σ flit_hop bytes − Σ flit_reclassify bytes == LinkCounters.bytes``
(goodput — reclassify events are route repair moving crossings from the
goodput bucket to retransmit), and per bank
``Σ bank_burst bytes == BankCounters.bytes``.  ``repro_torch.obs.metrics``
asserts these identities; the hypothesis conservation properties fuzz them.

:func:`to_chrome_trace` exports the Chrome/Perfetto trace-event JSON —
one *pid* per device, one *tid* per task/link/bank — so any run opens in
``chrome://tracing`` (or https://ui.perfetto.dev).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

#: Field order of each event kind, *after* the leading ``(kind, sweep)``.
#: ``task_wait`` reasons: ``net`` (the legacy congestion_waits tally —
#: input empty, sibling FIFO full, tokens in flight), ``transit`` (input
#: empty, tokens in the fabric, no sibling at capacity), ``mem`` (the
#: legacy mem_waits tally), ``starve`` (§4.6 starvation event),
#: ``upstream`` (input empty, nothing in flight — a dataflow dependency),
#: ``backpressure`` (inputs ready but an output FIFO is full).
EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "task_fire": ("task", "device", "busy_s", "flow"),
    "task_wait": ("task", "device", "reason", "flow"),
    "channel_push": ("channel", "src", "dst", "nbytes", "flow"),
    "channel_pop": ("channel", "src", "dst", "flow"),
    "flit_hop": ("link", "nbytes", "flow", "mid"),
    "flit_reclassify": ("link", "nbytes", "flow", "mid"),
    "retransmit": ("link", "nbytes", "flow", "outcome"),
    "arq_backoff": ("link", "delay", "flow", "mid"),
    "link_death": ("link",),
    "reroute": ("mid", "flow", "hops"),
    "bank_burst": ("bank", "device", "nbytes", "flow", "channel"),
    "mem_issue": ("channel", "task", "device", "bank", "nbytes", "flow"),
    "tenant_admit": ("flow", "name"),
    "tenant_cancel": ("flow", "name", "reason"),
    "barrier": ("label", "flow"),
    # Online SLO monitoring (repro_torch.obs.slo): a windowed metric crossed
    # its tenant's declared threshold mid-run.  ``metric`` is one of
    # ``p99_latency_s`` / ``p50_latency_s`` / ``burn_rate``; ``value`` the
    # observed window value, ``threshold`` what the SLO allows.
    "slo_alert": ("flow", "name", "metric", "value", "threshold"),
}

#: Sweeps with any of these kinds are ARQ/fault-recovery activity — the
#: critical-path pass reclassifies network waits that overlap them.
FAULT_KINDS = ("retransmit", "arq_backoff", "flit_reclassify",
               "link_death", "reroute")


class Tracer:
    """A recording tracer: every emit appends one tuple to ``events``.

    One tracer may be shared across layers and (in tenant mode) across
    execution states — events carry their flow id, so per-tenant views
    are a filter, not a copy.  ``note_link`` registers link endpoints for
    the Chrome exporter's pid mapping (links render under their source
    device's process row).
    """

    enabled = True

    def __init__(self) -> None:
        self.events: List[tuple] = []
        self.link_devs: Dict[int, Tuple[int, int]] = {}  # link -> (src, dst)

    # -- topology notes (exporter metadata, not events) ----------------------
    def note_link(self, link: int, src_dev: int, dst_dev: int) -> None:
        self.link_devs[int(link)] = (int(src_dev), int(dst_dev))

    # -- exec ----------------------------------------------------------------
    def task_fire(self, sweep: int, task: str, device: int,
                  busy_s: float, flow: int = 0) -> None:
        self.events.append(("task_fire", sweep, task, device, busy_s, flow))

    def task_wait(self, sweep: int, task: str, device: int,
                  reason: str, flow: int = 0) -> None:
        self.events.append(("task_wait", sweep, task, device, reason, flow))

    def channel_push(self, sweep: int, channel: int, src: str, dst: str,
                     nbytes: int, flow: int = 0) -> None:
        self.events.append(("channel_push", sweep, channel, src, dst,
                            nbytes, flow))

    def channel_pop(self, sweep: int, channel: int, src: str, dst: str,
                    flow: int = 0) -> None:
        self.events.append(("channel_pop", sweep, channel, src, dst, flow))

    # -- net -----------------------------------------------------------------
    def flit_hop(self, sweep: int, link: int, nbytes: int, flow: int,
                 mid: int) -> None:
        self.events.append(("flit_hop", sweep, link, nbytes, flow, mid))

    def flit_reclassify(self, sweep: int, link: int, nbytes: int, flow: int,
                        mid: int) -> None:
        self.events.append(("flit_reclassify", sweep, link, nbytes, flow,
                            mid))

    def retransmit(self, sweep: int, link: int, nbytes: int, flow: int,
                   outcome: str) -> None:
        self.events.append(("retransmit", sweep, link, nbytes, flow,
                            outcome))

    def arq_backoff(self, sweep: int, link: int, delay: int, flow: int,
                    mid: int) -> None:
        self.events.append(("arq_backoff", sweep, link, delay, flow, mid))

    def link_death(self, sweep: int, link: int) -> None:
        self.events.append(("link_death", sweep, link))

    def reroute(self, sweep: int, mid: int, flow: int, hops: int) -> None:
        self.events.append(("reroute", sweep, mid, flow, hops))

    # -- mem -----------------------------------------------------------------
    def bank_burst(self, sweep: int, bank: int, device: int, nbytes: int,
                   flow: int, channel: int) -> None:
        self.events.append(("bank_burst", sweep, bank, device, nbytes, flow,
                            channel))

    def mem_issue(self, sweep: int, channel: int, task: str, device: int,
                  bank: int, nbytes: int, flow: int = 0) -> None:
        self.events.append(("mem_issue", sweep, channel, task, device, bank,
                            nbytes, flow))

    # -- tenants / checkpoints -----------------------------------------------
    def tenant_admit(self, sweep: int, flow: int, name: str) -> None:
        self.events.append(("tenant_admit", sweep, flow, name))

    def tenant_cancel(self, sweep: int, flow: int, name: str,
                      reason: str) -> None:
        self.events.append(("tenant_cancel", sweep, flow, name, reason))

    def barrier(self, sweep: int, label: str, flow: int = 0) -> None:
        self.events.append(("barrier", sweep, label, flow))

    # -- obs (the monitor writes into the same trace it reads) ---------------
    def slo_alert(self, sweep: int, flow: int, name: str, metric: str,
                  value: float, threshold: float) -> None:
        self.events.append(("slo_alert", sweep, flow, name, metric,
                            value, threshold))

    # -- queries -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def iter_kind(self, kind: str):
        """Events of one kind, in record order (each a full tuple)."""
        return (e for e in self.events if e[0] == kind)

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e[0] == kind)

    def as_dicts(self) -> List[Dict[str, Any]]:
        """Schema-expanded events (JSON-ready; test/debug convenience)."""
        out = []
        for e in self.events:
            d: Dict[str, Any] = {"kind": e[0], "sweep": e[1]}
            d.update(zip(EVENT_FIELDS[e[0]], e[2:]))
            out.append(d)
        return out

    # -- streaming JSONL export (module functions do the work) ---------------
    def to_jsonl(self) -> str:
        return to_jsonl(self)

    def write_jsonl(self, path: str) -> int:
        return write_jsonl(self, path)

    # -- byte summaries (the trace side of the conservation identities) ------
    def link_goodput_bytes(self) -> Dict[int, int]:
        """Per-link goodput from the trace: hop bytes minus the crossings
        route repair reclassified — must equal ``LinkCounters.bytes``."""
        out: Dict[int, int] = {}
        for e in self.events:
            if e[0] == "flit_hop":
                out[e[2]] = out.get(e[2], 0) + e[3]
            elif e[0] == "flit_reclassify":
                out[e[2]] = out.get(e[2], 0) - e[3]
        return out

    def bank_bytes(self) -> Dict[int, int]:
        """Per-bank served bytes — must equal ``BankCounters.bytes``."""
        out: Dict[int, int] = {}
        for e in self.events:
            if e[0] == "bank_burst":
                out[e[2]] = out.get(e[2], 0) + e[4]
        return out


class NullTracer:
    """The disabled tracer: every emit is a no-op, ``enabled`` is False.

    Hot paths guard event-argument construction with ``if tracer.enabled:``
    so the ``trace=None`` path performs zero allocations; cold call sites
    may call the no-op methods directly.
    """

    enabled = False
    events: Tuple[()] = ()
    link_devs: Dict[int, Tuple[int, int]] = {}

    def _noop(self, *args, **kw) -> None:
        return None

    note_link = task_fire = task_wait = channel_push = channel_pop = _noop
    flit_hop = flit_reclassify = retransmit = arq_backoff = _noop
    link_death = reroute = bank_burst = mem_issue = _noop
    tenant_admit = tenant_cancel = barrier = slo_alert = _noop

    def __len__(self) -> int:
        return 0

    def iter_kind(self, kind: str):
        return iter(())

    def count(self, kind: str) -> int:
        return 0

    def as_dicts(self) -> List[Dict[str, Any]]:
        return []

    def link_goodput_bytes(self) -> Dict[int, int]:
        return {}

    def bank_bytes(self) -> Dict[int, int]:
        return {}


#: The shared disabled tracer — the default everywhere ``tracer=`` threads.
NULL_TRACER = NullTracer()


def coerce_tracer(tracer: Optional[Any]) -> Any:
    """``None`` → :data:`NULL_TRACER`; anything else passes through."""
    return NULL_TRACER if tracer is None else tracer


# -- Chrome/Perfetto export ---------------------------------------------------

_INSTANT_KINDS = {
    "channel_push": ("net", "push"),
    "channel_pop": ("net", "pop"),
    "retransmit": ("fault", "retransmit"),
    "arq_backoff": ("fault", "backoff"),
    "link_death": ("fault", "link death"),
    "reroute": ("fault", "reroute"),
    "mem_issue": ("mem", "issue"),
    "flit_reclassify": ("fault", "reclassify"),
}


class _Tids:
    """Integer tid allocator + thread_name metadata, one tid per
    (pid, label) — the classic chrome://tracing contract (string tids are
    a Perfetto extension; ints render everywhere)."""

    def __init__(self, events: List[dict]):
        self._by_key: Dict[Tuple[int, str], int] = {}
        self._events = events
        self._pids_named: set = set()

    def pid(self, device: int) -> int:
        pid = int(device) if device >= 0 else 999
        if pid not in self._pids_named:
            self._pids_named.add(pid)
            name = f"device {pid}" if device >= 0 else "global"
            self._events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": name}})
        return pid

    def tid(self, device: int, label: str) -> Tuple[int, int]:
        pid = self.pid(device)
        key = (pid, label)
        if key not in self._by_key:
            tid = len(self._by_key) + 1
            self._by_key[key] = tid
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": label}})
        return pid, self._by_key[key]


def to_chrome_trace(tracer: Tracer, *,
                    sweep_time_us: float = 1.0) -> Dict[str, Any]:
    """Export a recorded trace as Chrome trace-event JSON.

    One pid per device (plus a ``global`` pseudo-process for tenant and
    barrier events), one tid per task/link/bank.  ``ts`` is the sweep
    index scaled by ``sweep_time_us`` (default: 1 sweep = 1 µs — the
    :class:`~repro_torch.net.transport.NetConfig` default time base).  Open the
    written JSON in ``chrome://tracing`` or https://ui.perfetto.dev.
    """
    events: List[dict] = []
    tids = _Tids(events)
    u = float(sweep_time_us)

    def ts(sweep: int) -> float:
        return sweep * u

    for e in tracer.events:
        kind, sweep = e[0], e[1]
        if kind == "task_fire":
            task, device, busy_s, flow = e[2:]
            pid, tid = tids.tid(device, f"task:{task}")
            events.append({
                "ph": "X", "name": task, "cat": "exec", "pid": pid,
                "tid": tid, "ts": ts(sweep), "dur": u,
                "args": {"busy_s": busy_s, "flow": flow}})
        elif kind == "task_wait":
            task, device, reason, flow = e[2:]
            pid, tid = tids.tid(device, f"task:{task}")
            events.append({
                "ph": "X", "name": f"wait:{reason}", "cat": "exec",
                "pid": pid, "tid": tid, "ts": ts(sweep), "dur": u,
                "args": {"flow": flow}})
        elif kind == "flit_hop":
            link, nbytes, flow, mid = e[2:]
            src = tracer.link_devs.get(link, (0, 0))[0]
            pid, tid = tids.tid(src, f"link:{link}")
            events.append({
                "ph": "X", "name": "flit", "cat": "net", "pid": pid,
                "tid": tid, "ts": ts(sweep), "dur": u,
                "args": {"bytes": nbytes, "flow": flow, "mid": mid}})
        elif kind == "bank_burst":
            bank, device, nbytes, flow, channel = e[2:]
            pid, tid = tids.tid(device, f"bank:{bank}")
            events.append({
                "ph": "X", "name": "burst", "cat": "mem", "pid": pid,
                "tid": tid, "ts": ts(sweep), "dur": u,
                "args": {"bytes": nbytes, "flow": flow,
                         "channel": channel}})
        elif kind in ("tenant_admit", "tenant_cancel"):
            flow, name = e[2], e[3]
            pid, tid = tids.tid(-1, f"tenant:{name}")
            events.append({
                "ph": "i", "name": kind, "cat": "tenant", "pid": pid,
                "tid": tid, "ts": ts(sweep), "s": "p",
                "args": {"flow": flow} if kind == "tenant_admit"
                else {"flow": flow, "reason": e[4]}})
        elif kind == "barrier":
            label, flow = e[2:]
            pid, tid = tids.tid(-1, "checkpoint")
            events.append({
                "ph": "i", "name": f"barrier:{label}", "cat": "ckpt",
                "pid": pid, "tid": tid, "ts": ts(sweep), "s": "g",
                "args": {"flow": flow}})
        elif kind == "slo_alert":
            flow, name, metric, value, threshold = e[2:]
            pid, tid = tids.tid(-1, f"tenant:{name}")
            events.append({
                "ph": "i", "name": f"slo:{metric}", "cat": "slo",
                "pid": pid, "tid": tid, "ts": ts(sweep), "s": "p",
                "args": {"flow": flow, "value": value,
                         "threshold": threshold}})
        elif kind in _INSTANT_KINDS:
            cat, name = _INSTANT_KINDS[kind]
            fields = dict(zip(EVENT_FIELDS[kind], e[2:]))
            link = fields.get("link")
            if link is not None:
                src = tracer.link_devs.get(link, (0, 0))[0]
                pid, tid = tids.tid(src, f"link:{link}")
            elif kind == "mem_issue":
                pid, tid = tids.tid(fields["device"],
                                    f"task:{fields['task']}")
            elif kind == "reroute":   # no link: the old route is gone
                pid, tid = tids.tid(-1, "reroute")
            else:  # channel push/pop ride the channel's own row
                pid, tid = tids.tid(-1, f"chan:{fields['channel']}")
            events.append({
                "ph": "i", "name": name, "cat": cat, "pid": pid,
                "tid": tid, "ts": ts(sweep), "s": "t", "args": fields})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"format": "repro-obs/v1",
                          "sweep_time_us": u,
                          "source_events": len(tracer.events)}}


def validate_chrome_trace(doc: Dict[str, Any]) -> None:
    """Structural validity of a Chrome trace document (raises on defect):
    a JSON-serializable ``traceEvents`` list whose every event carries
    ``ph``/``name``/``pid``/``tid``, with ``ts`` (and ``dur`` for complete
    events) on every non-metadata event."""
    assert isinstance(doc.get("traceEvents"), list), "traceEvents missing"
    json.dumps(doc)   # must round-trip
    for ev in doc["traceEvents"]:
        for key in ("ph", "name", "pid", "tid"):
            assert key in ev, f"event missing {key!r}: {ev}"
        if ev["ph"] == "M":
            continue
        assert "ts" in ev, f"event missing ts: {ev}"
        if ev["ph"] == "X":
            assert "dur" in ev, f"complete event missing dur: {ev}"


def write_chrome_trace(tracer: Tracer, path: str, *,
                       sweep_time_us: float = 1.0) -> Dict[str, Any]:
    """Export + validate + write the Chrome trace JSON to ``path``."""
    import os
    doc = to_chrome_trace(tracer, sweep_time_us=sweep_time_us)
    validate_chrome_trace(doc)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# -- streaming JSONL export ---------------------------------------------------
#
# The Chrome exporter materializes a *second* full event list (one dict of
# ~8 expanded fields per tuple) plus its serialized JSON before anything
# reaches disk — roughly tripling peak memory for long serving runs.  The
# JSONL path streams instead: events are encoded and written ONE LINE AT A
# TIME, so beyond the tracer's own tuple list the peak extra memory is a
# single encoded line (O(1) in the trace length, ~100–200 bytes).  A run
# that records for hours can export continuously without ever holding a
# second copy of its history.

JSONL_FORMAT = "repro-obs-jsonl/v1"


def iter_jsonl(tracer: Tracer):
    """Yield the trace as JSONL lines (no trailing newlines): a header
    line carrying the format tag and the link-endpoint metadata, then one
    schema-expanded event per line in record order."""
    yield json.dumps({"format": JSONL_FORMAT,
                      "link_devs": {str(k): list(v) for k, v in
                                    tracer.link_devs.items()},
                      "events": len(tracer.events)})
    for e in tracer.events:
        d: Dict[str, Any] = {"kind": e[0], "sweep": e[1]}
        d.update(zip(EVENT_FIELDS[e[0]], e[2:]))
        yield json.dumps(d)


def to_jsonl(tracer: Tracer) -> str:
    """The whole trace as one JSONL string (small traces / tests — long
    runs should stream with :func:`write_jsonl` instead)."""
    return "\n".join(iter_jsonl(tracer)) + "\n"


def write_jsonl(tracer: Tracer, path: str) -> int:
    """Stream the trace to ``path`` as JSONL; returns the event count.

    Memory bound: one encoded line at a time — never a second full copy
    of the event list (see the section comment above).
    """
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w") as f:
        for line in iter_jsonl(tracer):
            f.write(line)
            f.write("\n")
            n += 1
    return n - 1   # header line is not an event


def read_jsonl(path: str) -> Tracer:
    """Rehydrate a :class:`Tracer` from a :func:`write_jsonl` file — the
    round-trip is exact (tuple-for-tuple), so Chrome export and every
    byte-summary query work identically on the reloaded trace."""
    t = Tracer()
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("format") != JSONL_FORMAT:
            raise ValueError(f"not a {JSONL_FORMAT} file: {path}")
        t.link_devs = {int(k): (int(v[0]), int(v[1]))
                       for k, v in header.get("link_devs", {}).items()}
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            kind = d["kind"]
            t.events.append(tuple([kind, d["sweep"]]
                                  + [d[fld] for fld in EVENT_FIELDS[kind]]))
    return t
