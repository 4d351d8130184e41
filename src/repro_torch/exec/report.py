"""`ExecutionReport` — measured execution vs the analytic model.

The compiler *predicts*: the partition charges Eq. 2 comm cost on its cut
channels, the graph models per-step channel volumes (``bytes_per_step``),
and the schedule pass simulates makespan/busy time.  The executor
*measures*: actual bytes crossing each inter-device channel, FIFO occupancy
high-water marks, and per-device busy wall time.  This module folds both
sides into one JSON-ready record so ``benchmarks/perf.py`` can emit a
measured-vs-predicted section into ``BENCH_compile.json``.

The two hard agreement checks (:meth:`ExecutionReport.agreement`):

* ``cut_set_match`` — the channels that actually moved inter-device bytes
  are exactly the partition's ``cut_channels``.
* ``comm_cost_match`` — Eq. 2 re-evaluated over the *measured* cut set
  (width × dist × λ, same arithmetic as the partitioner) reproduces
  ``partition.comm_cost`` bit for bit.  Together they certify that the
  traffic the executor moved is the traffic the solver paid for.

With a network fabric (``repro.net``), two more:

* ``net_delivery_match`` — every byte a channel submitted to the fabric
  was delivered (the network drained clean);
* ``link_conservation`` — per-link byte totals sum exactly to the
  hop-weighted cut-set traffic (Σ_link bytes == Σ_channel bytes × hops):
  the flit accounting loses and invents nothing.

The ``net`` block of :meth:`summary` carries the per-link
:class:`~repro.net.congestion.CongestionReport` (utilization, queue highs,
stalls) next to those identities.

With an HBM bank model (``repro_torch.mem``), two more:

* ``mem_delivery_match`` — every memory stream issued exactly its firing
  count of requests and consumed every response (requested bytes ==
  delivered bytes per channel);
* ``bank_conservation`` — per-bank served bytes sum exactly to the
  memory-channel delivered bytes (Σ_bank bytes == Σ_channel bytes; no hop
  multiplier — each request is served by exactly one bank).

The ``mem`` block carries the measured per-bank
:class:`~repro_torch.mem.contention.MemContentionReport` next to those.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence

from .channels import FifoChannel


def _deprecated_field(old: str, new: str):
    """One-release shim: ``report.<old>`` warns and forwards to
    ``report.<new>`` (the PR 2 pass-registry migration style — read the
    canonical field, or better, the ``report.metrics`` registry view)."""

    def get(self):
        warnings.warn(
            f"ExecutionReport.{old} is deprecated; read "
            f"ExecutionReport.{new} (or the report.metrics registry view) "
            f"instead", DeprecationWarning, stacklevel=2)
        return getattr(self, new)

    get.__name__ = old
    get.__doc__ = f"Deprecated alias for :attr:`{new}`."
    return property(get)


@dataclasses.dataclass(frozen=True)
class ChannelTrace:
    """One channel's measured life, next to its modeled accounting."""

    index: int
    src: str
    dst: str
    src_dev: int
    dst_dev: int
    inter_device: bool
    eager_transfer: bool           # depth >= 2 double buffering (§4.6)
    depth: int
    latency: int
    tokens: int
    max_occupancy: int
    measured_bytes: int            # actual payload moved across devices
    modeled_bytes: float           # graph bytes_per_step × tokens
    width_bits: int
    # Network-fabric accounting (0 on the ideal fabric=None path).
    net_bytes: int = 0             # bytes submitted to the fabric
    net_delivered_bytes: int = 0   # bytes whose message fully delivered
    route_hops: int = 0            # fabric route length of this crossing

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class MemChannelTrace:
    """One async memory stream's measured life (``repro.mem``)."""

    task: str
    stream: str
    device: int
    bank: int
    count: int                     # firings = responses the task must consume
    issued: int
    consumed: int
    requested_bytes: int
    delivered_bytes: int
    blocked_issues: int            # pump stalls on exhausted credits
    max_outstanding: int
    response_waits: int

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ExecutionReport:
    """Measured execution record for one ``execute()`` run."""

    graph_name: str
    num_devices: int
    iterations: int
    sweeps: int
    wall_time_s: float
    channels: List[ChannelTrace]
    device_busy_s: Dict[int, float]
    device_fired: Dict[int, int]
    starvation_events: Dict[str, int]
    starvation_detail: List[Dict[str, Any]]
    # Analytic counterparts (from the CompiledDesign).
    analytic_comm_cost: float                  # partition.comm_cost (Eq. 2)
    measured_cut_comm_cost: float              # Eq. 2 over the measured cut
    measured_comm_cost: float                  # Eq. 2 w/ measured bits/firing
    analytic_cut_channels: int
    schedule_makespan_s: Optional[float]
    schedule_comm_bytes: Optional[float]       # Σ cut bytes_per_step (model)
    # Network fabric (None on the ideal path).
    congestion: Optional[Any] = None           # net.CongestionReport
    task_congestion_waits: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    measured_route_comm_cost: float = 0.0      # per-link Eq. 2 over the cut
    # Fault-mode accounting (repro.chaos; None when faults were off).
    # Under route repair a message may deliver over a different route than
    # it was submitted on, so the conservation right-hand side is the
    # transport's delivered-bytes × hops-at-delivery tally, not the static
    # per-channel route length.
    net_goodput_hop_bytes: Optional[int] = None
    net_retransmit_bytes_total: int = 0
    # HBM bank model (None/empty on the ideal memory path).
    mem_contention: Optional[Any] = None       # mem.MemContentionReport
    mem_channels: List[MemChannelTrace] = dataclasses.field(
        default_factory=list)
    task_mem_waits: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Host seconds the executor spent in the bank model (pumping requests
    # and serving bursts); 0.0 on the ideal memory path.
    mem_model_s: float = 0.0
    # Observability (repro.obs): the recorded trace, when one was attached.
    trace: Optional[Any] = None                # obs.Tracer (None if untraced)

    # One-release deprecation shims for the pre-registry counter names.
    congestion_waits = _deprecated_field(
        "congestion_waits", "task_congestion_waits")
    mem_waits = _deprecated_field("mem_waits", "task_mem_waits")
    net_retransmit_bytes = _deprecated_field(
        "net_retransmit_bytes", "net_retransmit_bytes_total")

    @functools.cached_property
    def metrics(self):
        """The unified ``layer.object.metric`` registry view of this
        report (:func:`repro.obs.metrics.from_report`) — the canonical
        way to read counters (``net.link.*``, ``mem.bank.*``,
        ``exec.task.*``)."""
        raise NotImplementedError(
            "ExecutionReport.metrics needs repro_torch.obs.metrics, which is "
            "not yet ported")

    # -- aggregates ---------------------------------------------------------
    @property
    def measured_inter_bytes(self) -> int:
        return sum(c.measured_bytes for c in self.channels if c.inter_device)

    @property
    def modeled_inter_bytes(self) -> float:
        return sum(c.modeled_bytes for c in self.channels if c.inter_device)

    @property
    def measured_cut_channels(self) -> int:
        return sum(1 for c in self.channels
                   if c.inter_device and c.measured_bytes > 0)

    @property
    def used_fabric(self) -> bool:
        return self.congestion is not None

    @property
    def used_mem(self) -> bool:
        return self.mem_contention is not None

    @property
    def mem_requested_bytes(self) -> int:
        return sum(c.requested_bytes for c in self.mem_channels)

    @property
    def mem_delivered_bytes(self) -> int:
        return sum(c.delivered_bytes for c in self.mem_channels)

    @property
    def mem_bank_bytes(self) -> float:
        return (self.mem_contention.total_bytes
                if self.mem_contention is not None else 0.0)

    @property
    def net_submitted_bytes(self) -> int:
        return sum(c.net_bytes for c in self.channels)

    @property
    def net_hop_weighted_bytes(self) -> int:
        """Σ channel bytes × route hops — what the links must have carried."""
        return sum(c.net_bytes * c.route_hops for c in self.channels)

    @property
    def net_link_bytes(self) -> float:
        return (self.congestion.total_bytes
                if self.congestion is not None else 0.0)

    def device_busy_frac(self) -> Dict[int, float]:
        if self.wall_time_s <= 0:
            return {d: 0.0 for d in self.device_busy_s}
        return {d: b / self.wall_time_s
                for d, b in sorted(self.device_busy_s.items())}

    def agreement(self) -> Dict[str, bool]:
        """The measured-vs-predicted accounting checks (see module doc)."""
        out = {
            "cut_set_match": (self.measured_cut_channels
                              == self.analytic_cut_channels),
            "comm_cost_match": math.isclose(
                self.measured_cut_comm_cost, self.analytic_comm_cost,
                rel_tol=1e-9, abs_tol=1e-9),
        }
        if self.used_fabric:
            out["net_delivery_match"] = all(
                c.net_bytes == c.net_delivered_bytes for c in self.channels)
            # Under faults the identity is goodput-based (see field doc) —
            # still exact; without faults the two sides are the same number.
            rhs = (self.net_goodput_hop_bytes
                   if self.net_goodput_hop_bytes is not None
                   else self.net_hop_weighted_bytes)
            out["link_conservation"] = math.isclose(
                self.net_link_bytes, float(rhs), rel_tol=0.0, abs_tol=0.0)
        if self.mem_channels:
            out["mem_delivery_match"] = all(
                c.issued == c.consumed == c.count
                and c.requested_bytes == c.delivered_bytes
                for c in self.mem_channels)
        if self.used_mem:
            # Exact integer identity: each request is served by one bank.
            out["bank_conservation"] = (
                int(self.mem_bank_bytes) == self.mem_delivered_bytes)
        return out

    # -- reporting ----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """JSON digest, shaped like ``CompiledDesign.summary()`` sections."""
        inter = [c for c in self.channels if c.inter_device]
        out = {
            "graph": self.graph_name,
            "num_devices": self.num_devices,
            "iterations": self.iterations,
            "sweeps": self.sweeps,
            "wall_time_s": round(self.wall_time_s, 4),
            "device_busy_s": {str(d): round(b, 4)
                              for d, b in sorted(self.device_busy_s.items())},
            "device_fired": {str(d): n
                             for d, n in sorted(self.device_fired.items())},
            "starvation_events": dict(self.starvation_events),
            "comm": {
                "measured_inter_bytes": self.measured_inter_bytes,
                "modeled_inter_bytes": self.modeled_inter_bytes,
                "measured_cut_channels": self.measured_cut_channels,
                "analytic_cut_channels": self.analytic_cut_channels,
                "analytic_comm_cost": self.analytic_comm_cost,
                "measured_cut_comm_cost": self.measured_cut_comm_cost,
                "measured_comm_cost": self.measured_comm_cost,
                **self.agreement(),
            },
            "schedule": {
                "analytic_makespan_s": self.schedule_makespan_s,
                "analytic_comm_bytes": self.schedule_comm_bytes,
                "measured_wall_s": round(self.wall_time_s, 4),
            },
            "channels": [c.to_json() for c in inter],
        }
        if self.used_fabric:
            out["net"] = {
                "submitted_bytes": self.net_submitted_bytes,
                "hop_weighted_bytes": self.net_hop_weighted_bytes,
                "link_bytes": self.net_link_bytes,
                "route_comm_cost": self.measured_route_comm_cost,
                "congestion_waits": dict(self.task_congestion_waits),
                **self.congestion.summary(),
            }
            if self.net_goodput_hop_bytes is not None:
                out["net"]["goodput_hop_bytes"] = self.net_goodput_hop_bytes
                out["net"]["retransmit_bytes"] = \
                    self.net_retransmit_bytes_total
        if self.mem_channels or self.used_mem:
            out["mem"] = {
                "requested_bytes": self.mem_requested_bytes,
                "delivered_bytes": self.mem_delivered_bytes,
                "bank_bytes": self.mem_bank_bytes,
                "mem_waits": dict(self.task_mem_waits),
                "channels": [c.to_json() for c in self.mem_channels],
                **(self.mem_contention.summary() if self.used_mem else {}),
            }
        return out


def build_report(*, design, channels: Sequence[FifoChannel],
                 iterations: int, sweeps: int, wall_time_s: float,
                 device_busy_s: Mapping[int, float],
                 device_fired: Mapping[int, int],
                 starvation_events: Mapping[str, int],
                 starvation_detail: Sequence[Dict[str, Any]],
                 transport=None,
                 congestion_waits: Optional[Mapping[str, int]] = None,
                 memsys=None,
                 mem_channels: Sequence[Any] = (),
                 mem_waits: Optional[Mapping[str, int]] = None,
                 mem_model_s: float = 0.0,
                 tracer=None
                 ) -> ExecutionReport:
    """Assemble the report from live channels + the design's analytics."""
    part, cluster = design.partition, design.cluster
    fabric = transport.fabric if transport is not None else None
    traces: List[ChannelTrace] = []
    measured_cut_cost = 0.0
    measured_cost = 0.0
    route_cost = 0.0
    for fc in channels:
        gch = fc.graph_channel
        # Routing happens between *fabric* device ids (== logical ids
        # except under a tenant device map); a crossing the map collapsed
        # onto one fabric device never entered the network.
        routed = (fabric is not None and fc.inter_device
                  and fc.net_src_dev != fc.net_dst_dev)
        hops = len(fabric.route(fc.net_src_dev, fc.net_dst_dev)) \
            if routed else 0
        traces.append(ChannelTrace(
            index=fc.index, src=fc.src, dst=fc.dst,
            src_dev=fc.src_dev, dst_dev=fc.dst_dev,
            inter_device=fc.inter_device,
            eager_transfer=fc.eager_transfer,
            depth=fc.capacity, latency=fc.latency,
            tokens=fc.stats.tokens,
            max_occupancy=fc.stats.max_occupancy,
            measured_bytes=fc.stats.measured_bytes,
            modeled_bytes=float(gch.bytes_per_step or gch.width_bits / 8.0)
            * fc.stats.tokens,
            width_bits=gch.width_bits,
            net_bytes=fc.stats.net_bytes,
            net_delivered_bytes=fc.stats.net_delivered_bytes,
            route_hops=hops))
        if fc.inter_device and fc.stats.measured_bytes > 0:
            # Eq. 2 with the channel's declared width — must reproduce the
            # partitioner's objective — and with the measured payload.
            measured_cut_cost += cluster.comm_cost(
                fc.src_dev, fc.dst_dev, gch.width_bits)
            measured_cost += cluster.comm_cost(
                fc.src_dev, fc.dst_dev,
                8.0 * fc.stats.measured_bytes / max(1, fc.stats.tokens))
            if routed:
                # Eq. 2 re-evaluated per routed link (§4.3 calibration).
                route_cost += fabric.route_cost(
                    fc.net_src_dev, fc.net_dst_dev, gch.width_bits)
    # The fabric measurement (net.congestion) is not yet ported; the
    # executor refuses a fabric before it gets here.
    if transport is not None:
        raise NotImplementedError(
            "a fabric transport needs repro_torch.net.congestion, which is "
            "not yet ported")
    congestion = goodput_hop = None
    retransmit = 0
    mem_contention = None
    if memsys is not None:
        from ..mem.contention import measure as _mem_measure
        mem_contention = _mem_measure(memsys)
    mem_traces = [MemChannelTrace(
        task=mc.task, stream=mc.stream, device=mc.device, bank=mc.bank,
        count=mc.count, issued=mc.stats.issued, consumed=mc.stats.consumed,
        requested_bytes=mc.stats.requested_bytes,
        delivered_bytes=mc.stats.delivered_bytes,
        blocked_issues=mc.stats.blocked_issues,
        max_outstanding=mc.stats.max_outstanding,
        response_waits=mc.stats.response_waits)
        for mc in mem_channels]
    sched = design.schedule
    return ExecutionReport(
        graph_name=design.graph.name,
        num_devices=part.num_devices(),
        iterations=iterations,
        sweeps=sweeps,
        wall_time_s=wall_time_s,
        channels=traces,
        device_busy_s=dict(device_busy_s),
        device_fired=dict(device_fired),
        starvation_events=dict(starvation_events),
        starvation_detail=list(starvation_detail),
        analytic_comm_cost=part.comm_cost,
        measured_cut_comm_cost=measured_cut_cost,
        measured_comm_cost=measured_cost,
        analytic_cut_channels=len(part.cut_channels),
        schedule_makespan_s=sched.makespan if sched is not None else None,
        schedule_comm_bytes=sched.comm_bytes if sched is not None else None,
        congestion=congestion,
        task_congestion_waits=dict(congestion_waits or {}),
        measured_route_comm_cost=route_cost,
        net_goodput_hop_bytes=goodput_hop,
        net_retransmit_bytes_total=retransmit,
        mem_contention=mem_contention,
        mem_channels=mem_traces,
        task_mem_waits=dict(mem_waits or {}),
        mem_model_s=mem_model_s,
        trace=tracer if getattr(tracer, "enabled", False) else None)
