"""Per-link utilization / queue tracking and the :class:`CongestionReport`.

Two producers, one record:

* :func:`measure` folds a live :class:`~repro_torch.net.transport.FabricTransport`
  into per-link measured usage after an execution (bytes, flits, busy
  sweeps, stalls, queue high-water marks, achieved utilization);
* :func:`project` evaluates the same per-link shape **analytically** from a
  partition assignment — each cut channel's per-step payload is routed over
  the fabric and accumulated onto every link of its route, utilization
  being demanded bytes per step over the link's service per step
  (``bandwidth × step_time``, the transport's sweep time base).  Note the
  two numbers answer different questions: projected utilization is
  **offered load** (how much the cut set *asks* of a link per step — can
  exceed 1, by the factor the link would slow the pipeline), while the
  measured figure is **achieved throughput** (flits moved over flit-slots
  offered, ≤ 1 by construction).  Rank links by either; compare
  magnitudes across the two only with that in mind.  The projection is
  what the ``congestion_feedback`` compiler pass consumes: it needs a
  congestion estimate *before* anything executes.

``hotspots(threshold)`` names the links the §4.3 congestion-control claim
is about — the ones a repartition must off-load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..core.graph import TaskGraph
from .fabric import Fabric
from .transport import FabricTransport, NetConfig


@dataclasses.dataclass(frozen=True)
class LinkUsage:
    """One link's usage — measured (transport) or projected (compiler)."""

    index: int
    name: str                      # "src->dst" or "bus"
    protocol: str
    bytes: float                   # goodput bytes crossing the link
    utilization: float             # fraction of the link's capacity used
    flits: int = 0                 # measured only
    busy_sweeps: int = 0           # measured only
    stalled_flits: int = 0         # measured only (credit backpressure)
    escape_moves: int = 0          # measured only (credit-cycle escapes)
    peak_queue: int = 0            # measured only (ingress flit HWM)
    channels: int = 0              # projected only: cut channels routed here
    # Fault/ARQ accounting (the chaos layer; all zero without a FaultModel).
    retransmit_bytes: int = 0      # wasted wire bytes (failed + recalled)
    retransmit_flits: int = 0
    drops: int = 0                 # frames lost on the wire
    crc_errors: int = 0            # frames rejected by the receiver CRC
    down_losses: int = 0           # attempts into a scripted down window
    arq_stalls: int = 0            # transmissions refused: ARQ window full

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CongestionReport:
    """Per-link usage + aggregates for one execution or one projection."""

    kind: str                      # "measured" | "projected"
    links: List[LinkUsage]
    sweeps: int                    # measured: transport sweeps; projected: 0
    total_bytes: float             # Σ per-link bytes (hop-weighted traffic)

    @property
    def max_utilization(self) -> float:
        return max((l.utilization for l in self.links), default=0.0)

    def hotspots(self, threshold: float) -> List[LinkUsage]:
        """Links over the utilization threshold, hottest first."""
        return sorted((l for l in self.links if l.utilization > threshold),
                      key=lambda l: -l.utilization)

    def link(self, index: int) -> LinkUsage:
        return self.links[index]

    def summary(self) -> Dict[str, object]:
        out = {
            "kind": self.kind,
            "sweeps": self.sweeps,
            "total_link_bytes": self.total_bytes,
            "max_utilization": self.max_utilization,
            "links": [l.to_json() for l in self.links],
        }
        retx = sum(l.retransmit_bytes for l in self.links)
        if retx or any(l.drops or l.crc_errors or l.down_losses
                       for l in self.links):
            # Lossy-run aggregates (the chaos layer) — goodput vs wasted wire.
            out["retransmit_bytes"] = retx
            out["retransmit_flits"] = sum(l.retransmit_flits
                                          for l in self.links)
            out["drops"] = sum(l.drops for l in self.links)
            out["crc_errors"] = sum(l.crc_errors for l in self.links)
            out["down_losses"] = sum(l.down_losses for l in self.links)
        return out


def measure(transport: FabricTransport,
            flow: Optional[int] = None) -> CongestionReport:
    """Measured per-link usage from a (drained) transport.

    With ``flow`` set, only that tenant flow's flits/bytes are reported
    (utilization becomes the flow's *achieved share* of each link); the
    contention counters (stalls, escapes, queue HWMs) are link-global and
    omitted from per-flow views to keep the per-flow conservation identity
    ``Σ_flow bytes == total bytes`` the only cross-flow coupling.
    """
    counters = transport.counters
    if flow is None:
        links = [LinkUsage(
            index=l.index, name=l.name, protocol=l.protocol.name,
            bytes=float(c.bytes), utilization=transport.utilization(l.index),
            flits=c.flits, busy_sweeps=c.busy_sweeps,
            stalled_flits=c.stalled_flits, escape_moves=c.escape_moves,
            peak_queue=c.peak_queue,
            retransmit_bytes=c.retransmit_bytes,
            retransmit_flits=c.retransmit_flits, drops=c.drops,
            crc_errors=c.crc_errors, down_losses=c.down_losses,
            arq_stalls=c.arq_stalls)
            for l, c in zip(transport.fabric.links, counters)]
    else:
        links = [LinkUsage(
            index=l.index, name=l.name, protocol=l.protocol.name,
            bytes=float(c.flow_bytes.get(flow, 0)),
            utilization=transport.utilization(l.index, flow),
            flits=c.flow_flits.get(flow, 0))
            for l, c in zip(transport.fabric.links, counters)]
    return CongestionReport(
        kind="measured" if flow is None else f"measured/flow{flow}",
        links=links, sweeps=transport.sweeps_run,
        total_bytes=float(sum(l.bytes for l in links)))


def _channel_step_bytes(ch) -> float:
    return float(ch.bytes_per_step or ch.width_bits / 8.0)


def project(graph: TaskGraph, assignment: Dict[str, int], fabric: Fabric, *,
            step_time_s: Optional[float] = None,
            channels: Optional[Sequence] = None) -> CongestionReport:
    """Analytic per-link traffic for a partition assignment.

    Each cut channel demands ``bytes_per_step`` (falling back to
    ``width_bits/8``) once per step; a link serves
    ``bandwidth × step_time`` bytes per step (``step_time_s`` defaults to
    the transport's ``NetConfig.sweep_time_s``).  The result is *offered
    load*: > 1 means the cut set asks more of the link than one step can
    carry — the executor slows down by that factor on the hot link (the
    *measured* utilization, by contrast, saturates at 1).
    """
    if step_time_s is None:
        step_time_s = NetConfig().sweep_time_s
    per_link_bytes = [0.0] * len(fabric.links)
    per_link_channels = [0] * len(fabric.links)
    for ch in (channels if channels is not None else graph.channels):
        sd, dd = assignment[ch.src], assignment[ch.dst]
        if sd == dd:
            continue
        step_bytes = _channel_step_bytes(ch)
        for li in fabric.route(sd, dd):
            per_link_bytes[li] += step_bytes
            per_link_channels[li] += 1
    links = [LinkUsage(
        index=l.index, name=l.name, protocol=l.protocol.name,
        bytes=per_link_bytes[l.index],
        utilization=(per_link_bytes[l.index]
                     / (l.protocol.bandwidth_Bps * step_time_s)),
        channels=per_link_channels[l.index])
        for l in fabric.links]
    return CongestionReport(
        kind="projected", links=links, sweeps=0,
        total_bytes=float(sum(per_link_bytes)))
