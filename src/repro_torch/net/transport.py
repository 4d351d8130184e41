"""Flit transport over a :class:`~repro_torch.net.fabric.Fabric` — contention,
fair sharing, credit-based backpressure, weighted per-tenant flows.

A channel push of ``N`` bytes becomes a **message** of ``ceil(N / mtu)``
MTU-sized flits that must traverse every link of the message's route in
order.  Each executor sweep, :meth:`FabricTransport.step` arbitrates every
link:

* **bandwidth sharing** — a link moves at most ``budget_flits`` per sweep
  (``bandwidth × sweep_time / mtu``, floor 1) and splits them round-robin
  across the messages queued on it, oldest message first — two channels
  crossing the same physical link genuinely halve each other's throughput;
* **weighted flow shares** — when the transport is built with
  ``flow_weights`` (multi-tenant mode, ``repro_torch.tenants``), every
  message carries a ``flow`` id and each link runs deficit-round-robin
  *across flows*: a backlogged flow receives bandwidth proportional to its
  weight no matter how many messages its tenant stuffs into the queue —
  the isolation property the admission layer relies on.  Within a flow,
  messages still share fairly, oldest first.  ``flow_weights=None`` (the
  default) keeps the legacy per-message round-robin bit for bit;
* **credit-based backpressure** — each link's ingress buffer holds at most
  ``credits`` flits; a flit advances to the next hop only when a credit is
  free there (the stall is counted), and delivery off the final hop always
  drains (the destination FIFO slot was reserved at push time);
* **hop latency** — one hop takes one sweep by default; with
  ``NetConfig.hop_latency=True`` a hop of link ``l`` takes
  ``ceil(l.protocol.latency_s / sweep_time_s)`` sweeps (floor 1), putting
  ``Protocol.latency_s`` on the same time base as the schedule pass: a
  2-hop route's transit is exactly twice a 1-hop route's.  Moves are
  staged and applied after the link loop either way, so a flit's transit
  time is at least its hop count (matching Eq. 3's ``dist``) plus any
  queueing delay.

Progress is guaranteed: if a sweep moves nothing while messages are active
and no flit is mid-transit (a credit cycle — possible on ring/torus
routes), the oldest message's head flit advances anyway, counted as an
``escape`` move (the software analogue of a NoC escape virtual channel).

Byte accounting is exact: message flits cross each route link in FIFO
order, the last flit carrying the partial remainder, so once the network
drains, per-link byte totals satisfy ``Σ_link bytes == Σ_msg bytes × hops``
and per-channel delivered bytes equal the bytes submitted.  Per-flow
accounting is exact too: every crossed flit is attributed to its message's
flow, so ``Σ_flow flow_bytes[l] == bytes[l]`` holds on every link at every
sweep — the per-tenant conservation identity :mod:`repro_torch.tenants`
asserts.

Tenant teardown: :meth:`cancel_flow` withdraws one flow's in-flight
messages (releasing their link credits) without touching any other flow's
queues — a dead tenant's traffic drains away while its peers' streams stay
bit-identical to their solo runs.

Faults + reliable delivery (``faults=`` a
:class:`~repro_torch.net.faults.FaultModel` — the :mod:`repro_torch.chaos`
layer; ``faults=None`` keeps every legacy path byte-for-byte identical):

* each transmission attempt on a lossy link draws from that link's seeded
  rng — drop (frame vanishes), corrupt (CRC32 over the synthesized wire
  frame rejects it at the receiver), reorder (delivered late), or clean —
  and scripted down windows fail every attempt outright;
* **ARQ**: flits carry per-(link, flow) sequence numbers assigned at first
  transmission; the receiver's cumulative ACK advances during the same
  sweep loop (piggybacked — there is no separate ACK channel to lose), a
  failed flit retries under capped exponential backoff
  (``min(cap, base << attempts-1)`` sweeps), and a bounded un-acked window
  per (link, flow) backpressures *new* transmissions while full;
* byte accounting splits **goodput** (``LinkCounters.bytes`` — unchanged
  meaning: payload bytes that usefully crossed) from ``retransmit_bytes``
  (wasted wire bytes: failed attempts plus crossings reclassified by route
  repair), so the conservation identity becomes Σ_link goodput ==
  Σ_channel delivered bytes × route hops — still exact, faults or not;
* **link death + route repair**: ``fail_threshold`` consecutive failures
  mark a link (and its twin — the cable) dead; every message whose
  remaining work crosses it is recalled Go-Back-N to its source (queued
  flits evaporate, credits release, un-delivered crossings reclassify as
  retransmit), re-routed over :meth:`Fabric.route_avoiding`'s repaired
  table, and resent from its first un-delivered flit.  When no route
  survives, :class:`~repro_torch.net.faults.PartitionedFabricError` names the
  cut instead of hanging.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Set, Tuple

from ..obs.trace import coerce_tracer
from .fabric import Fabric
from .faults import (FaultModel, PartitionedFabricError, corrupt_frame,
                     flit_crc, flit_payload)


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Fabric-transport knobs (deterministic; defaults suit CI emulation).

    ``hop_latency`` opts into latency-aware calibration: each link hop
    costs ``ceil(protocol.latency_s / sweep_time_s)`` extra sweeps of wire
    latency on top of its service sweep, so protocols with different wire
    latencies (Ethernet vs inter-node 10 G) stop being timing-identical in
    the sweep domain.  The sweep is the schedule pass's time base too —
    both price a hop at the same ``latency_s``.
    """

    mtu_bytes: int = 4096          # flit payload (jumbo-frame-ish)
    sweep_time_s: float = 1e-6     # wall time one executor sweep models
    link_credits: int = 8          # per-link ingress buffer, in flits
    hop_latency: bool = False      # Protocol.latency_s -> per-hop delay
    #: Per-link fault model (repro_torch.chaos): lossy links + ARQ + route
    #: repair.  ``None`` (the default) keeps every path byte-identical.
    faults: Optional[FaultModel] = None

    def flits_for(self, nbytes: int) -> int:
        return max(1, -(-int(nbytes) // self.mtu_bytes))

    def budget_flits(self, bandwidth_Bps: float) -> int:
        return max(1, int(bandwidth_Bps * self.sweep_time_s
                          // self.mtu_bytes))

    def hop_delay(self, latency_s: float) -> int:
        """Sweeps one hop of a link with ``latency_s`` occupies: the
        service sweep plus ``ceil(latency_s / sweep_time_s)`` in flight —
        a zero-latency (or legacy-mode) hop is exactly one sweep, and an
        n-hop route lands ``n × ceil(latency_s / sweep_time_s)`` sweeps
        after its zero-latency delivery."""
        if not self.hop_latency:
            return 1
        return 1 + math.ceil(latency_s / self.sweep_time_s)


@dataclasses.dataclass
class LinkCounters:
    """Measured life of one link across an execution."""

    bytes: int = 0                 # goodput: payload bytes usefully crossed
    flits: int = 0                 # goodput flits that crossed the link
    busy_sweeps: int = 0           # sweeps with >= 1 flit crossing
    stalled_flits: int = 0         # flit-moves blocked on downstream credits
    escape_moves: int = 0          # credit-cycle escapes (see module doc)
    peak_queue: int = 0            # ingress-buffer high-water mark, in flits
    # Fault / ARQ accounting (all zero when faults=None — the legacy
    # counters above keep their exact meaning either way).
    attempt_flits: int = 0         # transmission attempts (faults mode only)
    retransmit_flits: int = 0      # wasted attempts + repair reclassifications
    retransmit_bytes: int = 0      # wire bytes of those wasted transmissions
    drops: int = 0                 # frames lost on the wire
    crc_errors: int = 0            # frames the receiver's CRC32 rejected
    down_losses: int = 0           # attempts into a scripted down window
    reorder_delays: int = 0        # frames delivered late (reorder fault)
    held_frames: int = 0           # in-sequence gaps buffered at the receiver
    arq_stalls: int = 0            # new transmissions refused: window full
    backoff_sweeps: int = 0        # Σ scheduled retransmission backoff delays
    # Per-flow attribution (multi-tenant accounting): every crossed flit
    # lands in exactly one flow bucket, so sums are exact at every sweep.
    flow_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    flow_flits: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Per-(link, flow) fault attribution: every wasted attempt, recall
    # reclassification, scheduled backoff sweep, and window stall belongs
    # to exactly one flow's message, so ``Σ_flow flow_retransmit_bytes ==
    # retransmit_bytes`` (and likewise for each sibling) holds exactly at
    # every sweep — the identity the per-tenant cost ledger
    # (:mod:`repro_torch.obs.attrib`) is built on.
    flow_retransmit_bytes: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    flow_retransmit_flits: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    flow_backoff_sweeps: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    flow_arq_stalls: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Message:
    mid: int
    channel_index: int
    route: Tuple[int, ...]
    total_bytes: int
    flits_total: int
    submitted_sweep: int
    src_queue: int                 # flits not yet injected into route[0]
    at_hop: List[int]              # flits queued at each hop's link
    crossed: List[int]             # flits that have crossed each hop's link
    flow: int = 0                  # tenant flow id (0 = the only tenant)
    delivered_flits: int = 0
    delivered_sweep: Optional[int] = None
    src_dev: int = -1              # route endpoints (route repair re-routes
    dst_dev: int = -1              # from the message's source device)
    flit_base: int = 0             # first un-delivered flit at last recall:
    #                                flit index at hop h = flit_base +
    #                                crossed[h] (0 until a route repair)
    epoch: int = 0                 # bumped by recall — stale transit entries
    #                                (older epoch) evaporate instead of landing

    def done(self) -> bool:
        return self.delivered_flits >= self.flits_total


class _Arq:
    """Per-(link, flow) reliable-delivery state: Go-Back-N bookkeeping.

    ``tx`` is the next sequence number to assign; ``expected`` the
    receiver's next in-order sequence (cumulative ACK = ``expected - 1``).
    ``held`` buffers sequences received ahead of a gap (a retried flit
    still in backoff); ``cancelled`` marks sequences whose flit was
    recalled by route repair and will never be retried.  Both sets only
    hold sequences >= ``expected`` (pruned as the cumulative ACK
    advances), so at drain the closed-books identity is
    ``tx == expected and not held and not cancelled``.
    """

    __slots__ = ("tx", "expected", "held", "cancelled")

    def __init__(self):
        self.tx = 0
        self.expected = 0
        self.held: Set[int] = set()
        self.cancelled: Set[int] = set()

    @property
    def unacked(self) -> int:
        return self.tx - self.expected - len(self.held) - len(self.cancelled)

    def receive(self, seq: int) -> None:
        if seq == self.expected:
            self.expected += 1
        else:
            self.held.add(seq)
        self._roll()

    def cancel(self, seq: int) -> None:
        self.cancelled.add(seq)
        self._roll()

    def _roll(self) -> None:
        while True:
            if self.expected in self.held:
                self.held.discard(self.expected)
            elif self.expected in self.cancelled:
                self.cancelled.discard(self.expected)
            else:
                return
            self.expected += 1

    def clean(self) -> bool:
        return (self.tx == self.expected and not self.held
                and not self.cancelled)


class FabricTransport:
    """Per-execution mutable transport state over one immutable fabric.

    ``flow_weights`` switches the link arbiter into weighted multi-flow
    mode: a mapping ``flow id -> weight`` (positive).  Unknown flows get
    weight 1.  ``None`` keeps the single-flow legacy arbiter.

    ``faults`` (a :class:`~repro_torch.net.faults.FaultModel`) switches on lossy
    links + the ARQ reliable-delivery layer + link-death route repair (see
    module doc); ``None`` keeps every legacy path byte-for-byte identical.
    """

    def __init__(self, fabric: Fabric, config: Optional[NetConfig] = None,
                 flow_weights: Optional[Mapping[int, float]] = None,
                 faults: Optional[FaultModel] = None,
                 tracer=None):
        self.fabric = fabric
        self.config = config or NetConfig()
        # Observability (obs): hot paths guard every emit with
        # ``tracer.enabled`` so the default NULL_TRACER costs nothing.
        self.tracer = coerce_tracer(tracer)
        if self.tracer.enabled:
            for l in fabric.links:
                self.tracer.note_link(l.index, max(0, l.src), max(0, l.dst))
        self.counters: List[LinkCounters] = [LinkCounters()
                                             for _ in fabric.links]
        self._budget = [self.config.budget_flits(l.protocol.bandwidth_Bps)
                        for l in fabric.links]
        self._hop_delay = [self.config.hop_delay(l.protocol.latency_s)
                           for l in fabric.links]
        self.flow_weights: Optional[Dict[int, float]] = (
            dict(flow_weights) if flow_weights is not None else None)
        if self.flow_weights is not None:
            bad = {f: w for f, w in self.flow_weights.items() if w <= 0}
            if bad:
                raise ValueError(f"flow weights must be positive: {bad}")
        self._occupancy: List[int] = [0] * len(fabric.links)
        self._messages: Dict[int, _Message] = {}
        self._next_mid = 0
        # Flits mid-transit on a multi-sweep hop: (arrival_sweep, message,
        # next_hop_or_None, payload_bytes).  next_hop None = final delivery.
        self._transit: List[Tuple[int, _Message, Optional[int], int]] = []
        # Deficit-round-robin state of the weighted arbiter + injector.
        self._drr_deficit: Dict[Tuple[int, int], float] = {}
        self._inj_deficit: Dict[Tuple[int, int], float] = {}
        self.sweeps_run = 0
        self.total_submitted_bytes = 0
        self.total_delivered_bytes = 0
        self.cancelled_messages = 0
        self.cancelled_bytes = 0
        # Per-flow cancelled payload bytes (device-kill teardown): lets the
        # cost ledger charge abandoned in-flight work to the killed tenant.
        self.cancelled_flow_bytes: Dict[int, int] = {}
        # Fault / ARQ / repair state (untouched when faults is None).
        # The model can arrive either as a constructor arg or riding on
        # NetConfig (so callers that only plumb a config need no new API).
        self.faults = faults if faults is not None else self.config.faults
        self.dead_links: Set[int] = set()
        self.reroutes = 0
        self.partition_error: Optional[PartitionedFabricError] = None
        self._rngs: Dict[int, object] = {}            # link -> Generator
        # (mid, hop) -> [next_eligible_sweep, failed_attempts, seq]
        self._retry: Dict[Tuple[int, int], List[int]] = {}
        self._arq: Dict[Tuple[int, int], _Arq] = {}   # (link, flow) -> state
        self._consec_fail: Dict[int, int] = {}        # link -> failure streak
        # Per-channel goodput hop-bytes, accumulated at delivery time:
        # each delivered flit contributes bytes × len(route at delivery) —
        # the repair-aware right-hand side of link conservation.
        self.channel_goodput_hop_bytes: Dict[int, int] = {}
        self._step_losses = 0                         # losses this sweep
        # The current sweep's staged-arrival list (see step()) — scanned
        # by _recall to release a recalled message's staged credits.
        self._live_moved: List[Tuple[_Message, int, int]] = []

    # -- submission ---------------------------------------------------------
    def submit(self, channel_index: int, src_dev: int, dst_dev: int,
               nbytes: int, sweep: int, flow: int = 0) -> int:
        """Packetize one channel push into a routed message; returns its id.

        ``flow`` tags the message with its tenant's flow id (weighted
        arbitration + per-flow byte attribution); single-design executions
        leave it at 0.
        """
        if self.dead_links:
            route = self.fabric.route_avoiding(src_dev, dst_dev,
                                               frozenset(self.dead_links))
            if route is None:
                raise self._partitioned(src_dev, dst_dev)
        else:
            route = self.fabric.route(src_dev, dst_dev)
        if not route:
            raise ValueError(f"channel {channel_index}: no network route for "
                             f"a co-located pair {src_dev}->{dst_dev}")
        if self.flow_weights is not None and flow not in self.flow_weights:
            raise ValueError(f"flow {flow} has no entry in flow_weights")
        flits = self.config.flits_for(nbytes)
        mid = self._next_mid
        self._next_mid += 1
        self._messages[mid] = _Message(
            mid=mid, channel_index=channel_index, route=route,
            total_bytes=int(nbytes), flits_total=flits,
            submitted_sweep=sweep, src_queue=flits,
            at_hop=[0] * len(route), crossed=[0] * len(route), flow=flow,
            src_dev=src_dev, dst_dev=dst_dev)
        self.total_submitted_bytes += int(nbytes)
        self._inject()
        return mid

    # -- queries ------------------------------------------------------------
    @property
    def active(self) -> bool:
        return bool(self._messages)

    def flow_active(self, flow: int) -> bool:
        """Messages of this flow still in the network."""
        return any(m.flow == flow for m in self._messages.values())

    # (Per-channel in-flight tracking lives on FifoChannel._pending — the
    # executor's congestion gating reads it there.)

    def _flow_weight(self, flow: int) -> float:
        if self.flow_weights is None:
            return 1.0
        return self.flow_weights.get(flow, 1.0)

    # -- mechanics ----------------------------------------------------------
    def _flit_bytes(self, m: _Message, crossed_before: int) -> int:
        """Bytes of the next flit to cross, flits crossing in FIFO order
        (the final flit carries the partial remainder — exact accounting).
        ``flit_base`` offsets into the message after a route repair: the
        resent stream starts at the first un-delivered flit, so a flit's
        byte split is identical on every hop it ever crosses."""
        idx = m.flit_base + crossed_before
        upper = min((idx + 1) * self.config.mtu_bytes, m.total_bytes)
        lower = min(idx * self.config.mtu_bytes, m.total_bytes)
        return upper - lower

    def _inject(self) -> None:
        """Move source-queued flits into route[0] ingress while credits
        last.  Single-flow (legacy) injection is FIFO in message-id order —
        submission order; with ``flow_weights`` the ingress window itself
        is shared by weighted DRR, or the first submitter would monopolize
        the link's credit buffer and the arbiter downstream would never
        even see a competing flow's flits."""
        if self.flow_weights is None:
            for m in sorted(self._messages.values(), key=lambda m: m.mid):
                if m.src_queue <= 0:
                    continue
                first = m.route[0]
                room = self.config.link_credits - self._occupancy[first]
                take = min(m.src_queue, room)
                if take > 0:
                    m.src_queue -= take
                    m.at_hop[0] += take
                    self._occupancy[first] += take
                    self.counters[first].peak_queue = max(
                        self.counters[first].peak_queue,
                        self._occupancy[first])
            return
        by_link: Dict[int, Dict[int, List[_Message]]] = {}
        for m in sorted(self._messages.values(), key=lambda m: m.mid):
            if m.src_queue > 0:
                by_link.setdefault(m.route[0], {}) \
                       .setdefault(m.flow, []).append(m)
        for li, by_flow in sorted(by_link.items()):
            # Credit the free ingress room to the backlogged flows split
            # by weight (GPS-normalized, like the link arbiter), then hand
            # it out one flit at a time to the largest deficit: which flow
            # submitted first stops mattering, and a flow shorted now
            # (deficit carried) wins later — weighted sharing of a
            # *bounded* credit window.
            room = self.config.link_credits - self._occupancy[li]
            wsum = sum(self._flow_weight(f) for f in by_flow)
            deficit = {f: self._inj_deficit.get((li, f), 0.0)
                       + room * self._flow_weight(f) / wsum
                       for f in by_flow}
            while (self._occupancy[li] < self.config.link_credits
                   and by_flow):
                flow = max(by_flow, key=lambda f: (deficit[f], -f))
                if deficit[flow] < 1.0:
                    break                  # everyone saves up for later
                m = by_flow[flow][0]
                m.src_queue -= 1
                m.at_hop[0] += 1
                self._occupancy[li] += 1
                deficit[flow] -= 1.0
                if m.src_queue <= 0:
                    by_flow[flow].pop(0)
                    if not by_flow[flow]:
                        del by_flow[flow]
            for flow, d in deficit.items():
                # A flow with nothing left to inject forfeits its
                # remainder (standard DRR — no banking idle sweeps).
                self._inj_deficit[(li, flow)] = d if flow in by_flow else 0.0
            self.counters[li].peak_queue = max(
                self.counters[li].peak_queue, self._occupancy[li])

    def _advance(self, m: _Message, hop: int, sweep: int,
                 moved: List[Tuple[_Message, int]], escape: bool,
                 extra_delay: int = 0) -> None:
        li = m.route[hop]
        m.at_hop[hop] -= 1
        self._occupancy[li] -= 1
        bts = self._flit_bytes(m, m.crossed[hop])
        m.crossed[hop] += 1
        c = self.counters[li]
        c.flits += 1
        c.bytes += bts
        c.flow_flits[m.flow] = c.flow_flits.get(m.flow, 0) + 1
        c.flow_bytes[m.flow] = c.flow_bytes.get(m.flow, 0) + bts
        if self.tracer.enabled:
            self.tracer.flit_hop(sweep, li, bts, m.flow, m.mid)
        if escape:
            c.escape_moves += 1
        delay = self._hop_delay[li] + extra_delay
        if hop + 1 < len(m.route):
            nxt = m.route[hop + 1]
            self._occupancy[nxt] += 1       # credit consumed immediately
            self.counters[nxt].peak_queue = max(
                self.counters[nxt].peak_queue, self._occupancy[nxt])
            if delay <= 1:
                # Staged: lands at the end of this sweep's link loop.
                moved.append((m, hop + 1, m.epoch))
            else:
                self._transit.append((sweep + delay, m, hop + 1, bts,
                                      m.epoch))
        else:
            if delay <= 1:
                self._deliver(m, bts, sweep)
            else:
                self._transit.append((sweep + delay - 1, m, None, bts,
                                      m.epoch))

    def _deliver(self, m: _Message, bts: int, sweep: int) -> None:
        m.delivered_flits += 1
        self.total_delivered_bytes += bts
        if self.faults is not None:
            # Every delivered flit crossed exactly len(route) goodput hops
            # (route repair recalls + reclassifies un-delivered flits, so
            # partial crossings never count) — accumulate the repair-aware
            # conservation right-hand side per channel.
            ch = m.channel_index
            self.channel_goodput_hop_bytes[ch] = \
                self.channel_goodput_hop_bytes.get(ch, 0) \
                + bts * len(m.route)
        if m.done():
            m.delivered_sweep = sweep

    def _land_transit(self, sweep: int) -> None:
        """Flits whose multi-sweep hop completes this sweep land now —
        either queued at their next hop or delivered off the final one.
        Entries from a pre-recall epoch evaporate (their message was
        pulled back to its source by route repair)."""
        if not self._transit:
            return
        due = [e for e in self._transit if e[0] <= sweep]
        if not due:
            return
        self._transit = [e for e in self._transit if e[0] > sweep]
        for _, m, nxt_hop, bts, epoch in due:
            if m.mid not in self._messages or epoch != m.epoch:
                continue                     # cancelled or recalled mid-air
            if nxt_hop is None:
                self._deliver(m, bts, sweep)
            else:
                m.at_hop[nxt_hop] += 1

    def step(self, sweep: int) -> List[Tuple[int, int]]:
        """Arbitrate every link for one sweep.

        Returns ``[(message_id, channel_index)]`` for messages whose final
        flit was delivered this sweep (completion order is deterministic).
        """
        self.sweeps_run += 1
        self._land_transit(sweep)
        # Staged inter-hop arrivals: (message, hop, epoch).  The list is
        # also held on self so a mid-sweep route repair can release the
        # credits of a recalled message's staged flits.
        moved: List[Tuple[_Message, int, int]] = []
        self._live_moved = moved
        crossed_links: List[int] = []
        any_flit_moved = False
        self._step_losses = 0
        order = sorted(self._messages.values(), key=lambda m: m.mid)
        for li in range(len(self.fabric.links)):
            if self.faults is not None and li in self.dead_links:
                continue                     # repair already re-routed away
            # Messages with flits queued on this link, oldest first.
            queued = [m for m in order
                      if any(m.route[h] == li and m.at_hop[h] > 0
                             for h in range(len(m.route)))]
            if not queued:
                continue
            if (self.faults is not None
                    and not self.faults.link_up(li, sweep)):
                # A scripted outage: one attempt ticks into the void per
                # sweep (counting toward the death threshold); nothing
                # can cross, so skip the arbiter entirely.
                self._tick_down_link(li, queued, sweep, moved)
                continue
            if self.flow_weights is None:
                sent = self._arbitrate_legacy(li, queued, sweep, moved)
            else:
                sent = self._arbitrate_weighted(li, queued, sweep, moved)
            if sent:
                crossed_links.append(li)
                any_flit_moved = True
        # Escape valve: a credit cycle (ring/torus routes) could otherwise
        # stall every link forever — force the oldest queued flit through.
        # Flits mid-transit on a multi-sweep hop are progress, not a cycle;
        # with faults, so are this sweep's losses (their backoff timers are
        # future progress) — and the escape must pick a flit on a live,
        # retry-eligible link, or it would "escape" into a dead wire.
        if not any_flit_moved and self._messages and not self._transit:
            if self.faults is None:
                for m in order:
                    hop = next((h for h in range(len(m.route))
                                if m.at_hop[h] > 0), None)
                    if hop is not None:
                        self._advance(m, hop, sweep, moved, escape=True)
                        crossed_links.append(m.route[hop])
                        break
            elif self._step_losses == 0:
                for m in order:
                    hop = self._escape_hop(m, sweep)
                    if hop is not None:
                        res = self._service(m, hop, sweep, moved,
                                            escape=True)
                        if res == "crossed":
                            crossed_links.append(m.route[hop])
                        break
        for li in set(crossed_links):
            self.counters[li].busy_sweeps += 1
        # Staged arrivals land after the link loop: one hop per sweep.
        # (Entries of a message recalled by route repair this sweep carry
        # a stale epoch and evaporate — their credits were released at
        # recall time.  With faults=None the epoch is always 0.)
        for m, hop, epoch in moved:
            if epoch == m.epoch and m.mid in self._messages:
                m.at_hop[hop] += 1
        self._inject()
        completed = [(m.mid, m.channel_index)
                     for m in sorted(self._messages.values(),
                                     key=lambda m: m.mid)
                     if m.done() and m.delivered_sweep == sweep]
        for mid, _ in completed:
            del self._messages[mid]
        return completed

    def _arbitrate_legacy(self, li: int, queued: List[_Message], sweep: int,
                          moved: List[Tuple[_Message, int]]) -> int:
        """Pre-tenant arbiter: round-robin one flit per *message* per lap."""
        budget = self._budget[li]
        sent_on_link = 0
        progressing = True
        blocked: set = set()
        while budget > 0 and progressing:
            progressing = False
            for m in queued:
                if budget <= 0:
                    break
                if m.mid in blocked:
                    continue
                hop = next((h for h in range(len(m.route))
                            if m.route[h] == li and m.at_hop[h] > 0),
                           None)
                if hop is None:
                    continue
                if hop + 1 < len(m.route):
                    nxt = m.route[hop + 1]
                    if self._occupancy[nxt] >= self.config.link_credits:
                        self.counters[li].stalled_flits += 1
                        blocked.add(m.mid)
                        continue
                if self.faults is None:
                    self._advance(m, hop, sweep, moved, escape=False)
                else:
                    res = self._service(m, hop, sweep, moved, escape=False)
                    if res == "skip":        # backoff / ARQ window holds it
                        blocked.add(m.mid)
                        continue
                    if res == "lost":        # the wire time is spent anyway
                        budget -= 1
                        blocked.add(m.mid)   # its backoff outlives the sweep
                        progressing = True
                        continue
                budget -= 1
                sent_on_link += 1
                progressing = True
        return sent_on_link

    def _arbitrate_weighted(self, li: int, queued: List[_Message],
                            sweep: int,
                            moved: List[Tuple[_Message, int]]) -> int:
        """Weight-proportional link service via GPS-normalized deficits.

        Each sweep the link's whole flit budget is credited to the
        backlogged flows *split by weight* (Σ credit == budget — crediting
        a full quantum per flow regardless of capacity would let whichever
        flow is ahead stay ahead forever when Σ weights exceeds the
        budget).  Flits are then spent largest-deficit-first, one at a
        time, which makes the outcome independent of flow id or submission
        order; fractional remainders carry across sweeps, so shares
        converge to the weights within one flit per link.  A flow that
        empties or blocks on downstream credits forfeits its remainder —
        standard DRR, no banking idle sweeps into a later burst.  Within a
        flow, messages are served oldest-first (FIFO).
        """
        budget = self._budget[li]
        sent_on_link = 0
        by_flow: Dict[int, List[_Message]] = {}
        for m in queued:
            by_flow.setdefault(m.flow, []).append(m)
        wsum = sum(self._flow_weight(f) for f in by_flow)
        deficit = {f: self._drr_deficit.get((li, f), 0.0)
                   + budget * self._flow_weight(f) / wsum
                   for f in by_flow}
        blocked: set = set()
        live = dict(by_flow)           # flows that may still have servable
        while budget > 0 and live:
            flow = max(live, key=lambda f: (deficit[f], -f))
            if deficit[flow] < 1.0:
                break                  # fractions carry to the next sweep
            advanced = False
            for m in live[flow]:       # oldest message first
                if m.mid in blocked:
                    continue
                hop = next((h for h in range(len(m.route))
                            if m.route[h] == li and m.at_hop[h] > 0),
                           None)
                if hop is None:
                    continue
                if hop + 1 < len(m.route):
                    nxt = m.route[hop + 1]
                    if self._occupancy[nxt] >= self.config.link_credits:
                        self.counters[li].stalled_flits += 1
                        blocked.add(m.mid)
                        continue
                if self.faults is None:
                    self._advance(m, hop, sweep, moved, escape=False)
                else:
                    res = self._service(m, hop, sweep, moved, escape=False)
                    if res == "skip":
                        blocked.add(m.mid)
                        continue
                    if res == "lost":
                        deficit[flow] -= 1.0
                        budget -= 1
                        blocked.add(m.mid)
                        advanced = True
                        break
                deficit[flow] -= 1.0
                budget -= 1
                sent_on_link += 1
                advanced = True
                break
            if not advanced:
                # Nothing servable: forfeit the deficit, leave the ring.
                deficit[flow] = 0.0
                del live[flow]
        for f, d in deficit.items():
            has_more = f in live and any(
                m.mid not in blocked
                and any(m.route[h] == li and m.at_hop[h] > 0
                        for h in range(len(m.route)))
                for m in live[f])
            self._drr_deficit[(li, f)] = d if has_more else 0.0
        return sent_on_link

    # -- faults, ARQ, and route repair (all no-ops when faults is None) -----
    def _rng(self, li: int):
        if li not in self._rngs:
            self._rngs[li] = self.faults.rng(li)
        return self._rngs[li]

    def _arq_state(self, li: int, flow: int) -> _Arq:
        key = (li, flow)
        if key not in self._arq:
            self._arq[key] = _Arq()
        return self._arq[key]

    def _partitioned(self, src: int, dst: int) -> PartitionedFabricError:
        err = PartitionedFabricError(src, dst, tuple(self.dead_links))
        self.partition_error = err
        return err

    def _draw(self, li: int, sweep: int) -> Tuple[str, int]:
        """One transmission attempt's fate on link ``li``: ``(outcome,
        extra_delay)`` with outcome in ok/drop/corrupt/down; a reorder is
        an ok with extra landing delay (the reliable layer turns frame
        reordering into jitter — per-message FIFO is preserved by the
        crossing order either way)."""
        if not self.faults.link_up(li, sweep):
            return "down", 0
        lf = self.faults.for_link(li)
        if not (lf.drop or lf.corrupt or lf.reorder):
            return "ok", 0
        rng = self._rng(li)
        u = float(rng.random())
        if u < lf.drop:
            return "drop", 0
        if u < lf.drop + lf.corrupt:
            return "corrupt", 0
        if u < lf.drop + lf.corrupt + lf.reorder:
            return "ok", 1 + int(rng.integers(1, 4))
        return "ok", 0

    def _service(self, m: _Message, hop: int, sweep: int,
                 moved: List[Tuple[_Message, int]], escape: bool) -> str:
        """One ARQ-guarded transmission attempt of ``m``'s head flit at
        ``hop``.  Returns ``"crossed"`` (flit advanced), ``"lost"`` (wire
        time spent, flit stays queued under backoff), or ``"skip"``
        (backoff pending / ARQ window full — nothing consumed)."""
        li = m.route[hop]
        key = (m.mid, hop)
        st = self._retry.get(key)
        if st is not None and st[0] > sweep:
            return "skip"                    # still waiting out its backoff
        c = self.counters[li]
        arq = self._arq_state(li, m.flow)
        if st is None:
            # First transmission of this flit visit: a sequence number is
            # assigned now — unless the bounded un-acked window is full,
            # which backpressures the sender (retries are always admitted,
            # or the window could never drain).
            if arq.unacked >= self.faults.arq_window:
                c.arq_stalls += 1
                c.flow_arq_stalls[m.flow] = \
                    c.flow_arq_stalls.get(m.flow, 0) + 1
                return "skip"
            seq = arq.tx
            arq.tx += 1
            st = [sweep, 0, seq]
        seq = st[2]
        flit_index = m.flit_base + m.crossed[hop]
        fb = self._flit_bytes(m, m.crossed[hop])
        c.attempt_flits += 1
        outcome, extra_delay = self._draw(li, sweep)
        payload = flit_payload(m.mid, flit_index, fb)
        crc = flit_crc(payload)
        received = None if outcome in ("drop", "down") else (
            corrupt_frame(payload, self._rng(li))
            if outcome == "corrupt" else payload)
        if received is not None and flit_crc(received) == crc:
            # Clean receipt: cumulative-ACK bookkeeping advances in the
            # same sweep loop (piggybacked — no separate ACK channel).
            if seq != arq.expected:
                c.held_frames += 1
            arq.receive(seq)
            self._retry.pop(key, None)
            self._consec_fail[li] = 0
            if extra_delay:
                c.reorder_delays += 1
            self._advance(m, hop, sweep, moved, escape=escape,
                          extra_delay=extra_delay)
            return "crossed"
        # Lost on the wire (or rejected by the receiver's CRC): the wire
        # bytes are spent but useless — retransmit accounting, capped
        # exponential backoff, and the link-death streak all tick.
        c.retransmit_flits += 1
        c.retransmit_bytes += fb
        c.flow_retransmit_flits[m.flow] = \
            c.flow_retransmit_flits.get(m.flow, 0) + 1
        c.flow_retransmit_bytes[m.flow] = \
            c.flow_retransmit_bytes.get(m.flow, 0) + fb
        if outcome == "drop":
            c.drops += 1
        elif outcome == "down":
            c.down_losses += 1
        else:
            c.crc_errors += 1
        attempts = st[1] + 1
        delay = min(self.faults.backoff_cap,
                    self.faults.backoff_base << min(attempts - 1, 16))
        c.backoff_sweeps += delay
        c.flow_backoff_sweeps[m.flow] = \
            c.flow_backoff_sweeps.get(m.flow, 0) + delay
        self._retry[key] = [sweep + delay, attempts, seq]
        self._step_losses += 1
        if self.tracer.enabled:
            self.tracer.retransmit(sweep, li, fb, m.flow, outcome)
            self.tracer.arq_backoff(sweep, li, delay, m.flow, m.mid)
        self._note_failure(li, sweep)
        return "lost"

    def _tick_down_link(self, li: int, queued: List[_Message], sweep: int,
                        moved: List[Tuple[_Message, int]]) -> None:
        """A link inside a scripted down window: the oldest retry-eligible
        flit transmits into the void once per sweep — one loss, one
        backoff step, one tick toward the death threshold."""
        for m in queued:
            hop = next((h for h in range(len(m.route))
                        if m.route[h] == li and m.at_hop[h] > 0), None)
            if hop is None:
                continue
            st = self._retry.get((m.mid, hop))
            if st is not None and st[0] > sweep:
                continue
            if self._service(m, hop, sweep, moved, escape=False) != "skip":
                return

    def _escape_hop(self, m: _Message, sweep: int) -> Optional[int]:
        """The first hop of ``m`` with a queued flit the escape valve may
        legally force: live link, not in a backoff wait, and not blocked
        by a full ARQ window (window-blocked flits are covered by the
        retries that must drain first)."""
        for h in range(len(m.route)):
            if m.at_hop[h] <= 0:
                continue
            li = m.route[h]
            if li in self.dead_links or not self.faults.link_up(li, sweep):
                continue
            st = self._retry.get((m.mid, h))
            if st is not None and st[0] > sweep:
                continue
            if st is None:
                arq = self._arq_state(li, m.flow)
                if arq.unacked >= self.faults.arq_window:
                    continue
            return h
        return None

    def _note_failure(self, li: int, sweep: int) -> None:
        th = self.faults.fail_threshold
        if th is None or li in self.dead_links:
            return
        streak = self._consec_fail.get(li, 0) + 1
        self._consec_fail[li] = streak
        if streak >= th:
            self._mark_dead(li, sweep)

    def _mark_dead(self, li: int, sweep: int) -> None:
        """Declare a link (and its twin — the physical cable) dead, then
        repair: recall every message whose remaining work crosses it."""
        dead = {li}
        twin = self.fabric.links[li].twin
        if twin >= 0 and twin != li:
            dead.add(twin)
        self.dead_links |= dead
        if self.tracer.enabled:
            for dl in sorted(dead):
                self.tracer.link_death(sweep, dl)
        for mid in sorted(self._messages):
            m = self._messages[mid]
            needs = any(m.route[h] in dead
                        and m.flit_base + m.crossed[h] < m.flits_total
                        for h in range(len(m.route)))
            if needs:
                self._recall(m, sweep)

    def _recall(self, m: _Message, sweep: int) -> None:
        """Go-Back-N recall to source + re-route (route repair).

        Un-delivered flits evaporate from the old route (queued ones
        release their credits, mid-transit ones die by epoch), every
        crossing beyond the delivered prefix is **reclassified** goodput →
        retransmit (exact byte arithmetic — the conservation identity
        keeps holding mid-repair), and the message restarts from its first
        un-delivered flit over the repaired route.
        """
        delivered = m.delivered_flits
        for h, li in enumerate(m.route):
            if m.at_hop[h] > 0:
                self._occupancy[li] -= m.at_hop[h]
                m.at_hop[h] = 0
            # Crossings of flits that never delivered were wasted work:
            # move their bytes from the goodput bucket to retransmit.
            useful = max(0, min(m.crossed[h], delivered - m.flit_base))
            c = self.counters[li]
            for j in range(useful, m.crossed[h]):
                fb = self._flit_bytes(m, j)
                c.bytes -= fb
                c.flits -= 1
                c.retransmit_bytes += fb
                c.retransmit_flits += 1
                c.flow_bytes[m.flow] -= fb
                c.flow_flits[m.flow] -= 1
                c.flow_retransmit_bytes[m.flow] = \
                    c.flow_retransmit_bytes.get(m.flow, 0) + fb
                c.flow_retransmit_flits[m.flow] = \
                    c.flow_retransmit_flits.get(m.flow, 0) + 1
                if self.tracer.enabled:
                    # The trace is append-only but repair moves these
                    # crossings goodput -> retransmit: emit a compensating
                    # event so trace goodput keeps matching the counters.
                    self.tracer.flit_reclassify(sweep, li, fb, m.flow,
                                                m.mid)
        # Credits of flits mid-transit were charged to their *next* hop's
        # link at advance time — release them; the entries themselves die
        # by the epoch bump below.
        for _, tm, nxt_hop, _bts, epoch in self._transit:
            if tm.mid == m.mid and epoch == m.epoch and nxt_hop is not None:
                self._occupancy[m.route[nxt_hop]] -= 1
        # Same for arrivals staged earlier in this very sweep.
        for tm, hop, epoch in self._live_moved:
            if tm.mid == m.mid and epoch == m.epoch:
                self._occupancy[m.route[hop]] -= 1
        # Sequence numbers assigned to recalled flits will never complete:
        # cancel them so the cumulative ACK can close the books.
        for h in range(len(m.route)):
            st = self._retry.pop((m.mid, h), None)
            if st is not None:
                self._arq_state(m.route[h], m.flow).cancel(st[2])
        new_route = self.fabric.route_avoiding(
            m.src_dev, m.dst_dev, frozenset(self.dead_links))
        if new_route is None or not new_route:
            raise self._partitioned(m.src_dev, m.dst_dev)
        m.route = new_route
        m.flit_base = delivered
        m.src_queue = m.flits_total - delivered
        m.at_hop = [0] * len(new_route)
        m.crossed = [0] * len(new_route)
        m.epoch += 1
        self.reroutes += 1
        if self.tracer.enabled:
            self.tracer.reroute(sweep, m.mid, m.flow, len(new_route))

    def arq_books_closed(self) -> bool:
        """Every (link, flow) ARQ stream's books are closed: cumulative
        ACK caught up with assignment, nothing held, nothing cancelled
        outstanding.  True on a drained transport — asserted by the chaos
        tests as the reliable-delivery exactness check."""
        return all(a.clean() for a in self._arq.values())

    def goodput_hop_bytes_total(self) -> int:
        """Σ over channels of delivered bytes × hops (repair-aware) —
        the right-hand side of link conservation under faults."""
        return sum(self.channel_goodput_hop_bytes.values())

    # -- tenant teardown ----------------------------------------------------
    def cancel_flow(self, flow: int) -> List[Tuple[int, int]]:
        """Withdraw every in-flight message of ``flow`` (device kill).

        Queued flits release their link credits immediately; flits
        mid-transit on a multi-sweep hop evaporate on landing.  Other
        flows' queues, deficits, and accounting are untouched — bytes the
        cancelled messages already moved stay attributed to ``flow``, so
        per-link ``Σ_flow flow_bytes == bytes`` keeps holding exactly.

        Returns the cancelled ``[(message_id, channel_index)]``.
        """
        cancelled: List[Tuple[int, int]] = []
        for mid in sorted(self._messages):
            m = self._messages[mid]
            if m.flow != flow:
                continue
            for h, li in enumerate(m.route):
                if m.at_hop[h] > 0:
                    self._occupancy[li] -= m.at_hop[h]
                    m.at_hop[h] = 0
            # Credits of flits mid-transit were charged to their *next*
            # hop's link at advance time — release those too.
            for _, tm, nxt_hop, _bts, epoch in self._transit:
                if tm.mid == mid and epoch == m.epoch \
                        and nxt_hop is not None:
                    self._occupancy[tm.route[nxt_hop]] -= 1
            if self.faults is not None:
                # Pending retransmissions die with the message; their
                # sequence numbers are cancelled so the surviving flows'
                # cumulative ACKs (and the closed-books check) stay exact.
                for h in range(len(m.route)):
                    st = self._retry.pop((mid, h), None)
                    if st is not None:
                        self._arq_state(m.route[h], m.flow).cancel(st[2])
            self.cancelled_messages += 1
            self.cancelled_bytes += m.total_bytes
            self.cancelled_flow_bytes[flow] = \
                self.cancelled_flow_bytes.get(flow, 0) + m.total_bytes
            cancelled.append((mid, m.channel_index))
        for mid, _ in cancelled:
            del self._messages[mid]
        self._transit = [e for e in self._transit
                         if e[1].mid in self._messages]
        # A dead flow's banked deficits die with it — a later incarnation
        # (fresh flow id) must start clean anyway.
        for store in (self._drr_deficit, self._inj_deficit):
            for key in [k for k in store if k[1] == flow]:
                del store[key]
        return cancelled

    def drain(self, sweep: int, *, limit: int = 1_000_000
              ) -> List[Tuple[int, int]]:
        """Run the network dry (post-execution accounting completeness)."""
        completed: List[Tuple[int, int]] = []
        while self.active:
            completed.extend(self.step(sweep))
            sweep += 1
            limit -= 1
            if limit <= 0:  # pragma: no cover - progress is guaranteed
                raise RuntimeError("transport failed to drain")
        return completed

    # -- reporting ----------------------------------------------------------
    def utilization(self, link_index: int,
                    flow: Optional[int] = None) -> float:
        """Crossed flits over offered flit-sweeps (0 when never stepped).
        With ``flow``, only that flow's flits count — its achieved share."""
        if self.sweeps_run == 0:
            return 0.0
        cap = self._budget[link_index] * self.sweeps_run
        if not cap:
            return 0.0
        c = self.counters[link_index]
        flits = c.flits if flow is None else c.flow_flits.get(flow, 0)
        return flits / cap

    def flow_link_bytes(self, flow: int) -> int:
        """Σ over links of this flow's crossed bytes (hop-weighted)."""
        return sum(c.flow_bytes.get(flow, 0) for c in self.counters)

    def flow_fault_totals(self, flow: int) -> Dict[str, int]:
        """Σ over links of one flow's fault-recovery costs — the network
        side of the per-tenant cost ledger.
        Summing each entry over every flow recovers the matching global
        link counter exactly (integer equality)."""
        out = {"retransmit_bytes": 0, "retransmit_flits": 0,
               "backoff_sweeps": 0, "arq_stalls": 0}
        for c in self.counters:
            out["retransmit_bytes"] += c.flow_retransmit_bytes.get(flow, 0)
            out["retransmit_flits"] += c.flow_retransmit_flits.get(flow, 0)
            out["backoff_sweeps"] += c.flow_backoff_sweeps.get(flow, 0)
            out["arq_stalls"] += c.flow_arq_stalls.get(flow, 0)
        return out
