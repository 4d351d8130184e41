"""Per-device HBM banks — burst service, fair arbitration, exact accounting.

A copy of the JAX package's ``mem/banks.py``: the bank model is plain
Python, so the port runs it unchanged on the host beside the card.

The paper's distributed-HBM designs are built around bank contention: a
device's HBM is not one fat pipe but 32 independent pseudo-channels, and a
design that funnels every reader through one channel saturates long before
the aggregate bandwidth is reached (§3: a 256-bit port saturates ~51% of a
bank).  This module is the executable counterpart, mirroring the flit
transport of the network layer (``net.transport``) one layer down:

* a memory-channel request of ``N`` bytes becomes ``ceil(N / burst_bytes)``
  **bursts** that one bank must serve in FIFO order (the last burst carries
  the partial remainder — byte accounting is exact);
* each executor sweep, :meth:`MemorySystem.step` serves every bank up to
  its per-sweep budget (``bank_bandwidth × sweep_time / burst_bytes``,
  floor 1) and splits the budget **round-robin across the memory channels
  mapped to that bank**, oldest request per channel first — two tasks
  reading from the same bank genuinely halve each other's throughput;
* outstanding-transaction **credits** live on the channel side
  (:class:`~repro_torch.mem.channels.AsyncMemChannel`): a channel may have at
  most ``credits`` requests issued-but-unconsumed, the bounded reorder
  window of TAPA's ``async_mmap``.

Once every request is served, per-bank byte totals satisfy
``Σ_bank bytes == Σ_channel delivered bytes`` exactly (each request is
served by exactly one bank — there is no hop multiplier here, unlike the
network's ``Σ bytes × hops``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..obs.trace import coerce_tracer

#: Wall time one executor sweep models, in seconds: the step-time base the
#: memory and link projections share (the network transport's
#: ``NetConfig.sweep_time_s`` default has the same value, and the port's
#: network layer reads it from here).
SWEEP_TIME_S = 1e-6


@dataclasses.dataclass(frozen=True)
class MemConfig:
    """HBM bank-model knobs (deterministic; defaults suit CI emulation).

    ``sweep_time_s`` is :data:`SWEEP_TIME_S`, the step-time base the
    network transport shares, so the memory and link projections price the
    same executor sweep.
    """

    banks_per_device: int = 8          # HBM pseudo-channels modeled per FPGA
    bank_bandwidth_Bps: float = 57.5e9  # per-bank service (460 GB/s / 8)
    credits: int = 8                   # max outstanding reads per channel
    burst_bytes: int = 512             # AXI burst payload

    @property
    def sweep_time_s(self) -> float:
        return SWEEP_TIME_S

    def bursts_for(self, nbytes: int) -> int:
        return max(1, -(-int(nbytes) // self.burst_bytes))

    def budget_bursts(self) -> int:
        """Bursts one bank serves per executor sweep (floor 1: progress)."""
        return max(1, int(self.bank_bandwidth_Bps * self.sweep_time_s
                          // self.burst_bytes))

    def device_bandwidth_Bps(self) -> float:
        return self.banks_per_device * self.bank_bandwidth_Bps


@dataclasses.dataclass
class BankCounters:
    """Measured life of one (device, bank) over an execution."""

    bytes: int = 0                 # payload bytes the bank served
    bursts: int = 0                # bursts the bank served
    busy_sweeps: int = 0           # sweeps with >= 1 burst served
    saturated_sweeps: int = 0      # sweeps that exhausted the budget with
    #                                requests still queued (contention)
    peak_queue_bursts: int = 0     # queued-burst high-water mark
    requests: int = 0              # requests submitted to this bank
    # Per-flow attribution (multi-tenant accounting) — every served burst
    # lands in exactly one flow bucket, so Σ_flow == total exactly.
    flow_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    flow_bursts: Dict[int, int] = dataclasses.field(default_factory=dict)
    flow_requests: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Request:
    rid: int
    chan_index: int                # AsyncMemChannel index (executor's list)
    bank: int                      # flat bank id
    total_bytes: int
    bursts_total: int
    submitted_sweep: int
    flow: int = 0                  # tenant flow id (0 = the only tenant)
    served: int = 0                # bursts served so far
    done_sweep: Optional[int] = None

    def done(self) -> bool:
        return self.served >= self.bursts_total


class MemorySystem:
    """Per-execution mutable bank state — the memory-side FabricTransport.

    ``num_devices`` logical devices × ``config.banks_per_device`` banks.
    Flat bank id = ``device * banks_per_device + bank``.
    """

    def __init__(self, num_devices: int,
                 config: Optional[MemConfig] = None,
                 tracer=None):
        self.config = config or MemConfig()
        self.num_devices = int(num_devices)
        # Observability (repro_torch.obs): emits are guarded by tracer.enabled —
        # the default NULL_TRACER keeps the serve loop allocation-free.
        self.tracer = coerce_tracer(tracer)
        nbanks = self.num_devices * self.config.banks_per_device
        self.counters: List[BankCounters] = [BankCounters()
                                             for _ in range(nbanks)]
        self._budget = self.config.budget_bursts()
        # Per-bank FIFO of request ids, grouped per channel for fairness.
        self._queues: Dict[int, List[int]] = {b: [] for b in range(nbanks)}
        self._requests: Dict[int, _Request] = {}
        self._next_rid = 0
        self.sweeps_run = 0
        self.total_requested_bytes = 0
        self.total_served_bytes = 0

    def bank_id(self, device: int, bank: int) -> int:
        b = self.config.banks_per_device
        if not (0 <= device < self.num_devices):
            raise ValueError(f"device {device} outside 0..{self.num_devices}")
        return device * b + (bank % b)

    # -- submission ---------------------------------------------------------
    def submit(self, chan_index: int, device: int, bank: int,
               nbytes: int, sweep: int, flow: int = 0) -> int:
        """Queue one read request on its bank; returns the request id.
        ``flow`` tags the request with its tenant (per-flow accounting)."""
        bid = self.bank_id(device, bank)
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid=rid, chan_index=chan_index, bank=bid,
                       total_bytes=int(nbytes),
                       bursts_total=self.config.bursts_for(nbytes),
                       submitted_sweep=sweep, flow=flow)
        self._requests[rid] = req
        self._queues[bid].append(rid)
        c = self.counters[bid]
        c.requests += 1
        c.flow_requests[flow] = c.flow_requests.get(flow, 0) + 1
        self.total_requested_bytes += int(nbytes)
        queued = sum(self._requests[r].bursts_total - self._requests[r].served
                     for r in self._queues[bid])
        c.peak_queue_bursts = max(c.peak_queue_bursts, queued)
        return rid

    # -- queries ------------------------------------------------------------
    @property
    def active(self) -> bool:
        return bool(self._requests)

    def flow_active(self, flow: int) -> bool:
        """Requests of this tenant flow still queued on some bank."""
        return any(r.flow == flow for r in self._requests.values())

    # -- mechanics ----------------------------------------------------------
    def _burst_bytes(self, req: _Request, served_before: int) -> int:
        """Bytes of the next burst (last burst carries the remainder)."""
        upper = min((served_before + 1) * self.config.burst_bytes,
                    req.total_bytes)
        lower = min(served_before * self.config.burst_bytes, req.total_bytes)
        return upper - lower

    def step(self, sweep: int) -> List[Tuple[int, int]]:
        """Serve every bank for one sweep.

        Returns ``[(request_id, chan_index)]`` for requests whose final
        burst was served this sweep (deterministic completion order).
        """
        self.sweeps_run += 1
        completed: List[Tuple[int, int]] = []
        for bid, queue in self._queues.items():
            if not queue:
                continue
            c = self.counters[bid]
            budget = self._budget
            served_on_bank = 0
            # Fair round-robin across the channels queued on this bank:
            # one burst per channel per lap, each channel's oldest request
            # first, until the budget or the queues run out.
            progressing = True
            while budget > 0 and progressing:
                progressing = False
                chans_seen: Dict[int, int] = {}
                for rid in list(queue):
                    if budget <= 0:
                        break
                    req = self._requests[rid]
                    if req.chan_index in chans_seen:
                        continue          # one burst per channel per lap
                    chans_seen[req.chan_index] = rid
                    bts = self._burst_bytes(req, req.served)
                    req.served += 1
                    c.bursts += 1
                    c.bytes += bts
                    c.flow_bursts[req.flow] = \
                        c.flow_bursts.get(req.flow, 0) + 1
                    c.flow_bytes[req.flow] = \
                        c.flow_bytes.get(req.flow, 0) + bts
                    if self.tracer.enabled:
                        self.tracer.bank_burst(
                            sweep, bid, bid // self.config.banks_per_device,
                            bts, req.flow, req.chan_index)
                    self.total_served_bytes += bts
                    budget -= 1
                    served_on_bank += 1
                    progressing = True
                    if req.done():
                        req.done_sweep = sweep
                        queue.remove(rid)
                        completed.append((rid, req.chan_index))
            if served_on_bank:
                c.busy_sweeps += 1
            if budget <= 0 and queue:
                c.saturated_sweeps += 1
        for rid, _ in completed:
            del self._requests[rid]
        return completed

    def cancel_flow(self, flow: int) -> List[Tuple[int, int]]:
        """Withdraw every queued request of ``flow`` (tenant teardown).

        Bursts already served stay attributed to the flow (conservation
        keeps holding); other flows' queues are untouched.  Returns the
        cancelled ``[(request_id, chan_index)]``.
        """
        cancelled = [(rid, r.chan_index)
                     for rid, r in sorted(self._requests.items())
                     if r.flow == flow]
        for rid, _ in cancelled:
            bank = self._requests[rid].bank
            self._queues[bank].remove(rid)
            del self._requests[rid]
        return cancelled

    def drain(self, sweep: int, *, limit: int = 1_000_000
              ) -> List[Tuple[int, int]]:
        """Serve every queued request dry (accounting completeness)."""
        completed: List[Tuple[int, int]] = []
        while self.active:
            completed.extend(self.step(sweep))
            sweep += 1
            limit -= 1
            if limit <= 0:  # pragma: no cover - budget floor 1 guarantees
                raise RuntimeError("memory system failed to drain")
        return completed

    # -- reporting ----------------------------------------------------------
    def flow_mem_totals(self, flow: int) -> Dict[str, int]:
        """Σ over banks of one flow's served bytes/bursts/requests — the
        memory side of a per-tenant cost ledger.
        Summing each entry over every flow recovers the matching global
        bank counter exactly (integer equality)."""
        out = {"bytes": 0, "bursts": 0, "requests": 0}
        for c in self.counters:
            out["bytes"] += c.flow_bytes.get(flow, 0)
            out["bursts"] += c.flow_bursts.get(flow, 0)
            out["requests"] += c.flow_requests.get(flow, 0)
        return out

    def utilization(self, bank_id: int, flow: Optional[int] = None) -> float:
        """Served bursts over offered burst-slots (0 when never stepped) —
        achieved throughput, <= 1 by construction.  With ``flow``, only
        that tenant's bursts count: its achieved share of the bank."""
        if self.sweeps_run == 0:
            return 0.0
        cap = self._budget * self.sweeps_run
        if not cap:
            return 0.0
        c = self.counters[bank_id]
        bursts = c.bursts if flow is None else c.flow_bursts.get(flow, 0)
        return bursts / cap
