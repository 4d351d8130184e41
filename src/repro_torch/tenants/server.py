"""The multi-tenant server — N ``CompiledDesign``s over ONE shared fabric.

Each tenant is a compiled design placed onto the shared physical fabric
through a ``device_map`` (its logical device *i* lives at fabric device
``device_map[i]``), running as an :class:`~repro_torch.exec.ExecutionState`
on the server's one torch device (``cuda`` unless the caller asks for
another; with no card and no ``device=`` the server raises).  The map
places a design on *fabric* ids; every logical device of every tenant
computes on that one torch device.  The server owns the substrate the
states share:

* one :class:`~repro_torch.net.transport.FabricTransport` in weighted-flow mode
  (``flow_weights`` = each tenant's SLO weight) — every tenant's traffic
  is tagged with its flow id, link arbitration is weighted-DRR fair, and
  the per-flow byte buckets give each tenant its own
  :class:`~repro_torch.net.congestion.CongestionReport` with the conservation
  identity ``Σ_tenant link bytes == total link bytes`` holding **exactly**
  (asserted in :meth:`TenantServer.conservation`, not assumed);
* optionally one :class:`~repro_torch.mem.banks.MemorySystem` spanning the
  fabric's devices, shared the same way (per-flow bank accounting).

States never see the shared objects directly: each gets a
:class:`FlowTransport` / :class:`FlowMemory` view that offsets its local
channel indices into a global index space, tags every submit with its
flow, and scopes ``active`` to its own traffic.  The server steps the
shared substrate once per sweep and demuxes completions back to the
owning state — the executor's sweep semantics are unchanged, which is why
a tenant's outputs are **bit-identical** to its solo run (payloads never
touch the flit clock; the tests assert the identity anyway, comparing bit
patterns with :func:`~repro_torch.exec.bit_identical`).

Fault story (``repro_torch.runtime.fault``): :class:`DeviceKill` schedules a
:class:`~repro_torch.runtime.fault.FailureInjector` to fire at a sweep; the
injected failure kills every tenant whose map uses the dead fabric device
— its in-flight flits and bank requests are cancelled (credits released,
peers' queues untouched), its state discarded.  With ``readmit=True`` the
victim is re-admitted under a fresh flow id via
:func:`repro_torch.tenants.recover.plan_recovery`: a *transient* kill
(``DeviceKill.transient=True`` — the process died, the device returns) of
a tenant that was checkpointing (``Tenant.checkpoint_dir`` +
``run(checkpoint_every=...)``) **restores** the same design from its last
sweep barrier, costing only the sweeps since the barrier; a permanent
device loss re-compiles onto the survivors and re-runs.  Either way the
incarnations' accounting never mixes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import torch

from ..compiler.artifact import CompiledDesign
# bit_identical is re-exported: the tenant layer's isolation check.
from ..exec import ExecutionResult, bit_identical, resolve_device  # noqa: F401
from ..exec.executor import DeadlockError, ExecutionState
from ..net.fabric import Fabric
from ..net.transport import FabricTransport, NetConfig
from ..obs.trace import coerce_tracer
from ..runtime.fault import FailureInjector
from .slo import SLO


class FlowTransport:
    """One tenant's view of the shared transport: local channel index →
    global (``base`` offset), every submit tagged with ``flow``, and
    ``active`` scoped to this flow's in-network traffic."""

    def __init__(self, inner: FabricTransport, flow: int, base: int):
        self.inner = inner
        self.flow = flow
        self.base = base

    @property
    def config(self) -> NetConfig:
        return self.inner.config

    @property
    def fabric(self) -> Fabric:
        return self.inner.fabric

    @property
    def active(self) -> bool:
        return self.inner.flow_active(self.flow)

    def submit(self, channel_index: int, src_dev: int, dst_dev: int,
               nbytes: int, sweep: int) -> int:
        return self.inner.submit(self.base + channel_index, src_dev,
                                 dst_dev, nbytes, sweep, flow=self.flow)


class FlowMemory:
    """One tenant's view of the shared memory system — same contract as
    :class:`FlowTransport`, plus the logical→fabric device mapping (banks
    live on *fabric* devices)."""

    def __init__(self, inner, flow: int, base: int,
                 device_map: Sequence[int]):
        self.inner = inner
        self.flow = flow
        self.base = base
        self.device_map = list(device_map)

    @property
    def config(self):
        return self.inner.config

    @property
    def active(self) -> bool:
        return self.inner.flow_active(self.flow)

    def bank_id(self, device: int, bank: int) -> int:
        """Flat *fabric* bank id of this tenant's logical (device, bank)
        — trace events name physical banks, not logical ones."""
        return self.inner.bank_id(self.device_map[device], bank)

    def submit(self, chan_index: int, device: int, bank: int,
               nbytes: int, sweep: int) -> int:
        return self.inner.submit(self.base + chan_index,
                                 self.device_map[device], bank,
                                 nbytes, sweep, flow=self.flow)


@dataclasses.dataclass
class Tenant:
    """One tenant's admission ticket.

    ``make_binding`` builds a *fresh*
    :class:`~repro_torch.exec.ProgramBinding` per (re-)admission, its
    tensors on the server's device — bindings hold per-run payload
    streams, so reuse across runs is the caller's bug to avoid, not ours.
    Without it the server binds ``inputs`` on its own device.
    ``device_map`` places the design's logical devices on fabric ids.
    """

    name: str
    design: CompiledDesign
    device_map: List[int]
    slo: SLO = dataclasses.field(default_factory=lambda: SLO(1.0))
    make_binding: Optional[Callable[[], Any]] = None
    inputs: Optional[Mapping[str, Any]] = None
    arrival_sweep: int = 0
    checkpoint_dir: Optional[str] = None   # sweep-barrier snapshots land here

    def binding(self, device: Union[None, str, torch.device] = None):
        if self.make_binding is not None:
            return self.make_binding()
        from ..exec import bind_programs
        return bind_programs(self.design.graph, self.inputs, device=device)


@dataclasses.dataclass(frozen=True)
class DeviceKill:
    """Kill fabric device ``device`` at ``sweep`` (injected via
    :class:`~repro_torch.runtime.fault.FailureInjector`); optionally re-compile
    the victims onto their surviving devices and re-admit them.

    ``transient=True`` means the device itself comes back (a process
    crash, not a hardware loss): victims still lose all in-flight work,
    but :func:`~repro_torch.tenants.recover.plan_recovery` may restore them
    from a sweep-barrier snapshot onto the *same* placement instead of
    recompiling onto survivors."""

    device: int
    sweep: int
    readmit: bool = True
    transient: bool = False


@dataclasses.dataclass
class TenantRecord:
    """One tenant incarnation's life inside a server run."""

    name: str
    flow: int
    tenant: Tenant
    state: Optional[ExecutionState]
    status: str = "running"        # running | done | killed | rejected
    start_sweep: int = 0
    end_sweep: Optional[int] = None
    result: Optional[ExecutionResult] = None
    killed_at: Optional[int] = None
    recovered_as: Optional[str] = None
    recovered_via: Optional[str] = None    # "restore" | "recompile" (set on
                                           # the *reborn* incarnation)


@dataclasses.dataclass
class ServeOutcome:
    """Everything one :meth:`TenantServer.run` produced."""

    records: List[TenantRecord]
    sweeps: int
    wall_time_s: float
    conservation: Dict[str, Any]

    def record(self, name: str) -> TenantRecord:
        for r in self.records:
            if r.name == name:
                return r
        raise KeyError(name)

    def latency_s(self, name: str, sweep_time_s: float) -> float:
        r = self.record(name)
        if r.end_sweep is None:
            raise ValueError(f"tenant {name} never finished")
        return (r.end_sweep - r.start_sweep) * sweep_time_s


class TenantServer:
    """Run tenants to completion over one shared transport (+ memory).

    ``mem_config`` switches on the shared bank model; without it every
    tenant takes the ideal memory path (numerics identical either way).
    ``device`` is the one torch device every tenant runs on, resolved once
    (:func:`~repro_torch.exec.resolve_device`: ``cuda`` unless asked).
    """

    def __init__(self, fabric: Fabric, tenants: Sequence[Tenant], *,
                 net_config: Optional[NetConfig] = None,
                 mem_config=None, tracer=None,
                 device: Union[None, str, torch.device] = None):
        if not tenants:
            raise ValueError("need at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.device = resolve_device(device)
        self.fabric = fabric
        self.net_config = net_config or NetConfig()
        # Observability (repro_torch.obs): one tracer spans the shared
        # substrate and every tenant's ExecutionState; each incarnation's
        # events carry its flow id, so per-tenant attribution survives
        # re-admission.
        self.tracer = coerce_tracer(tracer)
        self.transport = FabricTransport(
            fabric, self.net_config,
            flow_weights={i: t.slo.weight for i, t in enumerate(tenants)},
            tracer=self.tracer)
        self.memsys = None
        if mem_config is not None:
            from ..mem.banks import MemorySystem
            self.memsys = MemorySystem(fabric.num_devices, mem_config,
                                       tracer=self.tracer)
        self.records: List[TenantRecord] = []
        self._net_bases: List[int] = []    # per-record global channel base
        self._mem_bases: List[int] = []
        self._next_net_base = 0
        self._next_mem_base = 0
        for t in tenants:
            self._admit(t)

    # -- admission -----------------------------------------------------------
    def _admit(self, tenant: Tenant, *, start_sweep: int = 0,
               recovered_from: Optional[TenantRecord] = None
               ) -> TenantRecord:
        flow = len(self.records)
        if flow not in (self.transport.flow_weights or {}):
            # Re-admissions arrive after construction: extend the arbiter's
            # weight table (plain dict — new flows start clean).
            self.transport.flow_weights[flow] = tenant.slo.weight
        binding = tenant.binding(self.device)
        net_view = FlowTransport(self.transport, flow, self._next_net_base)
        mem_view = None
        if self.memsys is not None and binding.mem_reads:
            mem_view = FlowMemory(self.memsys, flow, self._next_mem_base,
                                  tenant.device_map)
        # mem=None forces the ideal memory path when there is no shared
        # system — a state must never own a memory system the server loop
        # would not step.  With a shared view, mem is not consulted.
        state = ExecutionState(
            tenant.design, binding,
            device=self.device,
            transport=net_view,
            memsys=mem_view,
            mem=None,
            device_map=tenant.device_map,
            tracer=self.tracer,
            trace_flow=flow)
        rec = TenantRecord(name=tenant.name, flow=flow, tenant=tenant,
                           state=state, start_sweep=start_sweep)
        if self.tracer.enabled:
            self.tracer.tenant_admit(start_sweep, flow, tenant.name)
        if recovered_from is not None:
            recovered_from.recovered_as = tenant.name
        self.records.append(rec)
        self._net_bases.append(self._next_net_base)
        self._mem_bases.append(self._next_mem_base)
        self._next_net_base += len(tenant.design.graph.channels)
        self._next_mem_base += len(state.mem_channels)
        return rec

    def _demux(self, bases: List[int], global_index: int) -> tuple:
        """Global channel index → (record index, local index)."""
        for i in range(len(bases) - 1, -1, -1):
            if global_index >= bases[i]:
                return i, global_index - bases[i]
        raise IndexError(global_index)  # pragma: no cover - bases start at 0

    # -- fault handling ------------------------------------------------------
    def _kill(self, kill: DeviceKill, sweep: int) -> List[TenantRecord]:
        """Tear down every running tenant placed on the dead device."""
        victims = [r for r in self.records
                   if r.status == "running"
                   and kill.device in r.tenant.device_map]
        for r in victims:
            self.transport.cancel_flow(r.flow)
            if self.memsys is not None:
                self.memsys.cancel_flow(r.flow)
            r.status = "killed"
            r.killed_at = sweep
            r.state = None             # discard the torn-down execution
            if self.tracer.enabled:
                self.tracer.tenant_cancel(sweep, r.flow, r.name,
                                          f"device_kill:{kill.device}")
        return victims

    def _readmit(self, victim: TenantRecord, kill: DeviceKill,
                 sweep: int) -> TenantRecord:
        """Re-admit the victim under a fresh flow id (accounting of the
        two incarnations must not mix — each flow's conservation identity
        stays exact).  :func:`~repro_torch.tenants.recover.plan_recovery` picks
        the cheap path: restore the same design from its last sweep
        barrier when the kill is transient and a snapshot exists, else
        re-compile onto the surviving devices."""
        from .recover import plan_recovery, recompile
        dead = set() if kill.transient else {kill.device}
        plan = plan_recovery(victim.tenant.device_map, dead,
                             checkpoint_dir=victim.tenant.checkpoint_dir)
        if plan.action == "restore":
            from ..exec.snapshot import load_snapshot, restore_state
            reborn = dataclasses.replace(
                victim.tenant, name=f"{victim.name}+recovered")
            rec = self._admit(reborn, start_sweep=sweep,
                              recovered_from=victim)
            restore_state(rec.state, load_snapshot(
                victim.tenant.checkpoint_dir, plan.step))
            rec.recovered_via = "restore"
            return rec
        if plan.ndev == 0:
            raise DeadlockError(
                f"tenant {victim.name}: no surviving devices to re-admit on")
        # Transient kill without a usable snapshot: the device returns, so
        # the original placement (and design) still fits — re-run from
        # scratch rather than shrinking.
        survivors = [d for d in victim.tenant.device_map
                     if kill.transient or d != kill.device]
        new_design = (victim.tenant.design
                      if len(survivors) == len(victim.tenant.device_map)
                      else recompile(victim.tenant.design, plan.ndev))
        reborn = dataclasses.replace(
            victim.tenant, name=f"{victim.name}+recovered",
            design=new_design, device_map=survivors,
            checkpoint_dir=None)   # old snapshots are of the old placement
        rec = self._admit(reborn, start_sweep=sweep,
                          recovered_from=victim)
        rec.recovered_via = "recompile"
        return rec

    # -- the shared sweep loop -----------------------------------------------
    def run(self, *, faults: Sequence[DeviceKill] = (),
            max_sweeps: Optional[int] = None,
            checkpoint_every: Optional[int] = None,
            monitor=None) -> ServeOutcome:
        """``monitor`` is an optional :class:`repro_torch.obs.slo.SLOMonitor`:
        its ``observe(server, sweep)`` runs once per sweep *inside* the
        serve loop, reading the tracer incrementally and emitting typed
        ``slo_alert`` events into the same trace.  It only ever reads the
        substrate and appends trace events, so a monitored run is
        bit-identical to an unmonitored one (asserted by perf v8)."""
        injector = FailureInjector(
            fail_at_steps=[k.sweep for k in faults])
        kills = {k.sweep: k for k in faults}
        if max_sweeps is None:
            # Tenants share links, so budget the sum of the solo bounds —
            # weighted fairness guarantees every backlogged flow progresses.
            max_sweeps = 256 + sum(r.state.max_sweeps for r in self.records
                                   if r.state is not None)
        t_start = time.perf_counter()
        sweep = 0
        while sweep < max_sweeps:
            try:
                injector.check(sweep)
            except FailureInjector.Injected:
                kill = kills[sweep]
                victims = self._kill(kill, sweep)
                if kill.readmit:
                    for v in victims:
                        reborn = self._readmit(v, kill, sweep)
                        # The recovered incarnation needs sweep budget the
                        # admission-time sum never priced in.
                        max_sweeps += reborn.state.max_sweeps
            fired_total = 0
            for rec in self.records:
                if rec.status != "running" or rec.state is None:
                    continue
                if sweep < rec.start_sweep:
                    continue
                fired_total += rec.state.advance(sweep)
                if rec.state.done:
                    rec.status = "done"
                    rec.end_sweep = sweep
            for mid, gidx in self.transport.step(sweep):
                i, local = self._demux(self._net_bases, gidx)
                rec = self.records[i]
                if rec.state is not None:
                    rec.state.net_deliver(local, mid, sweep)
            if self.memsys is not None:
                for rid, gidx in self.memsys.step(sweep):
                    i, local = self._demux(self._mem_bases, gidx)
                    rec = self.records[i]
                    if rec.state is not None:
                        rec.state.mem_deliver(local, rid, sweep)
            if monitor is not None:
                # Online SLO monitoring: windowed latency / goodput / burn
                # rate per tenant, computed live from the trace the
                # substrate just appended to.
                monitor.observe(self, sweep)
            if checkpoint_every is not None \
                    and (sweep + 1) % checkpoint_every == 0:
                from ..exec.snapshot import save_snapshot
                for rec in self.records:
                    if (rec.status == "running" and rec.state is not None
                            and rec.tenant.checkpoint_dir is not None
                            and sweep >= rec.start_sweep):
                        save_snapshot(rec.state, sweep,
                                      rec.tenant.checkpoint_dir)
                        if self.tracer.enabled:
                            self.tracer.barrier(sweep, f"step_{sweep}",
                                                rec.flow)
            running = [r for r in self.records if r.status == "running"]
            if not running:
                break
            if fired_total == 0 and not any(
                    r.state.has_pending(sweep) for r in running
                    if r.state is not None and sweep >= r.start_sweep):
                if all(sweep < r.start_sweep for r in running):
                    sweep += 1
                    continue       # everything admitted is in the future
                first = next(r for r in running if r.state is not None)
                raise first.state.deadlock(sweep)
            sweep += 1
        running = [r.name for r in self.records if r.status == "running"]
        if running:
            raise DeadlockError(
                f"tenant server exceeded max_sweeps={max_sweeps} with "
                f"{running} still running")

        # Run the shared network / banks dry so every flow's byte
        # accounting is complete before the per-tenant reports are built.
        if self.transport.active:
            for mid, gidx in self.transport.drain(sweep + 1):
                i, local = self._demux(self._net_bases, gidx)
                rec = self.records[i]
                if rec.state is not None:
                    rec.state.net_deliver(local, mid, sweep)
        if self.memsys is not None and self.memsys.active:
            for rid, gidx in self.memsys.drain(sweep + 1):
                i, local = self._demux(self._mem_bases, gidx)
                rec = self.records[i]
                if rec.state is not None:
                    rec.state.mem_deliver(local, rid, sweep)

        wall = time.perf_counter() - t_start
        for rec in self.records:
            if rec.status == "done" and rec.state is not None:
                rec.result = rec.state.build_result(
                    (rec.end_sweep or sweep) + 1 - rec.start_sweep, wall)
        return ServeOutcome(records=self.records, sweeps=sweep + 1,
                            wall_time_s=wall,
                            conservation=self.conservation())

    # -- observability -------------------------------------------------------
    def metrics(self):
        """``tenant.flow.*`` series for every incarnation this server ran
        (:func:`repro_torch.obs.metrics.tenant_metrics`)."""
        from ..obs.metrics import tenant_metrics
        return tenant_metrics(self)

    # -- the exact per-tenant accounting identity ----------------------------
    def conservation(self) -> Dict[str, Any]:
        """Per-link: Σ over flows of flow_bytes == total link bytes, exact
        integers — no tenant's traffic is lost, invented, or misattributed.
        Raises AssertionError on any violation (this is a checked identity,
        not a report)."""
        per_flow_totals: Dict[int, int] = {}
        exact = True
        for c in self.transport.counters:
            flow_sum = sum(c.flow_bytes.values())
            if flow_sum != c.bytes:
                exact = False
            for f, b in c.flow_bytes.items():
                per_flow_totals[f] = per_flow_totals.get(f, 0) + b
        assert exact, "per-tenant link bytes do not sum to link totals"
        total = sum(c.bytes for c in self.transport.counters)
        assert sum(per_flow_totals.values()) == total
        out: Dict[str, Any] = {
            "total_link_bytes": total,
            "per_tenant_link_bytes": {
                rec.name: per_flow_totals.get(rec.flow, 0)
                for rec in self.records},
            "exact": True,
        }
        if self.memsys is not None:
            bank_exact = all(
                sum(c.flow_bytes.values()) == c.bytes
                for c in self.memsys.counters)
            assert bank_exact, "per-tenant bank bytes do not sum to totals"
            out["total_bank_bytes"] = sum(c.bytes
                                          for c in self.memsys.counters)
            out["per_tenant_bank_bytes"] = {
                rec.name: sum(c.flow_bytes.get(rec.flow, 0)
                              for c in self.memsys.counters)
                for rec in self.records}
        return out
