"""The dataflow executor — runs a :class:`CompiledDesign` end to end.

Execution model (synchronous dataflow, one sweep ≈ one pipeline clock):

* Every task fires ``iterations`` times.  A task may fire in a sweep when
  every in-channel (back edges included — those carry the iteration
  dependency and are seeded by ``ProgramBinding.prime``) has a *visible*
  token and every out-channel has a free slot.
* Tasks are processed in **reverse topological order** within a sweep, so a
  consumer's pop frees its FIFO slot before the producer's push is
  considered — the software equivalent of simultaneous push+pop on a full
  hardware FIFO.  Tokens pushed in sweep *t* become visible at
  ``t + latency``, so data still advances at most one task per sweep.
* Channel capacity comes from the §4.6 balanced ``depth`` on the graph
  channel; channel latency from the pipeline report's ``added_latency``.
  With balanced depths every task fires every sweep once the pipeline fills
  (full throughput); clamp a depth below ``added + slack + 1`` and the
  reconvergent join starves — which the detector below reports instead of
  silently throttling.

Device: one explicit ``torch.device``.  The default is ``cuda`` — the task
bodies then launch the hand-written kernels of :mod:`repro_torch.kernels`;
the CPU (the kernels' plain PyTorch versions) is used only when the caller
passes ``device="cpu"``, and with no card and no ``device=`` the executor
raises.  Every logical device of the partition maps onto that one device;
the logical placement still drives the traffic accounting (which channels
cross devices, their measured bytes, the Eq. 2 agreement).  After each
firing the executor synchronizes the device, so ``busy_s`` is the firing's
device time, not its enqueue time.

Memory: a binding's ``mem_reads`` streams become
:class:`~repro_torch.mem.channels.AsyncMemChannel` s on the task's logical
device and its compiled (or default) bank.  With a bank model
(``mem=``, default the design's ``MemConfig``) the host-side
:class:`~repro_torch.mem.banks.MemorySystem` decides when each response
arrives; with ``mem=None`` every response is there at once (the ideal
path).  Either way the payloads are the binding's own tensors, so both
paths compute the same bits.

The network fabric (``fabric=``), tenant sharing and snapshots belong to
layers that are not yet ported; asking for the fabric raises
:class:`NotImplementedError`.

Detection:

* **Hard deadlock** — a sweep fires nothing, and no queued token will ever
  become visible.  Raises :class:`DeadlockError` listing each unfinished
  task with the channel that blocks it.
* **FIFO starvation** — a join cannot fire because one in-channel is empty
  while a sibling in-channel sits *at capacity*: the signature of an
  unbalanced cut-set (§4.6).  Transient during pipeline fill never matches
  (balanced depths leave headroom); persistent imbalance accumulates events
  until ``starve_limit`` trips :class:`StarvationError` with the channel
  that needs more depth.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from ..compiler.artifact import CompiledDesign
from ..obs.trace import coerce_tracer
from .channels import FifoChannel
from .programs import (SOURCE_KEY, ProgramBinding, RoutedOutput,
                       bind_programs, resolve_device)
from .report import ExecutionReport, build_report


class DeadlockError(RuntimeError):
    """No task can ever fire again, yet the run is incomplete."""


class StarvationError(DeadlockError):
    """A join repeatedly starves behind an unbalanced FIFO (§4.6)."""


#: Sentinel for ``execute(fabric=...)`` / ``execute(mem=...)``: use the
#: design's setting.
FROM_DESIGN = object()


@dataclasses.dataclass
class ExecutionResult:
    """What came out of the pipe, plus the measured execution report."""

    outputs: Any                          # binding.finalize(...) result
    sink_outputs: Dict[str, List[Any]]    # raw per-firing sink values
    report: ExecutionReport


def _block(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ExecutionState:
    """One design's live execution — fire-a-sweep-at-a-time state machine.

    Owns everything per-design: the FIFO channels, firing counts and the
    starvation tallies.  :meth:`advance` fires one sweep; :meth:`run`
    drives the state to completion.
    """

    def __init__(self, design: CompiledDesign,
                 binding: Optional[ProgramBinding] = None, *,
                 inputs: Optional[Mapping[str, Any]] = None,
                 device: Union[None, str, torch.device] = None,
                 max_sweeps: Optional[int] = None,
                 starve_limit: int = 3,
                 check_starvation: bool = True,
                 fabric: Any = FROM_DESIGN,
                 mem: Any = FROM_DESIGN,
                 tracer: Any = None):
        if design.partition is None:
            raise ValueError("execute() needs a partitioned design "
                             "(run the partition pass)")
        if fabric is FROM_DESIGN:
            fabric = design.fabric
        if fabric is not None:
            raise NotImplementedError(
                "the fabric transfer path needs repro_torch.net, which is "
                "not yet ported: pass fabric=None for the ideal path")
        self.device = resolve_device(device)
        if binding is None:
            binding = bind_programs(design.graph, inputs,
                                    device=self.device)
        self.design = design
        self.binding = binding
        self.tracer = coerce_tracer(tracer)
        graph, assign = design.graph, design.partition.assignment
        self.graph, self.assign = graph, assign
        rep = design.pipeline_report

        self.channels: List[FifoChannel] = []
        for i, ch in enumerate(graph.channels):
            latency = 1 + (rep.added_latency.get(i, 0)
                           if rep is not None else 0)
            self.channels.append(FifoChannel(
                i, ch, assign[ch.src], assign[ch.dst], latency=latency,
                dst_device=self.device, tracer=self.tracer))
        for i, token in binding.prime.items():
            self.channels[i].prime(token)

        self.in_chs: Dict[str, List[FifoChannel]] = {t: [] for t in
                                                     graph.tasks}
        self.out_chs: Dict[str, List[FifoChannel]] = {t: [] for t in
                                                      graph.tasks}
        for fc in self.channels:
            if any(prev.src == fc.src for prev in self.in_chs[fc.dst]):
                # token_in is keyed by predecessor name — a second channel
                # from the same producer would silently overwrite the
                # first's token.
                raise ValueError(
                    f"parallel channels {fc.src}->{fc.dst}: the executor "
                    "delivers one token per predecessor; merge the payloads "
                    "into one channel (tokens are arbitrary pytrees)")
            self.in_chs[fc.dst].append(fc)
            self.out_chs[fc.src].append(fc)
        # Sinks: no forward (non-back) out-channel — their firing values
        # are the pipeline's results (back edges recirculate, they don't
        # leave the pipe).
        self.sinks = [t for t in graph.tasks
                      if not any(not fc.is_back for fc in self.out_chs[t])]

        self.iterations = T = binding.iterations

        # Async memory channels (repro_torch.mem) — one per declared
        # mem_reads stream, placed on the task's logical device and its
        # compiled (or default) bank.  memsys None is the ideal path: same
        # channels, immediate responses.
        mem_config = design.mem_config if mem is FROM_DESIGN else mem
        self.mem_channels: List[Any] = []
        self.mem_chs: Dict[str, List[Any]] = {t: [] for t in graph.tasks}
        memsys = None
        if binding.mem_reads:
            # Deferred: repro_torch.mem imports exec.channels.
            from ..mem.banks import MemorySystem
            from ..mem.channels import AsyncMemChannel
            from ..mem.contention import default_bank_map
            bank_map = dict(design.bank_map or {})
            if mem_config is not None:
                memsys = MemorySystem(design.partition.num_devices(),
                                      mem_config, tracer=self.tracer)
                if not bank_map:
                    bank_map = default_bank_map(graph, assign, mem_config)
            for task in sorted(binding.mem_reads):
                for stream in sorted(binding.mem_reads[task]):
                    mc = AsyncMemChannel(
                        len(self.mem_channels), task, stream,
                        binding.mem_reads[task][stream], T,
                        device=assign[task], bank=bank_map.get(task, 0),
                        memsys=memsys, tracer=self.tracer)
                    self.mem_channels.append(mc)
                    self.mem_chs[task].append(mc)
        self.memsys = memsys

        self.order = list(reversed(graph.topo_order()))
        max_lat = max((fc.latency for fc in self.channels), default=1)
        if max_sweeps is None:
            # Pipeline depth is bounded by tasks × max latency; each of the
            # T firings advances at least one task per sweep barring
            # throttling.
            max_sweeps = 64 + 4 * (T + len(graph.tasks)) * (1 + max_lat)
            if memsys is not None:
                # Banks serve >= 1 burst per sweep while queued, so the
                # total burst demand bounds the extra memory-induced sweeps.
                max_sweeps += 256 + 4 * sum(mc.total_bursts()
                                            for mc in self.mem_channels)
        self.max_sweeps = max_sweeps
        self.starve_limit = starve_limit
        self.check_starvation = check_starvation

        self.fired: Dict[str, int] = {t: 0 for t in graph.tasks}
        self.starve_events: Dict[str, int] = {}
        self.starve_detail: List[Dict[str, Any]] = []
        self.mem_waits: Dict[str, int] = {}
        self.mem_model_s = 0.0          # host time in the bank model
        self.sink_outputs: Dict[str, List[Any]] = {t: [] for t in self.sinks}
        self.busy_s: Dict[int, float] = {}
        self.dev_fired: Dict[int, int] = {}
        self.sweeps_done = 0

    # -- progress queries ----------------------------------------------------
    @property
    def done(self) -> bool:
        return all(n >= self.iterations for n in self.fired.values())

    @property
    def total_firings(self) -> int:
        return self.iterations * len(self.graph.tasks)

    @property
    def firings(self) -> int:
        return sum(self.fired.values())

    def has_pending(self, sweep: int) -> bool:
        """Progress is still coming without any task firing: a token is
        ripening in a FIFO, a response in the reorder window, or a request
        is in the bank pipe."""
        if any(vis > sweep for fc in self.channels
               for vis in fc.pending_visibility()):
            return True
        if any(vis > sweep for mc in self.mem_channels
               for vis in mc.pending_visibility()):
            return True
        return self.memsys is not None and self.memsys.active

    def blockers(self, task: str, sweep: int) -> List[str]:
        why = []
        for fc in self.in_chs[task]:
            if not fc.head_visible(sweep):
                why.append(f"input {fc.src}->{task} empty "
                           f"(occupancy {fc.occupancy}/{fc.capacity})")
        for fc in self.out_chs[task]:
            if fc.full:
                why.append(f"output {task}->{fc.dst} full "
                           f"(depth {fc.capacity})")
        for mc in self.mem_chs[task]:
            if mc.stats.consumed < mc.count and not mc.response_ready(sweep):
                why.append(f"memory {task}.{mc.stream} response pending "
                           f"({mc.stats.consumed}/{mc.count} consumed, "
                           f"{mc.outstanding} outstanding)")
        return why

    def deadlock(self, sweep: int) -> DeadlockError:
        lines = [f"  {t} ({self.fired[t]}/{self.iterations} firings): " +
                 ("; ".join(self.blockers(t, sweep)) or "unknown")
                 for t in self.graph.tasks
                 if self.fired[t] < self.iterations]
        return DeadlockError(
            "dataflow deadlock at sweep %d — no task can fire and "
            "no token is in flight:\n%s" % (sweep, "\n".join(lines)))

    def mem_deliver(self, chan_index: int, rid: int, sweep: int) -> None:
        self.mem_channels[chan_index].on_complete(rid, sweep)

    # -- one sweep of task firing --------------------------------------------
    def advance(self, sweep: int) -> int:
        """Fire every ready task once (reverse topo order); returns the
        firing count.  Does not step the memory system — :meth:`run`
        does, after the firings."""
        binding, T = self.binding, self.iterations
        tr, flow = self.tracer, 0        # flow 0: one design per run
        fired_this_sweep = 0
        t0 = time.perf_counter()
        for mc in self.mem_channels:
            # Issue reads ahead of consumption, up to the credit bound —
            # the multiple-outstanding-transactions loop of async_mmap.
            mc.pump(sweep)
        if self.memsys is not None:
            self.mem_model_s += time.perf_counter() - t0
        for v in self.order:
            if self.fired[v] >= T:
                continue
            in_chs, out_chs = self.in_chs[v], self.out_chs[v]
            ready = all(fc.head_visible(sweep) for fc in in_chs)
            space = all(not fc.full for fc in out_chs)
            if not (ready and space):
                if in_chs:
                    empty = [fc for fc in in_chs
                             if not fc.head_visible(sweep)]
                    at_cap = [fc for fc in in_chs if fc.full]
                    if empty and at_cap:
                        # A bounded FIFO may transiently saturate while the
                        # pipeline fills (bounded by the paths' hop-count
                        # difference) — only persistence past starve_limit
                        # is the unbalanced-cut-set signature.
                        self.starve_events[v] = \
                            self.starve_events.get(v, 0) + 1
                        if tr.enabled:
                            tr.task_wait(sweep, v, self.assign[v],
                                         "starve", flow)
                        self.starve_detail.append({
                            "sweep": sweep, "task": v,
                            "starved_input": f"{empty[0].src}->{v}",
                            "full_input": f"{at_cap[0].src}->{v}",
                            "full_depth": at_cap[0].capacity})
                        if (self.check_starvation
                                and self.starve_events[v]
                                >= self.starve_limit):
                            d = self.starve_detail[-1]
                            raise StarvationError(
                                f"join {v!r} starved "
                                f"{self.starve_events[v]}x on "
                                f"{d['starved_input']} while sibling FIFO "
                                f"{d['full_input']} sat full at depth "
                                f"{d['full_depth']}: unbalanced cut-set — "
                                f"§4.6 balancing would deepen "
                                f"{d['full_input']} (run the "
                                f"pipeline_interconnect pass or raise "
                                f"min_depth)")
                        continue
                    if tr.enabled:
                        tr.task_wait(sweep, v, self.assign[v],
                                     "upstream" if empty else "backpressure",
                                     flow)
                    continue
                if tr.enabled and not space:
                    # A source task (no in-channels) blocked on a full
                    # output FIFO.
                    tr.task_wait(sweep, v, self.assign[v], "backpressure",
                                 flow)
                continue
            if self.mem_chs[v] and not all(mc.response_ready(sweep)
                                           for mc in self.mem_chs[v]):
                # The graph is ready but a memory response is still in the
                # bank pipe — read_data.empty() on the async_mmap side.
                self.mem_waits[v] = self.mem_waits.get(v, 0) + 1
                if tr.enabled:
                    tr.task_wait(sweep, v, self.assign[v], "mem", flow)
                continue
            token_in: Dict[str, Any] = {fc.src: fc.pop(sweep)
                                        for fc in in_chs}
            if not in_chs and v in binding.source_inputs:
                token_in[SOURCE_KEY] = binding.source_inputs[v][self.fired[v]]
            for mc in self.mem_chs[v]:
                token_in[mc.stream] = mc.consume(sweep)
            dev = self.assign[v]
            t0 = time.perf_counter()
            out = binding.programs[v](token_in)
            _block(self.device)
            busy = time.perf_counter() - t0
            self.busy_s[dev] = self.busy_s.get(dev, 0.0) + busy
            self.dev_fired[dev] = self.dev_fired.get(dev, 0) + 1
            if tr.enabled:
                tr.task_fire(sweep, v, dev, busy, flow)
            if isinstance(out, RoutedOutput):
                for fc in out_chs:
                    fc.push(out[fc.dst], sweep)
            else:
                for fc in out_chs:
                    fc.push(out, sweep)
            if v in self.sinks:
                self.sink_outputs[v].append(out)
            self.fired[v] += 1
            fired_this_sweep += 1
        self.sweeps_done = max(self.sweeps_done, sweep + 1)
        return fired_this_sweep

    # -- wrap-up -------------------------------------------------------------
    def build_result(self, sweeps: int, wall_time_s: float
                     ) -> ExecutionResult:
        """Fold the state into the measured report + finalized outputs."""
        report = build_report(
            design=self.design, channels=self.channels,
            iterations=self.iterations, sweeps=sweeps,
            wall_time_s=wall_time_s, device_busy_s=self.busy_s,
            device_fired=self.dev_fired,
            starvation_events=self.starve_events,
            starvation_detail=self.starve_detail, memsys=self.memsys,
            mem_channels=self.mem_channels, mem_waits=self.mem_waits,
            mem_model_s=self.mem_model_s, tracer=self.tracer)
        outputs = (self.binding.finalize(self.sink_outputs)
                   if self.binding.finalize is not None
                   else self.sink_outputs)
        return ExecutionResult(outputs=outputs,
                               sink_outputs=self.sink_outputs,
                               report=report)

    # -- the solo loop -------------------------------------------------------
    def run(self) -> ExecutionResult:
        """Drive this state to completion, stepping the bank model."""
        memsys = self.memsys
        t_start = time.perf_counter()
        sweep, done = 0, False
        while sweep < self.max_sweeps:
            fired_this_sweep = self.advance(sweep)
            if memsys is not None:
                t0 = time.perf_counter()
                for rid, ch_index in memsys.step(sweep):
                    self.mem_deliver(ch_index, rid, sweep)
                self.mem_model_s += time.perf_counter() - t0
            done = self.done
            if done:
                break
            if fired_this_sweep == 0 and not self.has_pending(sweep):
                # Tokens still ripening are progress; a silent sweep
                # without any is a cycle of blocked tasks — diagnose it.
                raise self.deadlock(sweep)
            sweep += 1
        if not done:
            raise DeadlockError(
                f"executor exceeded max_sweeps={self.max_sweeps} "
                f"(fired {self.firings} of {self.total_firings} "
                f"firings) — throughput collapse; check FIFO depths")
        if memsys is not None and memsys.active:
            # Every firing consumed its response, so the banks are normally
            # dry here — drain defensively so Σ bank bytes == Σ channel
            # bytes holds even if a program under-consumed.
            for rid, ch_index in memsys.drain(sweep + 1):
                self.mem_deliver(ch_index, rid, sweep)
        wall = time.perf_counter() - t_start
        return self.build_result(sweep + 1, wall)


def execute(design: CompiledDesign,
            binding: Optional[ProgramBinding] = None, *,
            inputs: Optional[Mapping[str, Any]] = None,
            device: Union[None, str, torch.device] = None,
            max_sweeps: Optional[int] = None,
            starve_limit: int = 3,
            check_starvation: bool = True,
            fabric: Any = FROM_DESIGN,
            mem: Any = FROM_DESIGN,
            tracer: Any = None) -> ExecutionResult:
    """Run ``design`` as a dataflow program on one torch device.

    ``binding`` defaults to the app hook resolved from the graph's name
    (``bind_programs(design.graph, inputs, device=...)``); ``inputs`` is
    that hook's numeric spec (shapes / iteration counts / seeds).
    ``device`` is the one device every logical device maps onto: ``cuda``
    by default, ``"cpu"`` only when asked.  A caller-supplied ``binding``
    must already hold its tensors on that device.  ``fabric`` defaults to
    the design's fabric and must resolve to None in this slice (the ideal
    transfer path).  ``mem`` defaults to the design's bank model
    (``CompileOptions.mem``); pass ``mem=None`` for the ideal memory path
    or a :class:`~repro_torch.mem.banks.MemConfig` to override.
    ``tracer`` is any object with the
    :class:`~repro_torch.obs.trace.NullTracer` methods (None → the no-op
    tracer).
    """
    return ExecutionState(
        design, binding, inputs=inputs, device=device,
        max_sweeps=max_sweeps, starve_limit=starve_limit,
        check_starvation=check_starvation, fabric=fabric, mem=mem,
        tracer=tracer).run()
