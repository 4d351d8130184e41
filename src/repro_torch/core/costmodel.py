"""Analytic cost model + schedule simulator — paper §5 evaluation substrate.

Because this container has no FPGA/TPU, the paper's latency/frequency tables
are reproduced through a calibrated analytical model — the *same* model the
partitioner uses to make placement decisions, so the reproduction and the
tool share one source of truth.

Model pieces
------------
1. Frequency estimator: HLS designs lose frequency to (a) unpipelined
   slot/die crossings and (b) congestion (slot utilization above threshold).
   TAPA-CS pipelines every crossing and floorplans below threshold, so it
   achieves device fmax; baselines suffer derates calibrated on the paper's
   own reported numbers (§5.2–§5.5).
2. Task time: max(compute cycles / freq, hbm_bytes / effective HBM bw-share)
   — the classic two-term roofline per task.
3. Schedule simulator: event-driven over the task graph; inter-device
   channels add transfer time = volume/protocol-bw + RTT, optionally
   overlapped with compute (TAPA-CS streams through latency-insensitive
   FIFOs; baselines serialize).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import Channel, TaskGraph
from .partitioner import Partition
from .topology import Cluster, DeviceSpec, Protocol


@dataclasses.dataclass
class FreqModel:
    """Frequency derate model, calibrated once against §5 reports.

    freq = fmax / (1 + alpha*crossing_exposure + beta*congestion_excess)

    crossing_exposure: fraction of channels crossing slot/die boundaries
    without pipeline registers (0 for TAPA/TAPA-CS designs).
    congestion_excess: max over slots of (util - threshold)+ / threshold
    (0 when the floorplanner kept every slot under threshold).
    """

    alpha: float = 1.2
    beta: float = 1.5
    threshold: float = 0.70

    def estimate(self, device: DeviceSpec, crossing_exposure: float,
                 max_slot_util: float) -> float:
        excess = max(0.0, max_slot_util - self.threshold) / self.threshold
        derate = 1.0 + self.alpha * crossing_exposure + self.beta * excess
        return device.max_freq_hz / derate


@dataclasses.dataclass
class TaskTiming:
    start: float
    finish: float
    compute: float
    memory: float
    wait: float


@dataclasses.dataclass
class ScheduleResult:
    makespan: float
    timings: Dict[str, TaskTiming]
    device_busy: Dict[int, float]
    comm_time: float
    comm_bytes: float

    def device_idle_frac(self, d: int) -> float:
        if self.makespan == 0:
            return 0.0
        return 1.0 - self.device_busy.get(d, 0.0) / self.makespan


def task_time(graph: TaskGraph, name: str, freq_hz: float,
              device: DeviceSpec, bw_share: float,
              hbm_efficiency: float = 1.0) -> Tuple[float, float]:
    """(compute_time, memory_time) for one task.

    ``compute_time`` fields on tasks are stored in *cycles-at-fmax* units
    when meta['cycles'] is set, else seconds directly.
    """
    t = graph.tasks[name]
    cycles = t.meta.get("cycles")
    if cycles is not None:
        comp = float(cycles) / freq_hz
    else:
        comp = t.compute_time * (device.max_freq_hz / freq_hz
                                 if device.max_freq_hz and freq_hz else 1.0)
    bw = device.hbm_bandwidth * max(bw_share, 1e-12) * hbm_efficiency
    mem = t.hbm_bytes / bw if t.hbm_bytes else 0.0
    return comp, mem


def transfer_time(ch: Channel, cluster: Cluster, d1: int, d2: int) -> float:
    if d1 == d2:
        return 0.0
    proto = cluster.protocol_between(d1, d2)
    hops = max(1, cluster.topology.dist(d1, d2))
    vol = ch.bytes_per_step or (ch.width_bits / 8.0)
    # Inter-node paths stage through host memory (paper §5.7): dev→host,
    # host→host (slow link), host→dev — modeled as 3× volume over the
    # bottleneck link plus RTT per hop.
    stages = 3.0 if cluster.node_of(d1) != cluster.node_of(d2) else 1.0
    return stages * vol / proto.bandwidth_Bps + hops * proto.latency_s


def simulate(graph: TaskGraph, partition: Partition, cluster: Cluster,
             freq_hz: Dict[int, float], *,
             overlap: bool = True,
             hbm_efficiency: float = 1.0,
             order: Optional[List[str]] = None) -> ScheduleResult:
    """Event-driven simulation of the partitioned dataflow graph.

    overlap=True models TAPA-CS streaming (transfer overlapped with the
    producer's compute — consumer waits for max(producer, transfer) from the
    producer's *start*); overlap=False serializes transfer after the producer
    finishes (host-orchestrated baseline behaviour).  ``order``: optional
    precomputed topological order (memoized by the compiler pipeline).
    """
    if order is None:
        order = graph.topo_order()
    assign = partition.assignment
    # Concurrent HBM readers per device → bandwidth share (paper §3: PEs
    # sharing channels see per-PE bandwidth collapse).
    hbm_tasks_per_dev: Dict[int, int] = {}
    for v in order:
        if graph.tasks[v].hbm_bytes:
            d = assign[v]
            hbm_tasks_per_dev[d] = hbm_tasks_per_dev.get(d, 0) + 1

    timings: Dict[str, TaskTiming] = {}
    busy: Dict[int, float] = {d: 0.0 for d in set(assign.values())}
    comm_t = 0.0
    comm_b = 0.0
    for v in order:
        d = assign[v]
        share = 1.0 / max(1, hbm_tasks_per_dev.get(d, 1))
        comp, mem = task_time(graph, v, freq_hz.get(d, 1.0), cluster.device,
                              share, hbm_efficiency)
        dur = max(comp, mem)
        ready = 0.0
        for ch in graph.in_channels(v):
            if ch.meta.get("back"):
                continue
            u = ch.src
            tt = transfer_time(ch, cluster, assign[u], assign[v])
            if tt:
                comm_t += tt
                comm_b += ch.bytes_per_step or ch.width_bits / 8.0
            if overlap and tt:
                # Streaming: consumer can start once the pipe is primed; the
                # transfer rate-limits the consumer instead of serializing.
                arr = max(timings[u].finish,
                          timings[u].start + tt)
                dur = max(dur, tt)
            else:
                arr = timings[u].finish + tt
            ready = max(ready, arr)
        timings[v] = TaskTiming(ready, ready + dur, comp, mem, ready)
        busy[d] = busy.get(d, 0.0) + dur
    makespan = max((t.finish for t in timings.values()), default=0.0)
    return ScheduleResult(makespan, timings, busy, comm_t, comm_b)


# ---------------------------------------------------------------------------
# TPU roofline terms (assignment §ROOFLINE) — shared constants.
# ---------------------------------------------------------------------------

TPU_PEAK_FLOPS = 197e12          # bf16 / chip
TPU_HBM_BW = 819e9               # bytes/s / chip
TPU_ICI_BW = 50e9                # bytes/s / link
TPU_DCN_BW = 6.25e9              # bytes/s / chip pair (pod-to-pod)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, ici_bytes: float,
             dcn_bytes: float, chips: int,
             peak_flops: float = TPU_PEAK_FLOPS,
             hbm_bw: float = TPU_HBM_BW,
             ici_bw: float = TPU_ICI_BW,
             dcn_bw: float = TPU_DCN_BW) -> RooflineTerms:
    """Three-term roofline from compiled-HLO statistics.

    flops/bytes from cost_analysis are per-device-program totals under SPMD
    (already per-chip); collective bytes are summed operand sizes per chip.
    """
    compute = hlo_flops / peak_flops
    memory = hlo_bytes / hbm_bw
    coll = ici_bytes / ici_bw + dcn_bytes / dcn_bw
    return RooflineTerms(compute, memory, coll)
