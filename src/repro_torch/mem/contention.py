"""Per-bank utilization tracking and the :class:`MemContentionReport`.

Two producers, one record — the same contract as the network layer's
``net.congestion`` (a copy of the JAX package's ``mem/contention.py``):

* :func:`measure` folds a live :class:`~repro_torch.mem.banks.MemorySystem`
  into per-bank measured usage after an execution (bytes, bursts, busy sweeps,
  saturation, queue high-water marks, **achieved** utilization — served
  bursts over offered burst-slots, ≤ 1 by construction);
* :func:`project` evaluates the same per-bank shape **analytically** from
  a partition assignment and a task→bank map: each HBM-reading task's
  declared ``Task.hbm_bytes`` (bytes per invocation) is charged to its
  bank once per step, utilization being demanded bytes per step over the
  bank's service per step (``bank_bandwidth × step_time``, the
  transport's sweep-time base).  This is **offered load** — it can exceed
  1, by the factor the bank would slow the pipeline — and it is what the
  ``memory_feedback`` compiler pass consumes: it needs a contention
  estimate *before* anything executes.

``hotspots(threshold)`` names the banks a re-map (or a membound
repartition) must off-load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.graph import TaskGraph
from .banks import MemConfig, MemorySystem


@dataclasses.dataclass(frozen=True)
class BankUsage:
    """One bank's usage — measured (executor) or projected (compiler)."""

    device: int
    bank: int                      # bank index within the device
    name: str                      # "dev0/bank3"
    bytes: float                   # payload bytes served (or demanded/step)
    utilization: float             # achieved (<=1) or offered (can exceed 1)
    bursts: int = 0                # measured only
    busy_sweeps: int = 0           # measured only
    saturated_sweeps: int = 0      # measured only (budget exhausted, queued)
    peak_queue_bursts: int = 0     # measured only
    requests: int = 0              # measured only
    tasks: Tuple[str, ...] = ()    # projected only: tasks mapped here

    def to_json(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["tasks"] = list(self.tasks)
        return d


@dataclasses.dataclass(frozen=True)
class MemContentionReport:
    """Per-bank usage + aggregates for one execution or one projection."""

    kind: str                      # "measured" | "projected"
    banks: List[BankUsage]
    sweeps: int                    # measured: memsys sweeps; projected: 0
    total_bytes: float             # Σ per-bank bytes

    @property
    def max_utilization(self) -> float:
        return max((b.utilization for b in self.banks), default=0.0)

    def hotspots(self, threshold: float) -> List[BankUsage]:
        """Banks over the utilization threshold, hottest first."""
        return sorted((b for b in self.banks if b.utilization > threshold),
                      key=lambda b: -b.utilization)

    def bank(self, device: int, bank: int) -> BankUsage:
        for b in self.banks:
            if b.device == device and b.bank == bank:
                return b
        raise KeyError((device, bank))

    def summary(self) -> Dict[str, object]:
        return {
            "kind": self.kind,
            "sweeps": self.sweeps,
            "total_bank_bytes": self.total_bytes,
            "max_utilization": self.max_utilization,
            "banks": [b.to_json() for b in self.banks],
        }


def measure(memsys: MemorySystem,
            flow: Optional[int] = None) -> MemContentionReport:
    """Measured per-bank usage from a (drained) memory system.

    With ``flow`` set, only that tenant flow's bursts/bytes are reported
    (utilization becomes the flow's achieved share); the bank-global
    contention counters are omitted, mirroring the per-flow network view.
    """
    bpd = memsys.config.banks_per_device
    if flow is None:
        banks = [BankUsage(
            device=bid // bpd, bank=bid % bpd,
            name=f"dev{bid // bpd}/bank{bid % bpd}",
            bytes=float(c.bytes), utilization=memsys.utilization(bid),
            bursts=c.bursts, busy_sweeps=c.busy_sweeps,
            saturated_sweeps=c.saturated_sweeps,
            peak_queue_bursts=c.peak_queue_bursts, requests=c.requests)
            for bid, c in enumerate(memsys.counters)]
    else:
        banks = [BankUsage(
            device=bid // bpd, bank=bid % bpd,
            name=f"dev{bid // bpd}/bank{bid % bpd}",
            bytes=float(c.flow_bytes.get(flow, 0)),
            utilization=memsys.utilization(bid, flow),
            bursts=c.flow_bursts.get(flow, 0))
            for bid, c in enumerate(memsys.counters)]
    return MemContentionReport(
        kind="measured" if flow is None else f"measured/flow{flow}",
        banks=banks, sweeps=memsys.sweeps_run,
        total_bytes=float(sum(b.bytes for b in banks)))


def default_bank_map(graph: TaskGraph, assignment: Dict[str, int],
                     config: MemConfig) -> Dict[str, int]:
    """Deterministic task→bank map: honor a declared ``meta["hbm_bank"]``,
    else round-robin the device's HBM readers over its banks in graph
    order.  Only tasks with ``hbm_bytes > 0`` read memory."""
    out: Dict[str, int] = {}
    next_bank: Dict[int, int] = {}
    for name, task in graph.tasks.items():
        if task.hbm_bytes <= 0:
            continue
        dev = assignment[name]
        declared = task.meta.get("hbm_bank")
        if declared is not None:
            out[name] = int(declared) % config.banks_per_device
        else:
            b = next_bank.get(dev, 0)
            out[name] = b
            next_bank[dev] = (b + 1) % config.banks_per_device
    return out


def project(graph: TaskGraph, assignment: Dict[str, int],
            config: MemConfig, *,
            bank_map: Optional[Dict[str, int]] = None,
            step_time_s: Optional[float] = None) -> MemContentionReport:
    """Analytic per-bank demand for a partition assignment + bank map.

    Each HBM-reading task demands ``Task.hbm_bytes`` from its bank once
    per step; a bank serves ``bank_bandwidth × step_time`` bytes per step
    (``step_time_s`` defaults to the transport's sweep-time base).  The
    result is *offered load*: > 1 means the tasks ask more of the bank
    than one step can serve — the executor slows down by that factor on
    the hot bank (the *measured* utilization, by contrast, saturates at 1).
    """
    if step_time_s is None:
        step_time_s = config.sweep_time_s
    if bank_map is None:
        bank_map = default_bank_map(graph, assignment, config)
    ndev = max(assignment.values(), default=0) + 1
    bpd = config.banks_per_device
    demand = [0.0] * (ndev * bpd)
    tasks: List[List[str]] = [[] for _ in range(ndev * bpd)]
    for name, task in graph.tasks.items():
        if task.hbm_bytes <= 0:
            continue
        bid = assignment[name] * bpd + bank_map.get(name, 0) % bpd
        demand[bid] += float(task.hbm_bytes)
        tasks[bid].append(name)
    service = config.bank_bandwidth_Bps * step_time_s
    banks = [BankUsage(
        device=bid // bpd, bank=bid % bpd,
        name=f"dev{bid // bpd}/bank{bid % bpd}",
        bytes=demand[bid], utilization=demand[bid] / service,
        tasks=tuple(tasks[bid]))
        for bid in range(ndev * bpd)]
    return MemContentionReport(
        kind="projected", banks=banks, sweeps=0,
        total_bytes=float(sum(demand)))
