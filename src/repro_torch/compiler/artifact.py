"""`CompiledDesign` — the single immutable artifact produced by
:func:`repro.compiler.compile`.

Bundles everything the hand-wired legacy chain used to scatter across local
variables: the partition, per-device floorplans, the interconnect pipeline
report, the schedule-simulation result, the unit-normalization scales, and
per-pass timing/statistics — plus ``summary()``/``to_json()`` for benchmarks
and dry-run records.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple

from ..core.costmodel import ScheduleResult
from ..core.floorplan import Floorplan
from ..core.graph import TaskGraph
from ..core.partitioner import Partition
from ..core.pipelining import PipelineReport
from ..core.topology import Cluster
from .options import CompileOptions


@dataclasses.dataclass(frozen=True)
class PassRecord:
    """Timing + headline statistics for one executed pass."""

    name: str
    wall_time_s: float
    detail: Mapping[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CompiledDesign:
    """Everything the pipeline decided, in original (un-normalized) units.

    ``graph`` is the caller's graph: the only in-place effect of the whole
    pipeline is the §4.6 FIFO ``depth`` written onto its channels (consumed
    downstream by launch/steps.py), exactly as the legacy chain did.
    """

    graph: TaskGraph
    cluster: Cluster
    options: CompileOptions
    partition: Optional[Partition]
    floorplans: Mapping[int, Floorplan]
    pipeline_report: Optional[PipelineReport]
    schedule: Optional[ScheduleResult]
    # Per-resource-kind power-of-two scale applied for the solvers
    # (area_solver = area / scale); {} or all-1.0 when no scaling was needed.
    unit_scale: Mapping[str, float]
    pass_records: Tuple[PassRecord, ...]
    # Network fabric (repro.net) the design was compiled against, and the
    # congestion_feedback pass's projected per-link traffic.  None when the
    # design was compiled fabric-less (the ideal-transfer execution path).
    # Typed loosely so the compiler stays importable without repro.net.
    fabric: Optional[object] = None          # net.fabric.Fabric
    congestion: Optional[object] = None      # net.congestion.CongestionReport
    # HBM bank model (repro_torch.mem) the design was compiled against, the
    # memory_feedback pass's projected per-bank demand, and the task→bank
    # map it settled on.  None when compiled without a bank model (reads
    # are ideal: every response ready the sweep it is issued).
    mem_config: Optional[object] = None      # mem.banks.MemConfig
    mem_contention: Optional[object] = None  # mem.contention.MemContentionReport
    bank_map: Optional[Mapping[str, int]] = None

    # -- execution ---------------------------------------------------------
    def execute(self, inputs: Optional[Mapping[str, object]] = None, **kw):
        """Run this design on the dataflow executor (``repro_torch.exec``).

        ``inputs`` is the app binding's numeric spec (shapes / iteration
        counts / seeds); remaining keywords pass through to
        :func:`repro_torch.exec.execute`.  Returns an ``ExecutionResult`` whose
        ``report`` compares measured traffic against this design's
        partition/schedule accounting.
        """
        from ..exec import execute as _execute   # deferred: optional layer
        return _execute(self, inputs=inputs, **kw)

    # -- queries -----------------------------------------------------------
    def pass_record(self, name: str) -> Optional[PassRecord]:
        for rec in self.pass_records:
            if rec.name == name:
                return rec
        return None

    def pass_time(self, name: str) -> float:
        rec = self.pass_record(name)
        return rec.wall_time_s if rec else 0.0

    # -- reporting ---------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """JSON-ready digest for benchmarks / dry-run records."""
        out: Dict[str, object] = {
            "graph": {"name": self.graph.name,
                      "tasks": len(self.graph.tasks),
                      "channels": len(self.graph.channels)},
            "num_devices": self.cluster.num_devices,
            "topology": self.cluster.topology.kind,
            "passes": [{"name": r.name,
                        "wall_time_s": round(r.wall_time_s, 4),
                        **{k: v for k, v in r.detail.items()}}
                       for r in self.pass_records],
            "unit_scale": {k: v for k, v in self.unit_scale.items()
                           if v != 1.0},
        }
        if self.partition is not None:
            p = self.partition
            out["partition"] = {
                "comm_cost": p.comm_cost,
                # Same _objective evaluation as comm_cost (invariant checked
                # by the partition pass); exported for perf trending.
                "objective": p.stats.objective,
                "solver_wall_time_s": round(p.stats.wall_time_s, 4),
                "cut_channels": len(p.cut_channels),
                "method": p.stats.method,
                "tasks_per_device": [len(p.device_tasks(d))
                                     for d in range(p.num_devices())],
            }
        if self.floorplans:
            out["floorplans"] = {
                str(d): {"wirelength": fp.wirelength,
                         "congested": fp.congested,
                         "threshold_used": fp.threshold_used,
                         "solver_wall_time_s": round(fp.stats.wall_time_s, 4),
                         "method": fp.stats.method}
                for d, fp in sorted(self.floorplans.items())}
        if self.pipeline_report is not None:
            rep = self.pipeline_report
            out["pipeline"] = {"num_crossings": rep.num_crossings,
                               "max_crossing": rep.max_crossing}
        if self.schedule is not None:
            s = self.schedule
            out["schedule"] = {"makespan_s": s.makespan,
                               "comm_time_s": s.comm_time,
                               "comm_bytes": s.comm_bytes}
        if self.fabric is not None:
            out["net"] = self.fabric.describe()
            if self.congestion is not None:
                out["net"]["projected"] = self.congestion.summary()
        if self.mem_config is not None:
            cfg = self.mem_config
            out["mem"] = {
                "banks_per_device": cfg.banks_per_device,
                "bank_bandwidth_Bps": cfg.bank_bandwidth_Bps,
                "credits": cfg.credits,
                "burst_bytes": cfg.burst_bytes,
            }
            if self.bank_map:
                out["mem"]["bank_map"] = dict(self.bank_map)
            if self.mem_contention is not None:
                out["mem"]["projected"] = self.mem_contention.summary()
        # Observability contract (repro_torch.obs): what a traced execution
        # of this design will emit, and the predicted makespan the
        # critical-path analysis compares against (deferred import — the
        # compiler stays usable without the obs layer loaded).
        from ..obs.trace import EVENT_FIELDS
        out["obs"] = {
            "trace_format": "repro-obs/v1",
            "event_kinds": sorted(EVENT_FIELDS),
            "metric_prefixes": ["exec.task", "exec.device", "exec.channel",
                                "net.link", "mem.bank", "tenant.flow"],
            "predicted_makespan_s": (self.schedule.makespan
                                     if self.schedule is not None else None),
        }
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.summary(), indent=indent, default=float)
