"""Task-graph IR — paper §4.1/§4.2 (C1).

A workload is modeled as G(V, E): vertices are compute modules ("tasks") with
per-resource utilization profiles, edges are latency-insensitive FIFO channels
with bit-widths.  On TPU the resource vector is (hbm_bytes, flops,
vmem_bytes); channel width is bytes transferred per step/microbatch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Canonical resource kinds.  FPGA kinds (paper Table 2) and TPU kinds share
# the same machinery — a ResourceProfile is just a name->amount mapping and
# Eq. 1 is applied per name.
FPGA_RESOURCES = ("LUT", "FF", "BRAM", "DSP", "URAM")
TPU_RESOURCES = ("hbm_bytes", "flops", "vmem_bytes")


@dataclasses.dataclass(frozen=True)
class ResourceProfile:
    """Per-task resource utilization (paper: v_area)."""

    amounts: Dict[str, float]

    def __getitem__(self, k: str) -> float:
        return self.amounts.get(k, 0.0)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(self.amounts.keys())

    def __add__(self, other: "ResourceProfile") -> "ResourceProfile":
        out = dict(self.amounts)
        for k, v in other.amounts.items():
            out[k] = out.get(k, 0.0) + v
        return ResourceProfile(out)

    @staticmethod
    def zero() -> "ResourceProfile":
        return ResourceProfile({})


@dataclasses.dataclass
class Task:
    """A compute module (paper: vertex v_i)."""

    name: str
    area: ResourceProfile
    # Estimated busy time in seconds on one reference device at the task's
    # natural parallelism (used by the schedule simulator, not the ILP).
    compute_time: float = 0.0
    # External (HBM) traffic in bytes per invocation — drives the memory
    # roofline term of the cost model.
    hbm_bytes: float = 0.0
    # Arbitrary metadata (layer index, kind, ...).
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Channel:
    """A FIFO channel (paper: edge e_ij with bit-width e.width).

    ``width_bits`` matches the paper's formulation; ``bytes_per_step`` is the
    total payload crossing the channel per step — used for transfer-time
    estimates.  ``depth`` is the buffer depth assigned by the interconnect
    pipeliner (§4.6).
    """

    src: str
    dst: str
    width_bits: int
    bytes_per_step: float = 0.0
    depth: int = 2
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)


class TaskGraph:
    """Directed graph of Tasks connected by Channels."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.tasks: Dict[str, Task] = {}
        self.channels: List[Channel] = []

    # -- construction -----------------------------------------------------
    def add_task(self, task: Task) -> Task:
        if task.name in self.tasks:
            raise ValueError(f"duplicate task {task.name!r}")
        self.tasks[task.name] = task
        return task

    def add_channel(self, src: str, dst: str, width_bits: int,
                    bytes_per_step: float = 0.0, **meta) -> Channel:
        for t in (src, dst):
            if t not in self.tasks:
                raise KeyError(f"unknown task {t!r}")
        ch = Channel(src, dst, width_bits, bytes_per_step, meta=meta)
        self.channels.append(ch)
        return ch

    # -- queries ----------------------------------------------------------
    def task_names(self) -> List[str]:
        return list(self.tasks.keys())

    def successors(self, name: str) -> List[str]:
        return [c.dst for c in self.channels if c.src == name]

    def predecessors(self, name: str) -> List[str]:
        return [c.src for c in self.channels if c.dst == name]

    def in_channels(self, name: str) -> List[Channel]:
        return [c for c in self.channels if c.dst == name]

    def out_channels(self, name: str) -> List[Channel]:
        return [c for c in self.channels if c.src == name]

    def total_area(self) -> ResourceProfile:
        tot = ResourceProfile.zero()
        for t in self.tasks.values():
            tot = tot + t.area
        return tot

    def resource_kinds(self) -> Tuple[str, ...]:
        kinds: List[str] = []
        for t in self.tasks.values():
            for k in t.area.kinds():
                if k not in kinds:
                    kinds.append(k)
        return tuple(kinds)

    def topo_order(self) -> List[str]:
        """Kahn topological order; raises on cycles unless edges marked
        ``back=True`` (PageRank-style dependency cycles, paper Fig. 9)."""
        indeg = {n: 0 for n in self.tasks}
        for c in self.channels:
            if c.meta.get("back"):
                continue
            indeg[c.dst] += 1
        frontier = [n for n, d in indeg.items() if d == 0]
        order: List[str] = []
        while frontier:
            n = frontier.pop()
            order.append(n)
            for c in self.channels:
                if c.meta.get("back") or c.src != n:
                    continue
                indeg[c.dst] -= 1
                if indeg[c.dst] == 0:
                    frontier.append(c.dst)
        if len(order) != len(self.tasks):
            raise ValueError("cycle detected (mark feedback edges back=True)")
        return order

    def validate(self) -> None:
        names = set(self.tasks)
        for c in self.channels:
            assert c.src in names and c.dst in names
            assert c.width_bits > 0
        self.topo_order()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TaskGraph({self.name!r}, {len(self.tasks)} tasks, "
                f"{len(self.channels)} channels)")


def linear_graph(n: int, width_bits: int = 512, area: Optional[dict] = None,
                 name: str = "chain") -> TaskGraph:
    """Convenience: a chain of n identical tasks (stencil-like topology)."""
    g = TaskGraph(name)
    area = area or {"LUT": 1.0}
    for i in range(n):
        g.add_task(Task(f"t{i}", ResourceProfile(dict(area))))
    for i in range(n - 1):
        g.add_channel(f"t{i}", f"t{i+1}", width_bits)
    return g
