"""Interconnect pipelining + cut-set latency balancing — paper §4.6 (C5).

Latency-insensitive channels let us insert arbitrary pipeline depth on any
channel without changing results; what CAN change is throughput, when
reconvergent paths become unbalanced (one input of a join starves behind a
deeper FIFO).  The paper conservatively registers *every* slot-crossing wire
and then balances reconvergent paths by cut-set pipelining [48].

Here a channel's added latency is its hop count (slot Manhattan distance or
device topology distance); balancing adds buffer depth so that every path
between a reconvergent fork/join pair carries equal added latency.

On TPU, the emitted ``depth`` is consumed by launch/steps.py as the number of
in-flight microbatches on a cross-stage ``ppermute`` channel (double buffering
= depth 2), and the balanced depths guarantee fork/join stages (enc-dec cross
attention, MoE shared+routed branches) never deadlock the pipeline schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .graph import Channel, TaskGraph
from .floorplan import Floorplan
from .partitioner import Partition
from .topology import Cluster


@dataclasses.dataclass
class PipelineReport:
    # channel index -> added pipeline latency (hops/registers)
    added_latency: Dict[int, int]
    # channel index -> final FIFO depth after balancing
    depth: Dict[int, int]
    # per-node max path latency from sources (after balancing all equal-in)
    node_latency: Dict[str, int]
    num_crossings: int
    max_crossing: int


def channel_hops(graph: TaskGraph, ch: Channel,
                 partition: Optional[Partition],
                 floorplans: Optional[Dict[int, Floorplan]],
                 cluster: Optional[Cluster]) -> int:
    """Registers to insert on a channel = inter-device topology distance
    (scaled) + intra-device slot distance (conservative pipelining)."""
    hops = 0
    if partition is not None:
        d1, d2 = partition.assignment[ch.src], partition.assignment[ch.dst]
        if d1 != d2 and cluster is not None:
            # One register stage per topology hop, plus one for the NIC.
            hops += cluster.topology.dist(d1, d2) + 1
        if floorplans is not None:
            if d1 == d2 and d1 in floorplans:
                fp = floorplans[d1]
                hops += fp.grid.dist(fp.slot_of[ch.src], fp.slot_of[ch.dst])
            elif d1 != d2:
                # Crossing leaves via src slot and enters via dst slot.
                if d1 in floorplans:
                    hops += 1
                if d2 in floorplans:
                    hops += 1
    return hops


def pipeline_interconnect(graph: TaskGraph,
                          partition: Optional[Partition] = None,
                          floorplans: Optional[Dict[int, Floorplan]] = None,
                          cluster: Optional[Cluster] = None,
                          min_depth: int = 2,
                          order: Optional[List[str]] = None) -> PipelineReport:
    """Assign per-channel register latency, then balance reconvergent paths.

    Balancing rule (cut-set pipelining): for every node, all incoming paths
    must carry the same total added latency; shortfall on a channel is made
    up with extra FIFO depth (which, unlike registers, is free at runtime —
    it only buffers).  Mutates ``graph`` channel depths in place and returns
    the report.  ``order``: optional precomputed topological order (the
    compiler pipeline memoizes it per compile()).
    """
    if order is None:
        order = graph.topo_order()
    added = {i: channel_hops(graph, c, partition, floorplans, cluster)
             for i, c in enumerate(graph.channels)}
    ch_index = {id(c): i for i, c in enumerate(graph.channels)}

    node_lat: Dict[str, int] = {}
    depth: Dict[int, int] = {}
    for v in order:
        ins = [c for c in graph.in_channels(v) if not c.meta.get("back")]
        if not ins:
            node_lat[v] = 0
            continue
        # Path latency arriving over each input channel.
        arr = {}
        for c in ins:
            i = ch_index[id(c)]
            arr[i] = node_lat[c.src] + added[i]
        lat = max(arr.values())
        node_lat[v] = lat
        # Balance: shallower inputs get extra buffer slots equal to slack.
        for c in ins:
            i = ch_index[id(c)]
            slack = lat - arr[i]
            depth[i] = max(min_depth, added[i] + slack + 1)
            c.depth = depth[i]
    # Back edges / unconstrained channels keep at least min_depth.
    for i, c in enumerate(graph.channels):
        if i not in depth:
            depth[i] = max(min_depth, added[i] + 1)
            c.depth = depth[i]

    crossings = [i for i, c in enumerate(graph.channels)
                 if partition is not None
                 and partition.assignment[c.src] != partition.assignment[c.dst]]
    max_cross = max((added[i] for i in crossings), default=0)
    return PipelineReport(added, depth, node_lat, len(crossings), max_cross)


def verify_balanced(graph: TaskGraph, report: PipelineReport) -> bool:
    """Check the cut-set property: at every join, incoming path latencies
    (added registers, with buffering credited) match."""
    ch_index = {id(c): i for i, c in enumerate(graph.channels)}
    for v in graph.task_names():
        ins = [c for c in graph.in_channels(v) if not c.meta.get("back")]
        if len(ins) < 2:
            continue
        totals = []
        for c in ins:
            i = ch_index[id(c)]
            # Registers on path + buffer slack available on the last hop.
            path = report.node_latency[c.src] + report.added_latency[i]
            buffered = report.depth[i] - 1 - report.added_latency[i]
            totals.append(path + max(0, buffered))
        if max(totals) - min(totals) > max(report.node_latency[v], 0):
            return False
    return True
