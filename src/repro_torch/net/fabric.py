"""Physical link graph + deterministic routing — the network fabric.

The compiler's Eq. 2/§4.3 cost model treats the interconnect as a distance
metric; the executor (before this package) moved every inter-device payload
as an ideal point-to-point transfer.  A :class:`Fabric` makes the network
*physical*: every :class:`~repro_torch.core.topology.Topology` is lowered to an
explicit set of directed :class:`Link`\\ s (each carrying a
:class:`~repro_torch.core.topology.Protocol` bandwidth/latency), and a logical
channel between two devices becomes a deterministic shortest-path **route**
— a sequence of link ids — so two channels crossing the same physical link
genuinely share it (see :mod:`repro_torch.net.transport` for the arbitration).

Link derivation per topology kind:

* daisy-chain / ring — cables between consecutive devices (ring wraps);
* star — spokes to the hub (device 0), spoke↔spoke routes transit the hub;
* mesh2d / torus — grid-neighbor cables, wraparound cables when ``torus``;
* hypercube — one cable per bit-flip neighbor pair;
* bus — ONE shared medium every transfer arbitrates for (the canonical
  hot-spot topology; ``Topology.shared_medium``).

Every physical cable is full duplex: two directed links, one per direction,
each with the full protocol bandwidth.  Routing tables come from one BFS
sweep per source with neighbors expanded in sorted order — deterministic,
memoized, and (for every built-in topology) hop-count-identical to
``Topology.dist``; ``Topology.diameter()`` reuses this sweep.

Clusters with node grouping (paper §5.7) assign the slower
``inter_node_protocol`` to links whose endpoints live on different nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from ..core.topology import (Cluster, ETHERNET_100G, Protocol, Topology,
                             lam)

#: Pseudo device id used for the two endpoints of a shared-medium (bus)
#: link — the medium belongs to every device, not to a pair.
SHARED = -1


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed physical link (or the shared bus medium).

    ``src``/``dst`` are device ids (``SHARED`` for a bus medium).  A full
    duplex cable appears as two Links with swapped endpoints; ``twin`` is
    the index of the opposite direction (or this link's own index for the
    bus, which is a single half-duplex arbitration domain).
    """

    index: int
    src: int
    dst: int
    protocol: Protocol
    twin: int = -1
    shared: bool = False

    @property
    def name(self) -> str:
        if self.shared:
            return "bus"
        return f"{self.src}->{self.dst}"


class Fabric:
    """Immutable link graph + memoized deterministic routing tables."""

    def __init__(self, topology: Topology, links: Sequence[Link],
                 adjacency: Dict[int, List[Tuple[int, int]]]):
        self.topology = topology
        self.num_devices = topology.num_devices
        self.links: Tuple[Link, ...] = tuple(links)
        # device -> [(neighbor, link_index)] in sorted-neighbor order.
        self._adjacency = adjacency
        self._routes: Dict[int, List[Optional[Tuple[int, ...]]]] = {}
        # Dead-link-avoiding tables, memoized by (src, frozen dead set) —
        # route repair (the chaos layer) re-sweeps the same deterministic BFS
        # with the dead links masked out of the adjacency.
        self._avoid_routes: Dict[Tuple[int, FrozenSet[int]],
                                 List[Optional[Tuple[int, ...]]]] = {}
        self._shared_link = next((l.index for l in self.links if l.shared),
                                 None)

    # -- routing ------------------------------------------------------------
    def _sweep(self, src: int, avoid: FrozenSet[int] = frozenset()
               ) -> List[Optional[Tuple[int, ...]]]:
        """BFS from ``src``; returns per-destination link-id routes.
        ``avoid`` masks links out of the adjacency (dead-link repair) —
        neighbor expansion order is unchanged, so repaired routes keep the
        same sorted-neighbor determinism as the healthy tables."""
        routes: List[Optional[Tuple[int, ...]]] = [None] * self.num_devices
        routes[src] = ()
        frontier = [src]
        while frontier:
            nxt: List[int] = []
            for u in frontier:
                base = routes[u]
                for v, li in self._adjacency.get(u, ()):
                    if li in avoid:
                        continue
                    if routes[v] is None:
                        routes[v] = base + (li,)
                        nxt.append(v)
            frontier = nxt
        return routes

    def route(self, i: int, j: int) -> Tuple[int, ...]:
        """Deterministic shortest path ``i``→``j`` as a tuple of link ids."""
        self.topology.check(i, j)
        if i == j:
            return ()
        if self._shared_link is not None:
            return (self._shared_link,)
        if i not in self._routes:
            self._routes[i] = self._sweep(i)
        r = self._routes[i][j]
        if r is None:
            raise ValueError(f"no route {i}->{j}: fabric is disconnected")
        return r

    def route_avoiding(self, i: int, j: int, dead: FrozenSet[int]
                       ) -> Optional[Tuple[int, ...]]:
        """Shortest ``i``→``j`` route that uses no link in ``dead``.

        ``None`` means the survivors leave the pair disconnected — the
        caller (the transport's route repair) turns that into a
        :class:`~repro_torch.net.faults.PartitionedFabricError` instead of
        hanging.  Same BFS determinism as :meth:`route`; an empty ``dead``
        set reproduces :meth:`route` exactly (memoized separately so the
        healthy tables stay untouched).
        """
        if not dead:
            return self.route(i, j)
        self.topology.check(i, j)
        if i == j:
            return ()
        if self._shared_link is not None:
            return None if self._shared_link in dead \
                else (self._shared_link,)
        key = (i, frozenset(dead))
        if key not in self._avoid_routes:
            self._avoid_routes[key] = self._sweep(i, avoid=key[1])
        return self._avoid_routes[key][j]

    def hops(self, i: int, j: int) -> int:
        return len(self.route(i, j))

    def all_hops(self) -> List[List[int]]:
        """One all-pairs sweep (n BFS passes, memoized) — hop-count matrix."""
        return [[self.hops(i, j) for j in range(self.num_devices)]
                for i in range(self.num_devices)]

    def diameter(self) -> int:
        return max(max(row) for row in self.all_hops())

    # -- cost ---------------------------------------------------------------
    def route_cost(self, i: int, j: int, width_bits: float) -> float:
        """Eq. 2 re-evaluated link by link: Σ_route width × λ(protocol).

        On a uniform-protocol cluster this equals the partitioner's
        ``width × dist × λ`` exactly (same λ per hop); with mixed per-link
        protocols it is the *more* accurate per-hop valuation.
        """
        if i == j:
            return 0.0
        return sum(width_bits * lam(self.links[li].protocol)
                   for li in self.route(i, j))

    # -- reporting ----------------------------------------------------------
    def describe(self) -> Dict[str, object]:
        return {
            "topology": self.topology.kind,
            "num_devices": self.num_devices,
            "num_links": len(self.links),
            "links": [{"index": l.index, "name": l.name,
                       "protocol": l.protocol.name} for l in self.links],
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Fabric({self.topology.kind}, {self.num_devices} devices, "
                f"{len(self.links)} links)")


def _cables(topology: Topology) -> List[Tuple[int, int]]:
    """Undirected physical cables of a topology (its ``links()``)."""
    return topology.links()


def build_fabric(topology: Topology,
                 protocol: Protocol = ETHERNET_100G, *,
                 cluster: Optional[Cluster] = None) -> Fabric:
    """Lower ``topology`` to an explicit :class:`Fabric`.

    ``cluster`` (optional) supplies per-link protocols: links between
    devices on different nodes get ``cluster.inter_node_protocol``; its
    intra-node protocol overrides ``protocol``.
    """
    if cluster is not None:
        protocol = cluster.protocol

    def link_protocol(u: int, v: int) -> Protocol:
        if cluster is not None and cluster.node_of(u) != cluster.node_of(v):
            return cluster.inter_node_protocol
        return protocol

    links: List[Link] = []
    adjacency: Dict[int, List[Tuple[int, int]]] = {
        d: [] for d in range(topology.num_devices)}

    if topology.shared_medium:
        # One arbitration domain shared by every pair; its own twin.
        links.append(Link(0, SHARED, SHARED, protocol, twin=0, shared=True))
        return Fabric(topology, links, adjacency)

    for u, v in sorted(_cables(topology)):
        a = len(links)
        links.append(Link(a, u, v, link_protocol(u, v), twin=a + 1))
        links.append(Link(a + 1, v, u, link_protocol(v, u), twin=a))
        adjacency[u].append((v, a))
        adjacency[v].append((u, a + 1))
    for d in adjacency:
        adjacency[d].sort()          # sorted neighbors → deterministic BFS
    return Fabric(topology, links, adjacency)


def cluster_fabric(cluster: Cluster) -> Fabric:
    """The fabric of a cluster's topology with its per-link protocols."""
    return build_fabric(cluster.topology, cluster.protocol, cluster=cluster)
