"""Cluster topology + communication-cost metric — paper §4.3 (C2).

dist(F_i, F_j) per Eq. 3 (daisy-chain), the ring variant, and the other
topologies the paper lists (bus, star, mesh, hypercube).  λ scales the cost
for the interconnect protocol relative to the 100 Gbps Ethernet baseline
(paper: PCIe Gen3x16 → 12.5×).  On TPU, λ(ICI)=1 and λ(DCN)=ICI_bw/DCN_bw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Protocol:
    """An interconnect protocol with bandwidth + per-message latency."""

    name: str
    bandwidth_Bps: float          # bytes/second per link
    latency_s: float              # per-message round-trip latency
    resource_overhead: Dict[str, float] = dataclasses.field(
        default_factory=dict)  # fraction of device resources (paper §4.4)


# Paper baselines (§4.4, Table 10) and TPU equivalents.
ETHERNET_100G = Protocol("ethernet-100g", 100e9 / 8, 1e-6,
                         {"LUT": 0.0204, "FF": 0.0294, "BRAM": 0.0206})
PCIE_GEN3X16 = Protocol("pcie-gen3x16", 100e9 / 8 / 12.5, 1.25e-6)
INTER_NODE_10G = Protocol("inter-node-10g", 10e9 / 8, 50e-6)
TPU_ICI = Protocol("tpu-ici", 50e9, 1e-6)          # ~50 GB/s/link
TPU_DCN = Protocol("tpu-dcn", 6.25e9, 50e-6)       # pod-to-pod


def lam(protocol: Protocol, baseline: Protocol = ETHERNET_100G) -> float:
    """λ — cost scaling of a protocol vs the Ethernet baseline (paper §4.3)."""
    return baseline.bandwidth_Bps / protocol.bandwidth_Bps


class Topology:
    """Base class: integer device ids 0..n-1 with a hop-distance metric.

    ``shared_medium`` marks topologies whose "one hop" is a single shared
    arbitration domain (the bus): the network fabric models them as one
    physical link that every transfer crosses, instead of a clique.

    ``hop_metric`` declares that ``dist()`` equals shortest-path length
    over the dist()==1 link graph (true for every built-in kind, asserted
    in tests).  It gates the fabric-BFS fast path of :meth:`diameter`;
    subclasses with a metric that is NOT hop-realizable (e.g. tiered
    costs) must leave it False — or override ``dist`` on a built-in and
    unset it — to keep the exhaustive max-dist definition.
    """

    kind = "abstract"
    shared_medium = False
    hop_metric = False

    def __init__(self, num_devices: int):
        if num_devices < 1:
            raise ValueError("need >=1 device")
        self.num_devices = num_devices
        self._diameter: Optional[int] = None

    def dist(self, i: int, j: int) -> int:
        raise NotImplementedError

    def check(self, i: int, j: int) -> None:
        if not (0 <= i < self.num_devices and 0 <= j < self.num_devices):
            raise IndexError((i, j, self.num_devices))

    def neighbors(self, i: int) -> List[int]:
        """Devices one hop from ``i``.  Default: a dist()==1 scan; subclasses
        with cheap structural neighborhoods may override."""
        self.check(i, i)
        return [j for j in range(self.num_devices)
                if j != i and self.dist(i, j) == 1]

    def links(self) -> List[Tuple[int, int]]:
        """Physical cables as unordered (lo, hi) device pairs (dist()==1)."""
        return [(i, j) for i in range(self.num_devices)
                for j in self.neighbors(i) if i < j]

    def diameter(self) -> int:
        """Max distance, memoized.  ``hop_metric`` classes (every built-in)
        use one all-pairs sweep over the fabric's memoized BFS routes
        (O(n·E)) instead of O(n²) repeated ``dist()`` calls; other metrics
        get one exhaustive max-dist scan — correct for ANY metric — whose
        result is likewise memoized.
        """
        if self._diameter is None:
            if self.hop_metric:
                from ..net.fabric import build_fabric  # deferred: net↔core
                try:
                    self._diameter = build_fabric(self).diameter()
                except ValueError:
                    # No dist()==1 links / disconnected: the subclass broke
                    # the hop_metric contract — exhaustive scan still works.
                    pass
            if self._diameter is None:
                n = self.num_devices
                self._diameter = max(self.dist(i, j)
                                     for i in range(n) for j in range(n))
        return self._diameter


class DaisyChain(Topology):
    """Eq. 3: dist = |device_num_i - device_num_j|."""

    kind = "daisy-chain"
    hop_metric = True

    def dist(self, i: int, j: int) -> int:
        self.check(i, j)
        return abs(i - j)


class Ring(Topology):
    """Eq. 3-ring: min(|i-j|, total - |i-j|) (paper's testbed: 4-FPGA ring)."""

    kind = "ring"
    hop_metric = True

    def dist(self, i: int, j: int) -> int:
        self.check(i, j)
        d = abs(i - j)
        return min(d, self.num_devices - d)


class Bus(Topology):
    """Shared bus: every pair is one hop (contention handled by cost model).

    ``shared_medium``: the fabric models the bus as ONE link every transfer
    arbitrates for — the canonical hot-spot topology."""

    kind = "bus"
    shared_medium = True
    hop_metric = True

    def dist(self, i: int, j: int) -> int:
        self.check(i, j)
        return 0 if i == j else 1


class Star(Topology):
    """Hub-and-spoke: device 0 is the hub."""

    kind = "star"
    hop_metric = True

    def dist(self, i: int, j: int) -> int:
        self.check(i, j)
        if i == j:
            return 0
        return 1 if (i == 0 or j == 0) else 2


class Mesh2D(Topology):
    """2-D grid; optionally wrapped (torus — the TPU ICI topology)."""

    kind = "mesh2d"
    hop_metric = True

    def __init__(self, rows: int, cols: int, torus: bool = False):
        super().__init__(rows * cols)
        self.rows, self.cols, self.torus = rows, cols, torus

    def coords(self, i: int) -> Tuple[int, int]:
        return divmod(i, self.cols)

    def dist(self, i: int, j: int) -> int:
        self.check(i, j)
        (r1, c1), (r2, c2) = self.coords(i), self.coords(j)
        dr, dc = abs(r1 - r2), abs(c1 - c2)
        if self.torus:
            dr = min(dr, self.rows - dr)
            dc = min(dc, self.cols - dc)
        return dr + dc


class Hypercube(Topology):
    kind = "hypercube"
    hop_metric = True

    def __init__(self, dim: int):
        super().__init__(1 << dim)
        self.dim = dim

    def dist(self, i: int, j: int) -> int:
        self.check(i, j)
        return bin(i ^ j).count("1")


TOPOLOGIES = {
    "daisy-chain": DaisyChain,
    "ring": Ring,
    "bus": Bus,
    "star": Star,
    "mesh2d": Mesh2D,
    "hypercube": Hypercube,
}


@dataclasses.dataclass
class DeviceSpec:
    """One device's capacities + performance (paper Table 2 / TPU v5e)."""

    name: str
    resources: Dict[str, float]
    peak_flops: float = 0.0          # FLOP/s
    hbm_bandwidth: float = 0.0       # bytes/s
    onchip_bandwidth: float = 0.0    # bytes/s (BRAM / VMEM)
    max_freq_hz: float = 0.0         # FPGA fabric clock ceiling


# Alveo U55C (paper Table 2 + §2: HBM 460 GB/s, SRAM 35 TB/s, 300 MHz max).
ALVEO_U55C = DeviceSpec(
    "alveo-u55c",
    {"LUT": 1146240, "FF": 2292480, "BRAM": 1776, "DSP": 8376, "URAM": 960},
    peak_flops=8376 * 2 * 300e6,      # DSPs × 2 flops × fmax (fp32 MAC bound)
    hbm_bandwidth=460e9,
    onchip_bandwidth=35e12,
    max_freq_hz=300e6,
)

# TPU v5e (assignment constants: 197 TFLOP/s bf16, 819 GB/s HBM, 16 GB).
TPU_V5E = DeviceSpec(
    "tpu-v5e",
    {"hbm_bytes": 16 * 1024**3, "flops": 197e12, "vmem_bytes": 128 * 2**20},
    peak_flops=197e12,
    hbm_bandwidth=819e9,
    onchip_bandwidth=35e12,
)


@dataclasses.dataclass
class Cluster:
    """A set of identical devices joined by a topology + protocol, optionally
    grouped into nodes joined by a slower protocol (paper §5.7)."""

    device: DeviceSpec
    topology: Topology
    protocol: Protocol = ETHERNET_100G
    devices_per_node: Optional[int] = None
    inter_node_protocol: Protocol = INTER_NODE_10G
    utilization_threshold: float = 0.70   # paper Eq. 1 threshold T
    # Charge the interconnect IP's per-FPGA area (paper §4.4, Table 10) to
    # every device's usable capacity.  Single-device clusters need no NIC.
    charge_interconnect_overhead: bool = True

    @property
    def num_devices(self) -> int:
        return self.topology.num_devices

    def node_of(self, dev: int) -> int:
        if not self.devices_per_node:
            return 0
        return dev // self.devices_per_node

    def protocol_between(self, i: int, j: int) -> Protocol:
        if self.node_of(i) != self.node_of(j):
            return self.inter_node_protocol
        return self.protocol

    def comm_cost(self, i: int, j: int, width_bits: float) -> float:
        """Eq. 2 summand: width × dist × λ (0 when co-located)."""
        if i == j:
            return 0.0
        d = self.topology.dist(i, j)
        return width_bits * d * lam(self.protocol_between(i, j))

    def interconnect_overhead_frac(self, kind: str) -> float:
        """Fraction of a device's ``kind`` consumed by the interconnect IP
        (paper §4.4, Table 10: the Ethernet core costs LUT/FF/BRAM on every
        FPGA it is instantiated on)."""
        if not self.charge_interconnect_overhead or self.num_devices <= 1:
            return 0.0
        frac = self.protocol.resource_overhead.get(kind, 0.0)
        if self.devices_per_node and self.devices_per_node < self.num_devices:
            # Conservative: the inter-node NIC is charged to EVERY device,
            # not just node-boundary ones — capacity is modeled per
            # cluster, so Eq. 1 rows stay device-uniform.  Boundary-only
            # charging needs per-device capacities (future work).
            frac += self.inter_node_protocol.resource_overhead.get(kind, 0.0)
        return frac

    def effective_resources(self) -> Dict[str, float]:
        """Device resources net of the interconnect IP (pre-placed area)."""
        return {k: v * (1.0 - self.interconnect_overhead_frac(k))
                for k, v in self.device.resources.items()}

    def capacity(self, kind: str) -> float:
        res = self.device.resources.get(kind, 0.0)
        return (res * (1.0 - self.interconnect_overhead_frac(kind))
                * self.utilization_threshold)


def fpga_ring_cluster(n: int, devices_per_node: Optional[int] = None) -> Cluster:
    """The paper's testbed: U55C cards in a ring over QSFP28 (4 per node)."""
    return Cluster(ALVEO_U55C, Ring(n), ETHERNET_100G,
                   devices_per_node=devices_per_node)


def tpu_pod_cluster(num_pods: int = 2) -> Cluster:
    """Multi-pod TPU: pods as 'nodes', DCN as the inter-node protocol.

    At the inter-pod granularity the topology is a daisy chain of pods; each
    pod internally is a Mesh2D torus handled by the intra-device floorplanner.
    """
    return Cluster(TPU_V5E, DaisyChain(num_pods), TPU_ICI,
                   devices_per_node=1, inter_node_protocol=TPU_DCN,
                   utilization_threshold=0.85)
