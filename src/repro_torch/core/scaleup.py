"""Automatic scale-up advisor — implements the paper's §7.1 future-work item.

"There is a lack of frameworks which automatically enable scaling-up a design
from a single FPGA to multiple FPGAs... map-reduce style programming
frameworks ... allow automated scaling based on the memory/compute-intensity
of the application."

Given a task graph annotated with compute intensity (ops/byte) and the
cluster, decide how to scale the design when devices are added:

* memory-bound tasks (intensity < device ridge point): widen memory access —
  more HBM channels / wider ports per device (paper §5.2 rule for Stencil
  iters 64/128: bitwidth 128→512, channels 32→32×ndev).
* compute-bound tasks: replicate PEs (paper §5.2 rule for iters 256/512:
  PEs 15→15×~2×(ndev-1), bitwidth kept).

This is what turns a single-device TAPA design into the scaled multi-device
design whose partition Eq. 1–2 then places.  For the LM workloads the same
advisor decides DP (memory-bound decode: replicate + more aggregate HBM) vs
PP/TP (compute-bound training: split the graph) on the pod axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .graph import TaskGraph
from .topology import Cluster, DeviceSpec


@dataclasses.dataclass
class ScalePlan:
    mode: str                     # "widen-memory" | "replicate-compute"
    replication: int              # PE replication factor
    hbm_channels: int             # total HBM channels to bind
    port_bits: int                # HBM port width
    intensity: float              # ops/byte of the (dominant) tasks
    ridge: float                  # device ridge point ops/byte
    rationale: str


def ridge_point(device: DeviceSpec, freq_hz: Optional[float] = None) -> float:
    """ops/byte at which the device flips memory→compute bound."""
    peak = device.peak_flops
    if freq_hz and device.max_freq_hz:
        peak = peak * freq_hz / device.max_freq_hz
    return peak / device.hbm_bandwidth


def graph_intensity(graph: TaskGraph) -> float:
    ops = sum(float(t.meta.get("ops", 0.0)) for t in graph.tasks.values())
    byts = sum(t.hbm_bytes for t in graph.tasks.values())
    return ops / byts if byts else float("inf")


def plan_scaleup(graph: TaskGraph, cluster: Cluster, num_devices: int, *,
                 base_channels: int = 32, base_port_bits: int = 128,
                 base_pes: int = 1) -> ScalePlan:
    """Decide how to scale a single-device design to ``num_devices``."""
    inten = graph_intensity(graph)
    ridge = ridge_point(cluster.device)
    if inten < ridge:
        return ScalePlan(
            mode="widen-memory",
            replication=base_pes,
            hbm_channels=base_channels * num_devices,
            port_bits=max(base_port_bits, 512),
            intensity=inten, ridge=ridge,
            rationale=(f"intensity {inten:.1f} ops/B < ridge {ridge:.1f}: "
                       "memory-bound; widen HBM ports to 512b and scale "
                       f"channels {base_channels}->{base_channels*num_devices} "
                       "(paper §5.2 rule 1)"))
    rep = base_pes * (1 + 2 * (num_devices - 1)) if num_devices > 1 else base_pes
    return ScalePlan(
        mode="replicate-compute",
        replication=rep,
        hbm_channels=base_channels,
        port_bits=base_port_bits,
        intensity=inten, ridge=ridge,
        rationale=(f"intensity {inten:.1f} ops/B >= ridge {ridge:.1f}: "
                   f"compute-bound; replicate PEs x{rep} keeping port width "
                   "(paper §5.2 rule 2)"))


def lm_pod_strategy(param_bytes: float, act_bytes_per_step: float,
                    flops_per_step: float, num_pods: int,
                    hbm_per_chip: float, chips_per_pod: int,
                    dcn_bw: float, step_compute_s: float) -> str:
    """Choose the pod-axis strategy for an LM workload.

    "dp": replicate stages across pods, all-reduce grads over DCN (optionally
          compressed) — right when grads/step small vs DCN budget.
    "pp": pipeline stages across pods — right when per-pod memory binds or
          DP gradient traffic would dominate the step.
    """
    if num_pods <= 1:
        return "dp"
    fits = param_bytes * 12 <= hbm_per_chip * chips_per_pod * 0.85
    # DP cost: 2×params over DCN per step (ring all-reduce ≈ 2x payload).
    dp_comm_s = 2 * param_bytes / (dcn_bw * chips_per_pod)
    if not fits:
        return "pp"
    return "dp" if dp_comm_s <= 0.5 * step_compute_s else "pp"
