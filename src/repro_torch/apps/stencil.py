"""Stencil (Dilate) benchmark — paper §5.2.

Mechanisms (all from the paper's own analysis):
* Routability gate: a single FPGA routes only (15 PEs, 128-bit HBM ports, 32
  channels); wider ports congest the HBM die and fail routing (§3, §5.2) —
  the Eq. 1 threshold binding.  Multi-FPGA designs route 512-bit ports.
* HBM saturation: a w-bit port saturates ~w/500 of per-bank bandwidth
  (§3: 256-bit ⇒ 51.2%).
* Scaling rules (§5.2): iters ≤ 128 (memory-bound) → widen ports/channels;
  iters ≥ 256 (compute-bound) → scale total PEs 15→30/60/90.
* Topology: stages are SEQUENTIAL (each FPGA runs its iteration share while
  successors idle; §5.2), transfers of Table-4 volumes between stages.
* §5.7: 8 FPGAs = 2 nodes; inter-node staging via hosts over 10 Gbps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..core import (ALVEO_U55C, Cluster, ResourceProfile, Task, TaskGraph,
                    fpga_ring_cluster)

GRID = 4096
POINT_BYTES = 4
GRID_BYTES = GRID * GRID * POINT_BYTES
# Table 4 (per-boundary inter-FPGA transfer volume, bytes).
TABLE4_VOLUME = {64: 144.22e6, 128: 288.43e6, 256: 576.86e6, 512: 1153.73e6}
# Table 4 compute intensity (ops / byte of external memory access).
TABLE4_INTENSITY = {64: 208, 128: 416, 256: 832, 512: 1664}
FREQS = {"F1-V": 165e6, "F1-T": 250e6, "FCS": 300e6}   # §5.2 measured
OPS_PER_POINT = 13
# Calibrated once against the §5.7 anchor (single-FPGA Vitis 512-iter
# latency 11.65/1.45 = 8.03 s): points/cycle/PE.
PPC = 0.432


def hbm_eff(port_bits: int) -> float:
    """Port-width HBM saturation (§3: 256-bit ⇒ 51.2%)."""
    return min(port_bits / 500.0, 1.0)


def design(ndev: int, iters: int) -> dict:
    """Scaled design per §5.2 rules."""
    if ndev == 1:
        return {"pes": 15, "port": 128, "channels": 32}
    if iters <= 128:
        return {"pes": 15 * ndev, "port": 512, "channels": 32 * ndev}
    return {"pes": {2: 30, 3: 60, 4: 90}.get(ndev, 30 * (ndev - 1)),
            "port": 128, "channels": 32 * ndev}


def build_graph(ndev: int, iters: int = 256) -> TaskGraph:
    """Chain of per-device PE-stage tasks with Table-4 channel volumes."""
    d = design(ndev, iters)
    g = TaskGraph(f"stencil-{iters}x{ndev}")
    pes_per_dev = max(1, d["pes"] // ndev)
    stage_iters = iters // ndev
    vol = TABLE4_VOLUME[iters]
    for s in range(ndev):
        cycles = GRID * GRID * stage_iters / (pes_per_dev * PPC)
        g.add_task(Task(
            f"stage{s}",
            ResourceProfile({"LUT": 30000 * pes_per_dev,
                             "DSP": 40 * pes_per_dev,
                             "BRAM": 24 * pes_per_dev}),
            hbm_bytes=2 * GRID_BYTES * stage_iters,
            meta={"cycles": cycles,
                  "ops": OPS_PER_POINT * GRID * GRID * stage_iters}))
    for s in range(ndev - 1):
        g.add_channel(f"stage{s}", f"stage{s+1}", width_bits=512,
                      bytes_per_step=vol)
    return g


def modeled_latency(ndev: int, iters: int, freq: float,
                    port_override: int = None,
                    devices_per_node: int = 4) -> float:
    """Sequential-stage latency (s)."""
    d = design(ndev, iters)
    port = port_override or d["port"]
    pes_per_dev = max(1, d["pes"] // ndev)
    stage_iters = iters / ndev
    compute = GRID * GRID * stage_iters / (pes_per_dev * PPC * freq)
    memory = 2 * GRID_BYTES * stage_iters / (460e9 * hbm_eff(port))
    stage = max(compute, memory)
    total = ndev * stage
    vol = TABLE4_VOLUME[iters]
    for b in range(ndev - 1):
        same_node = (b + 1) % devices_per_node != 0
        if same_node:
            total += vol / 12.5e9 + 1e-6
        else:
            total += 3 * vol / 1.25e9 + 50e-6      # host-staged 10 Gbps §5.7
    return total


def speedup_table(iters_list=(64, 128, 256, 512)) -> Dict[str, float]:
    """Average speedups vs F1-V (reproduces Table 3 Stencil row)."""
    out = {"F1-T": [], "F2": [], "F3": [], "F4": []}
    for it in iters_list:
        base = modeled_latency(1, it, FREQS["F1-V"])
        out["F1-T"].append(base / modeled_latency(1, it, FREQS["F1-T"]))
        for n, key in ((2, "F2"), (3, "F3"), (4, "F4")):
            out[key].append(base / modeled_latency(n, it, FREQS["FCS"]))
    return {k: float(np.mean(v)) for k, v in out.items()}


def eight_fpga_latency(iters: int = 512) -> float:
    """§5.7: 2 nodes × 4 FPGAs, 120 PEs."""
    d_pes = 120 // 8
    stage_iters = iters / 8
    compute = GRID * GRID * stage_iters / (d_pes * PPC * FREQS["FCS"])
    total = 8 * compute
    vol = TABLE4_VOLUME[iters]
    total += 6 * (vol / 12.5e9 + 1e-6)              # intra-node boundaries
    total += 1 * (3 * vol / 1.25e9 + 50e-6)         # node boundary
    return total


# -- runnable numerics --------------------------------------------------------

def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The arrays :func:`bind_programs` streams, drawn from ``spec["seed"]``:
    ``imgs`` [streams, h, w] fp32 standard normal."""
    spec = dict(spec or {})
    h, w = spec.get("h", 64), spec.get("w", 64)
    streams = spec.get("streams", 3)
    rng = np.random.default_rng(spec.get("seed", 0))
    return {"imgs": rng.standard_normal((streams, h, w), dtype=np.float32)}


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    """Executable bodies for the stage chain (repro_torch.exec hook).

    Each ``stage{s}`` applies its iteration share of the dilation to the
    image streaming through the chain, through the dilate kernel — composing
    the stages reproduces the single-device op at ``stage_iters × ndev``
    total iterations.  The reduced numeric scale (``spec``:
    h/w/stage_iters/streams/seed) is independent of the graph's modeled
    Table-4 scale; the images are :func:`make_inputs`'s, on ``device``.
    """
    from ..exec.programs import SOURCE_KEY, ProgramBinding, resolve_device
    from ..kernels import dilate_op

    device = resolve_device(device)
    spec = dict(spec or {})
    h = spec.get("h", 64)
    stage_iters = spec.get("stage_iters", 2)
    stages = sorted(graph.tasks, key=lambda t: int(t[len("stage"):]))
    ndev = len(stages)
    block_rows = min(128, h)

    imgs = list(torch.from_numpy(make_inputs(graph, spec)["imgs"])
                .to(device).unbind(0))

    def stage_body(prev):
        def body(inputs):
            img = inputs[SOURCE_KEY] if prev is None else inputs[prev]
            return dilate_op(img, iters=stage_iters, block_rows=block_rows)
        return body

    programs = {s: stage_body(stages[i - 1] if i else None)
                for i, s in enumerate(stages)}

    def reference():
        return torch.stack([dilate_op(img, iters=stage_iters * ndev,
                                      block_rows=block_rows)
                            for img in imgs])

    return ProgramBinding(
        graph=graph, programs=programs, iterations=len(imgs),
        source_inputs={stages[0]: imgs},
        finalize=lambda sinks: torch.stack(sinks[stages[-1]]),
        reference=reference, atol=1e-6)
