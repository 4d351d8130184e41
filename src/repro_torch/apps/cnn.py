"""Systolic CNN benchmark — paper §5.5 (AutoSA VGG conv3).

Topology: a 13×N grid of MAC PEs (493 compute modules at 13×20 counting IO
modules).  Fixed work = 54.5 MFLOPs per input; grid size sets throughput.
Table 7: inter-FPGA volume grows linearly with grid size (2.14 MB at 13×4 →
10.71 MB at 13×20) — the anti-scaling force, together with AlveoLink write
contention from many boundary PEs (§5.5).

Routability gate (Table 8): 13×8 is the largest single-FPGA grid (TAPA);
13×4 for Vitis; 13×12/16/20 need 2/3/4 FPGAs.  Frequency: 300 MHz for all
designs that route (§5.5) — CNN gains come purely from more PEs, throttled
by inter-FPGA contention.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph

FLOPS_PER_INPUT = 54.5e6
FREQ = 300e6
# Table 7: grid-size -> per-boundary transfer volume (bytes).
TABLE7_VOLUME = {(13, 4): 2.14e6, (13, 8): 4.28e6, (13, 12): 6.42e6,
                 (13, 16): 8.57e6, (13, 20): 10.71e6}
# Table 8: per-grid resource utilization % (LUT, FF, BRAM, DSP, URAM).
TABLE8_UTIL = {(13, 4): (20.4, 12.1, 14.2, 25.2, 0),
               (13, 8): (38.3, 23.5, 23.7, 49, 0),
               (13, 12): (56.1, 34.3, 32.7, 80.1, 0),
               (13, 16): (74, 45.7, 42.3, 97.6, 0),
               (13, 20): (91.9, 57, 52.1, 123.7, 0)}
GRID_FOR_NDEV = {1: (13, 4), 2: (13, 12), 3: (13, 16), 4: (13, 20)}
# Batch of inputs pushed through the array per run.
BATCH = 256
# AlveoLink contention: boundary PEs share the QSFP port; effective link
# bandwidth derates with the number of writers (§5.5).
LINK_BW = 12.5e9


def grid_modules(grid: Tuple[int, int]) -> int:
    r, c = grid
    return r * c + r * c // 4 + min(c * 10, 233)   # PEs + IO/ctrl modules


def build_graph(ndev: int) -> TaskGraph:
    grid = GRID_FOR_NDEV[ndev]
    r, c = grid
    g = TaskGraph(f"cnn-{r}x{c}-x{ndev}")
    per_col_flops = FLOPS_PER_INPUT * BATCH / c
    util = TABLE8_UTIL[grid]
    from ..core import ALVEO_U55C
    res = ALVEO_U55C.resources
    for col in range(c):
        g.add_task(Task(
            f"col{col}",
            ResourceProfile({
                "LUT": res["LUT"] * util[0] / 100 / c,
                "FF": res["FF"] * util[1] / 100 / c,
                "BRAM": res["BRAM"] * util[2] / 100 / c,
                "DSP": res["DSP"] * util[3] / 100 / c}),
            hbm_bytes=per_col_flops / 10,
            meta={"cycles": per_col_flops / (2 * r * 2),
                  "ops": per_col_flops}))
    vol = TABLE7_VOLUME[grid]
    for col in range(c - 1):
        g.add_channel(f"col{col}", f"col{col+1}", width_bits=512,
                      bytes_per_step=vol * BATCH / c)
    return g


def modeled_latency(ndev: int, freq: float = FREQ,
                    devices_per_node: int = 4) -> float:
    grid = GRID_FOR_NDEV[ndev]
    r, c = grid
    # Systolic throughput: r×c PEs × 2 flops/cycle.
    compute = FLOPS_PER_INPUT * BATCH / (r * c * 2 * freq)
    vol = TABLE7_VOLUME[grid] * BATCH
    total = compute
    if ndev > 1:
        # Boundary crossings: contention from r writers sharing the link.
        writers = r
        eff_bw = LINK_BW / max(1.0, writers / 4)
        for b in range(ndev - 1):
            total += vol / (c // ndev) / eff_bw
    return total


def speedup_table() -> Dict[str, float]:
    base = modeled_latency(1)          # 13×4 Vitis (300 MHz routes)
    t_tapa = FLOPS_PER_INPUT * BATCH / (13 * 8 * 2 * FREQ)   # 13×8 TAPA
    out = {"F1-T": base / t_tapa}
    for n in (2, 3, 4):
        out[f"F{n}"] = base / modeled_latency(n)
    return out


# -- runnable numerics --------------------------------------------------------

def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The arrays :func:`bind_programs` uses, drawn from ``spec["seed"]`` in
    this order: ``wgt`` [3, 3, cin, columns × cout_per_col] (standard
    normal × 0.05), then ``xs`` [streams, h, w, cin] (standard normal)."""
    spec = dict(spec or {})
    h, w = spec.get("h", 8), spec.get("w", 8)
    cin = spec.get("cin", 8)
    cpc = spec.get("cout_per_col", 2)
    streams = spec.get("streams", 2)
    c = sum(1 for t in graph.tasks if t.startswith("col"))
    rng = np.random.default_rng(spec.get("seed", 0))
    wgt = rng.standard_normal((3, 3, cin, c * cpc), dtype=np.float32)
    wgt *= np.float32(0.05)
    xs = rng.standard_normal((streams, h, w, cin), dtype=np.float32)
    return {"wgt": wgt, "xs": xs}


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    """Executable bodies for the systolic column chain (repro_torch.exec
    hook).

    Output-stationary decomposition: column *j* owns the weight slice for
    ``cout_per_col`` output channels and runs it through the systolic
    matmul kernel (``conv_op``); the activation tile streams down the chain
    while each column appends its partial output — the last column's token
    is the full conv, channel-concatenated, matching the single-device
    ``conv_op`` numerics.
    """
    from ..exec.programs import SOURCE_KEY, ProgramBinding, resolve_device
    from ..kernels import conv_op

    device = resolve_device(device)
    spec = dict(spec or {})
    cpc = spec.get("cout_per_col", 2)
    cols = sorted(graph.tasks, key=lambda t: int(t[len("col"):]))
    c = len(cols)

    arrays = make_inputs(graph, spec)
    wgt = torch.from_numpy(arrays["wgt"]).to(device)
    xs = list(torch.from_numpy(arrays["xs"]).to(device).unbind(0))

    def col_body(j):
        w_j = wgt[..., j * cpc:(j + 1) * cpc].contiguous()

        def body(inputs):
            if j == 0:
                x, y = inputs[SOURCE_KEY], None
            else:
                tok = inputs[cols[j - 1]]
                x, y = tok["x"], tok["y"]
            y_j = conv_op(x, w_j)
            y = y_j if y is None else torch.cat([y, y_j], dim=-1)
            # The last column's finished tile leaves the array.
            return y if j == c - 1 else {"x": x, "y": y}
        return body

    programs = {name: col_body(j) for j, name in enumerate(cols)}

    def reference():
        return torch.stack([conv_op(x, wgt) for x in xs])

    return ProgramBinding(
        graph=graph, programs=programs, iterations=len(xs),
        source_inputs={cols[0]: xs},
        finalize=lambda sinks: torch.stack(sinks[cols[-1]]),
        reference=reference, atol=2e-4)
