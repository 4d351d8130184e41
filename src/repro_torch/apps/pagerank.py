"""PageRank benchmark — paper §5.3.

Topology (Fig. 9): one vertex-router task streaming edges from HBM, N PEs
computing weighted rank propagation, one accumulator; dependency cycle
(iterate to convergence) marked as a back edge.  After the router, all PEs —
across all FPGAs — run in parallel (§5.3), so scaling is near-linear plus
the port-width bandwidth unlock (single-FPGA routes 256-bit ports only).

Transfer volumes are dataset-dependent and CONSTANT in PE count (§5.3) —
the opposite trade-off from Stencil, which is why PageRank superlinearly
scales while Stencil saturates.

Anchor (§5.7): 8-FPGA cit-Patents end-to-end 3.44 s = 1.4× faster than
single-FPGA Vitis ⇒ T1V(cit-Patents) ≈ 4.8 s.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph

# Table 5 datasets: name -> (nodes, edges).
DATASETS = {
    "web-BerkStan": (685_230, 7_600_595),
    "soc-Slashdot0811": (77_360, 905_468),
    "web-Google": (875_713, 5_105_039),
    "cit-Patents": (3_774_768, 16_518_948),
    "web-NotreDame": (325_729, 1_497_134),
}
FREQS = {"F1-V": 123e6, "F1-T": 190e6, "FCS": 266e6}   # §5.3 measured
EDGE_BYTES = 8
ITERS = 20                      # to-convergence sweeps (edge-centric)
# Calibrated on the §5.7 anchor: serial router cycles per edge + parallel
# PE cycles per edge (single fit, all datasets share it).
ROUTER_CPE = 0.55               # cycles/edge on the router (serial-ish)
PE_CPE = 1.3                    # cycles/edge in a PE


def hbm_eff(port_bits: int) -> float:
    return min(port_bits / 500.0, 1.0)


def design(ndev: int) -> dict:
    return {"pes": 4 * ndev, "port": 256 if ndev == 1 else 512,
            "channels": 27 if ndev == 1 else 32 * ndev}


def build_graph(ndev: int, dataset: str = "cit-Patents") -> TaskGraph:
    nodes, edges = DATASETS[dataset]
    d = design(ndev)
    g = TaskGraph(f"pagerank-{dataset}-x{ndev}")
    g.add_task(Task("router", ResourceProfile(
        {"LUT": 60000, "DSP": 100, "BRAM": 200}),
        hbm_bytes=edges * EDGE_BYTES * ITERS,
        meta={"cycles": ROUTER_CPE * edges * ITERS,
              "ops": 2 * edges * ITERS}))
    per_pe_edges = edges / d["pes"]
    for p in range(d["pes"]):
        g.add_task(Task(f"pe{p}", ResourceProfile(
            {"LUT": 90000, "DSP": 400, "BRAM": 150, "URAM": 40}),
            hbm_bytes=per_pe_edges * EDGE_BYTES * ITERS,
            meta={"cycles": PE_CPE * per_pe_edges * ITERS,
                  "ops": 6 * per_pe_edges * ITERS}))
        g.add_channel("router", f"pe{p}", width_bits=512,
                      bytes_per_step=per_pe_edges * EDGE_BYTES)
    g.add_task(Task("accum", ResourceProfile(
        {"LUT": 40000, "DSP": 60, "BRAM": 100}),
        hbm_bytes=nodes * 4 * ITERS,
        meta={"cycles": 0.3 * nodes * ITERS, "ops": nodes * ITERS}))
    for p in range(d["pes"]):
        g.add_channel(f"pe{p}", "accum", width_bits=512,
                      bytes_per_step=nodes * 4 / d["pes"])
    # convergence loop
    g.add_channel("accum", "router", width_bits=512,
                  bytes_per_step=nodes * 4, back=True)
    return g


def modeled_latency(ndev: int, freq: float, dataset: str = "cit-Patents",
                    devices_per_node: int = 4) -> float:
    nodes, edges = DATASETS[dataset]
    d = design(ndev)
    # Router phase: memory-bound edge streaming, port-width gated.
    router = max(ROUTER_CPE * edges / freq,
                 edges * EDGE_BYTES / (460e9 * hbm_eff(d["port"])))
    # PE phase: all PEs parallel (across FPGAs), per-FPGA HBM shared by its
    # local PEs.
    pes = d["pes"]
    pe_c = PE_CPE * (edges / pes) / freq
    pe_m = (edges * EDGE_BYTES / ndev) / (460e9 * hbm_eff(d["port"]))
    pe = max(pe_c, pe_m)
    accum = 0.3 * nodes / freq
    per_iter = router + pe + accum
    total = ITERS * per_iter
    # Inter-FPGA rank-update exchange per iteration (constant in PEs §5.3).
    vol = nodes * 4
    for b in range(ndev - 1):
        same_node = (b + 1) % devices_per_node != 0
        bw = 12.5e9 if same_node else 1.25e9 / 3
        total += ITERS * (vol / bw)
    return total


def speedup_table() -> Dict[str, float]:
    out = {"F1-T": [], "F2": [], "F3": [], "F4": []}
    for ds in DATASETS:
        base = modeled_latency(1, FREQS["F1-V"], ds)
        out["F1-T"].append(base / modeled_latency(1, FREQS["F1-T"], ds))
        for n, key in ((2, "F2"), (3, "F3"), (4, "F4")):
            out[key].append(base / modeled_latency(n, FREQS["FCS"], ds))
    return {k: float(np.mean(v)) for k, v in out.items()}


def eight_fpga_latency(dataset: str = "cit-Patents") -> float:
    return modeled_latency(8, FREQS["FCS"], dataset)


# -- runnable numerics --------------------------------------------------------
#
# The JAX package sums each node's incoming contributions with ``.at[].add``.
# On the card a scatter-add (``index_add_``) adds with atomics, in an order
# that changes from run to run, and so do the bits.  Here every sum is
# taken in a fixed order instead: the edges are stably sorted by their
# target once, when the graph is drawn, and each run adds each target's
# run of contributions with ``torch.segment_reduce`` (one segment a
# target), then places the sums at their targets.  The values go in as an
# [E, 1] column: for 2-D data segment_reduce adds each segment in one
# thread, first to last, on the card as on the CPU, so the card gives the
# CPU's bits.  (For 1-D data its CUDA path takes one CUB thread block a
# segment, which is far slower where nearly every segment holds one or two
# edges, as in a PE's shard, and adds in another order.)  No process-wide
# setting is touched.


def draw_edges(n_nodes: int, n_edges: int, seed: int, device):
    """``(src, dst)`` int64 on ``device``: the JAX package's draws (the same
    ``np.random.default_rng(seed)`` calls in the same order)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(dst).to(device))


def segments(keys: torch.Tensor):
    """``(order, targets, lengths)`` of a fixed-order segment sum over
    ``keys``: ``order`` stably sorts the values by key, ``targets`` are
    the distinct keys ascending and ``lengths`` their run lengths."""
    sorted_keys, order = torch.sort(keys, stable=True)
    targets, lengths = torch.unique_consecutive(sorted_keys,
                                                return_counts=True)
    return order, targets, lengths


def segment_sum(values: torch.Tensor, targets: torch.Tensor,
                lengths: torch.Tensor, n: int) -> torch.Tensor:
    """``out[targets[j]]`` = the sum of the ``j``-th run of ``values``
    (already in :func:`segments` order); 0 at every other of ``n`` nodes.
    Each run is added first to last, so the same inputs give the same bits
    on every run and on the card as on the CPU."""
    sums = torch.segment_reduce(values[:, None], "sum", lengths=lengths,
                                axis=0, unsafe=True)[:, 0]
    return values.new_zeros(n).index_copy_(0, targets, sums)


def out_degree(src: torch.Tensor, n: int) -> torch.Tensor:
    """Out-degree of every node as float32, at least 1 (JAX's
    ``zeros(n).at[src].add(1.0).clip(1.0)``), from the same sum."""
    _, targets, lengths = segments(src)
    ones = torch.ones(src.numel(), dtype=torch.float32, device=src.device)
    return segment_sum(ones, targets, lengths, n).clamp_(min=1.0)


def run_numeric(n_nodes: int = 512, n_edges: int = 4096, iters: int = 10,
                seed: int = 0, damping: float = 0.85, *,
                device=None) -> torch.Tensor:
    """Edge-centric PageRank in PyTorch (segment-sum push model), unsharded;
    ``device`` as :func:`~repro_torch.exec.programs.resolve_device`."""
    from ..exec.programs import resolve_device

    device = resolve_device(device)
    src, dst = draw_edges(n_nodes, n_edges, seed, device)
    out_deg = out_degree(src, n_nodes)
    order, targets, lengths = segments(dst)
    src = src[order]
    deg = out_deg[src]
    rank = torch.full((n_nodes,), 1.0 / n_nodes, dtype=torch.float32,
                      device=device)
    for _ in range(iters):
        acc = segment_sum(rank[src] / deg, targets, lengths, n_nodes)
        rank = (1 - damping) / n_nodes + damping * acc
    return rank


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    """Executable bodies for the PageRank graph (repro_torch.exec hook).

    The convergence cycle (Fig. 9's back edge) becomes a primed back-edge
    FIFO: the router pops last iteration's rank from ``accum``, shards the
    edge contributions across the PEs (a routed output — one distinct slice
    per channel), each PE segment-sums its shard, and ``accum`` folds the
    partials with damping and recirculates.  ``iterations`` steady-state
    firings reproduce ``run_numeric`` (same rng draws, same edge-centric
    update; the sums are grouped by PE, so within ``atol``, not bit for
    bit).  Each PE's shard is sorted by target here, once, so the router
    sends each PE its contributions in that order and the PE adds them in
    a fixed order (:func:`segment_sum`).
    """
    from ..exec.programs import ProgramBinding, RoutedOutput, resolve_device

    device = resolve_device(device)
    spec = dict(spec or {})
    n = spec.get("n_nodes", 256)
    e = spec.get("n_edges", 2048)
    iters = spec.get("iters", 8)
    damping = spec.get("damping", 0.85)
    seed = spec.get("seed", 0)
    pes = sorted((t for t in graph.tasks if t.startswith("pe")),
                 key=lambda t: int(t[len("pe"):]))

    # Same generator call order as run_numeric → identical graph.
    src, dst = draw_edges(n, e, seed, device)
    out_deg = out_degree(src, n)
    sizes = [len(s) for s in np.array_split(np.arange(e), len(pes))]
    ends = np.cumsum(sizes).tolist()
    routed, segs = [], []
    for lo, hi in zip([0] + ends[:-1], ends):
        order, targets, lengths = segments(dst[lo:hi])
        routed.append(src[lo:hi][order])
        segs.append((targets, lengths))
    routed_src = torch.cat(routed)
    routed_deg = out_deg[routed_src]
    del src, dst, routed

    def router_body(inputs):
        contrib = inputs["accum"][routed_src] / routed_deg
        return RoutedOutput(dict(zip(pes, contrib.split(sizes))))

    def pe_body(p):
        targets, lengths = segs[p]

        def body(inputs):
            return segment_sum(inputs["router"], targets, lengths, n)
        return body

    def accum_body(inputs):
        acc = sum(inputs[name] for name in pes)
        return (1 - damping) / n + damping * acc

    programs = {"router": router_body, "accum": accum_body}
    for p, name in enumerate(pes):
        programs[name] = pe_body(p)

    back = [i for i, c in enumerate(graph.channels) if c.meta.get("back")]

    def reference():
        return run_numeric(n_nodes=n, n_edges=e, iters=iters, seed=seed,
                           damping=damping, device=device)

    return ProgramBinding(
        graph=graph, programs=programs, iterations=iters,
        prime={i: torch.full((n,), 1.0 / n, dtype=torch.float32,
                             device=device) for i in back},
        finalize=lambda sinks: sinks["accum"][-1],
        reference=reference, atol=1e-5)
