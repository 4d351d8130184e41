"""KNN benchmark — paper §3 + §5.4 (CHIP-KNN [44]).

Topology (Fig. 4): blue distance modules streaming the dataset from HBM,
yellow top-K sorters, one green aggregator.  All FPGAs except the aggregator
run completely independently on their data shard (§5.4), and inter-FPGA
volume depends only on K — constant over the search space.

Mechanisms:
* Routability gate (§3): single FPGA routes only 256-bit ports / 32 KB
  buffers ⇒ 51.2% per-bank saturation; the 512-bit/128 KB config fails
  routing on one device but routes when spread over ≥2.
* Distance phase is memory-bound (N·D·4 bytes streamed), sort phase is
  O(N·K) compute, aggregation O(ndev·K).
* Frequencies (§5.4): Vitis 165, TAPA 198, TAPA-CS 220 MHz.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import ResourceProfile, Task, TaskGraph

FREQS = {"F1-V": 165e6, "F1-T": 198e6, "FCS": 220e6}
K = 10
# Blue-module scaling (§5.4): 27 modules on one FPGA; 36/54/72 on 2/3/4.
BLUE = {1: 27, 2: 36, 3: 54, 4: 72, 8: 144}
SORT_CPP = 1.0      # sort cycles per point (O(N·K/PEs) with K folded in)


def hbm_eff(port_bits: int) -> float:
    return min(port_bits / 500.0, 1.0)


def design(ndev: int) -> dict:
    return {"blue": BLUE.get(ndev, 18 * ndev),
            "port": 256 if ndev == 1 else 512,
            "buffer_kb": 32 if ndev == 1 else 128}


def build_graph(ndev: int, n_points: int = 4_000_000, dim: int = 16
                ) -> TaskGraph:
    d = design(ndev)
    g = TaskGraph(f"knn-N{n_points}-D{dim}-x{ndev}")
    per_blue = n_points / d["blue"]
    for b in range(d["blue"]):
        g.add_task(Task(f"dist{b}", ResourceProfile(
            {"LUT": 22000, "DSP": 96, "BRAM": 40}),
            hbm_bytes=per_blue * dim * 4,
            meta={"cycles": per_blue * dim / 8,
                  "ops": 3 * per_blue * dim}))
    n_sort = max(1, d["blue"] // 3)
    for s in range(n_sort):
        g.add_task(Task(f"sort{s}", ResourceProfile(
            {"LUT": 15000, "DSP": 10, "BRAM": 30}),
            meta={"cycles": SORT_CPP * n_points / n_sort,
                  "ops": K * n_points / n_sort}))
    g.add_task(Task("agg", ResourceProfile({"LUT": 8000, "BRAM": 10}),
                    meta={"cycles": 1000.0 * ndev, "ops": K * 100}))
    for b in range(d["blue"]):
        s = b % n_sort
        g.add_channel(f"dist{b}", f"sort{s}", width_bits=512,
                      bytes_per_step=per_blue * 8)
    for s in range(n_sort):
        # Only K survivors cross to the aggregator — the paper's insight.
        g.add_channel(f"sort{s}", "agg", width_bits=64,
                      bytes_per_step=K * 8)
    return g


def modeled_latency(ndev: int, freq: float, n_points: int = 4_000_000,
                    dim: int = 16, devices_per_node: int = 4) -> float:
    d = design(ndev)
    shard = n_points / ndev
    # Distance phase: memory-bound stream of the shard, port-gated.
    dist_m = shard * dim * 4 / (460e9 * hbm_eff(d["port"]))
    dist_c = (shard * dim / 8) / ((d["blue"] / ndev) * freq)
    # Sort phase overlaps distance streaming (dataflow); aggregator adds a
    # small serial tail + K-sized transfers (constant in N, D).
    phase = max(dist_m, dist_c, SORT_CPP * shard / freq / (d["blue"] / 3))
    agg = 1e-4 + (ndev - 1) * (K * 8 / 12.5e9 + 1e-6)
    return phase + agg


def speedup_table(n_list=(1_000_000, 4_000_000, 8_000_000),
                  d_list=(2, 16, 128)) -> Dict[str, float]:
    out = {"F1-T": [], "F2": [], "F3": [], "F4": []}
    for n in n_list:
        for dim in d_list:
            base = modeled_latency(1, FREQS["F1-V"], n, dim)
            out["F1-T"].append(
                base / modeled_latency(1, FREQS["F1-T"], n, dim))
            for nd, key in ((2, "F2"), (3, "F3"), (4, "F4")):
                out[key].append(
                    base / modeled_latency(nd, FREQS["FCS"], n, dim))
    return {k: float(np.mean(v)) for k, v in out.items()}


# -- runnable numerics --------------------------------------------------------

def numeric_inputs(n: int = 2048, dim: int = 16, q: int = 32,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """The arrays :func:`run_numeric` searches, drawn from ``seed`` in this
    order: ``data`` [n, dim], then ``queries`` [q, dim], both fp32
    standard normal."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim), dtype=np.float32)
    queries = rng.standard_normal((q, dim), dtype=np.float32)
    return {"data": data, "queries": queries}


def run_numeric(n: int = 2048, dim: int = 16, q: int = 32, k: int = K,
                seed: int = 0, *, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runnable reduced-scale KNN on the fused kernel, unsharded: (dists
    [q, k], idx [q, k] int32); ``device`` as
    :func:`~repro_torch.exec.programs.resolve_device`."""
    from ..exec.programs import resolve_device
    from ..kernels import knn_op

    device = resolve_device(device)
    arrays = numeric_inputs(n, dim, q, seed)
    data = torch.from_numpy(arrays["data"]).to(device)
    queries = torch.from_numpy(arrays["queries"]).to(device)
    return knn_op(queries, data, k)


def make_inputs(graph: TaskGraph, spec=None) -> Dict[str, np.ndarray]:
    """The arrays :func:`bind_programs` uses, drawn from ``spec["seed"]`` in
    this order: ``data`` [n, dim], then ``queries`` [streams, q, dim], both
    fp32 standard normal."""
    spec = dict(spec or {})
    n, dim = spec.get("n", 1024), spec.get("dim", 8)
    q = spec.get("q", 8)
    streams = spec.get("streams", 2)
    rng = np.random.default_rng(spec.get("seed", 0))
    data = rng.standard_normal((n, dim), dtype=np.float32)
    queries = rng.standard_normal((streams, q, dim), dtype=np.float32)
    return {"data": data, "queries": queries}


def _merge_topk(parts, k: int):
    """Merge per-shard (dists, global_idx) candidates into the k smallest.

    A stable ascending sort keeps ``jax.lax.top_k``'s tie order (the lower
    position wins), which ``torch.topk`` does not promise; indices stay
    int32.
    """
    d = torch.cat([p[0] for p in parts], dim=1)
    gi = torch.cat([p[1] for p in parts], dim=1)
    kk = min(k, d.shape[1])
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :kk].contiguous(), torch.gather(gi, 1, pos[:, :kk])


def bind_programs(graph: TaskGraph, spec=None, *, device=None):
    """Executable bodies for the CHIP-KNN graph (repro_torch.exec hook).

    Each blue ``dist{b}`` module owns a contiguous dataset shard and emits
    its local top-k candidates from the fused KNN kernel (paper Fig. 4: only
    K survivors per module cross a channel); ``sort{s}`` merges its blues,
    ``agg`` merges the sorters — the distributed merge of per-shard top-k
    equals the global top-k.
    """
    from ..exec.programs import SOURCE_KEY, ProgramBinding, resolve_device
    from ..kernels import knn_op

    device = resolve_device(device)
    spec = dict(spec or {})
    n = spec.get("n", 1024)
    k = spec.get("k", K)
    blues = sorted((t for t in graph.tasks if t.startswith("dist")),
                   key=lambda t: int(t[len("dist"):]))
    sorters = sorted((t for t in graph.tasks if t.startswith("sort")),
                     key=lambda t: int(t[len("sort"):]))
    if n < len(blues):
        raise ValueError(f"n={n} points cannot fill {len(blues)} blue "
                         "modules")

    arrays = make_inputs(graph, spec)
    data = torch.from_numpy(arrays["data"]).to(device)
    queries = list(torch.from_numpy(arrays["queries"]).to(device).unbind(0))
    shards = np.array_split(np.arange(n), len(blues))

    def dist_body(shard_idx):
        lo, hi = int(shard_idx[0]), int(shard_idx[-1]) + 1
        shard = data[lo:hi]          # a contiguous row range: a view

        def body(inputs):
            d, li = knn_op(inputs[SOURCE_KEY], shard, min(k, hi - lo))
            return d, li + lo        # shard-local → global index, int32
        return body

    def merge_body(preds):
        def body(inputs):
            return _merge_topk([inputs[p] for p in preds], k)
        return body

    programs = {}
    for b, name in enumerate(blues):
        programs[name] = dist_body(shards[b])
    for s, name in enumerate(sorters):
        programs[name] = merge_body(
            [blues[b] for b in range(len(blues))
             if b % len(sorters) == s])
    programs["agg"] = merge_body(sorters)

    def reference():
        outs = [knn_op(qs, data, k) for qs in queries]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def finalize(sinks):
        return (torch.stack([d for d, _ in sinks["agg"]]),
                torch.stack([i for _, i in sinks["agg"]]))

    return ProgramBinding(
        graph=graph, programs=programs, iterations=len(queries),
        source_inputs={b: queries for b in blues},
        finalize=finalize, reference=reference, atol=1e-4)
