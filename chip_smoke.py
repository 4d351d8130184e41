"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` (one
   ``nvcc`` per source, in parallel) and prints ``ptxas -v`` on a fresh
   build (a spill in the tensor-core flash kernel's (192, 128) instance
   is a failure; the CUDA-core kernel's two (256, 256) instances, fp32
   and bf16, are printed on a line of their own); counts the ``HGMMA`` instructions that ``cuobjdump
   -sass`` finds in each of the three tensor-core flash attention
   instances (none is a failure).
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main path gives it (dilate bit for bit,
   NaN where both are NaN, on the main-path image, on an image with NaN,
   signed zeros, infinities and the largest finite values, and over 16
   passes; matmul within 2e-4 of the output's scale; knn distances within
   1e-4, indices equal wherever the neighbours' distances differ by more
   than that; axpy within 1 ulp, exact in practice; gemv within 1e-6 and
   dot_partials within ``dot_tol`` (6.5e-9 at a main-path block) of the
   sum of the absolute terms; all three bit for bit equal between the
   whole-array launch with ``block_rows = br`` and the per-shard
   launches; gemv's main-path shard on its 16-byte loads).  Timed beside
   the plain version, the one-call PyTorch yardstick where one exists, and
   the bound the card's data-sheet rates give (3.35 TB/s, 67 TFLOP/s
   fp32).  The three BLAS kernels and their calls are timed in 5
   alternating rounds (kernel, call, kernel, ...): ``ms`` and
   ``library_ms`` are the medians, each beside its min and max, and
   ``slower_than_library`` is true only when the kernel's fastest round is
   slower than the call's slowest.  ``ms``, ``plain_ms`` and
   ``library_ms`` are device times: many calls captured in one CUDA graph
   and replayed between CUDA events, so the host's launch overhead is left
   out.  Each row also carries ``device_kernels``: the mean device time of every
   ``__global__`` the wrapper launched, from ``torch.profiler`` (knn and
   dot_partials launch two passes); the knn row gives each pass's time as
   ``pass_ms`` and the bytes of the candidate lists pass 1 writes as
   ``partial_bytes``, at the shard and on the whole array.  KNN's general
   path (D > 64 or k > 32) is checked too, at small shapes.
4. Path: stencil, CNN and KNN each built at the app's own size, compiled
   onto a 4-FPGA ring with the executor smoke's options, and executed
   through ``compile()`` → ``execute()`` on the card.  Checks parity with
   the binding's single-device ``reference()``, every ``agreement()``
   value, no starvation, and that the app's kernel launched during
   ``execute`` (launch counts are zeroed just before it and read just
   after).  The HBM apps (axpy, dot, gemv, axpydot) at the width their
   graphs model (2^26 fp32 per vector; gemv 8192 x 8192) are compiled
   with a bank model (``MemConfig()``, so ``memory_feedback`` runs) and
   executed twice, through the bank model and on the ideal memory path;
   both must equal ``reference()`` bit for bit, with every ``agreement()``
   value true, and each kernel of the app must launch in each run.  Each
   path row gives the peak device bytes of its ``execute()`` beside the
   bytes already allocated when it began (``held_before_bytes``); the
   cuBLAS workspaces the kernel phase leaves are freed before the first
   path.  PageRank (no TPU kernel; fixed-order segment sums in PyTorch)
   runs ``build_graph(4)`` on cit-Patents' node and edge counts, drawn
   from the seed, for 20 iterations: executed twice on the ideal path
   (the two runs must give the same bits; the rank is held to
   ``reference()`` within 1e-5 of its largest value, and its L1 error is
   printed; the segment sums' device time of a third run comes from
   ``torch.profiler``), then compiled with the ring's fabric (so
   ``congestion_feedback`` runs) and executed through the flit transport,
   which must give the ideal path's bits with every ``agreement()`` value
   true and per-link bytes equal to the hop-weighted cut-set bytes.
5. LM serving path: qwen3-4b at its published width and depth (``full()``,
   bf16, weights from ``init_params`` with a seeded generator on the card).
   (a) ``build_prefill_step`` over 4 prompts of 2048 tokens, once to warm
   up and once timed, each launching ``flash_attention`` exactly 36 times
   (once per layer), all 36 on the tensor cores (``flash_attention_tc``;
   counts zeroed just before each call, read just after);
   (b) a ``ServingEngine(batch_slots=4, max_len=128)`` answering 4
   requests of 32 prompt tokens with 32 greedy new tokens.  Checks finite
   logits, tokens in range, the first token equal to the argmax of the
   sequential prefill.  Then the card's form of the prefill-against-decode
   parity: the same 32-token prompts through the prefill step (the kernel)
   and ``ServingEngine.prefill`` (sequential decode) in fp32 with
   ``num_superblocks = 4`` must agree within 1e-4 of the logits' largest
   magnitude, its 4 launches on the CUDA cores; the same comparison in
   bf16 at full depth is printed, not gated.
   (c) Three more rows the same way, each bf16 with weights drawn on the
   card from seed 0, each printing its parameters and their bytes, peak
   device bytes, prefill seconds, decode tokens/s, a step's wall and
   device ms and the flash launches by route: chatglm3-6b ``full()`` (28
   layers, G = 16; every launch on the tensor cores); deepseek-v2-236b at
   full width with 4 of its 60 layers and deepseek-v3-671b with 1 of its
   61 (one H100 holds 80 GB; their full depth is 446 and 1312 GiB of
   bf16 weights), each prefill launch on the tensor-core kernel's
   (192, 128) instance at MLA's q/k [4, 128, 2048, 192] and v [4, 128,
   2048, 128].  (d) MLA + MoE parity: deepseek-v2 in fp32 at full width
   with 1 layer, the prefill step (the CUDA-core kernel, expanded MLA)
   against ``ServingEngine.prefill`` (absorbed decode) on the 32-token
   prompts within 1e-4 of the logits' largest magnitude.  Only here ``capacity_factor`` is num_experts /
   top_k: any smaller capacity drops tokens in a 32-token prefill and
   none in decode, so the two paths would rightly differ.
   (e) The recurrent archs, as the rows of (c), at full width and depth:
   recurrentgemma-9b (38 layers, 17.5 GiB of bf16 weights; its 12
   local-attention layers launch the CUDA-core kernel's (256, 256)
   instance once each, none on the tensor cores; its RG-LRU layers none)
   and xlstm-1.3b (48 mLSTM and sLSTM layers, 3.4 GiB; no launch).  The
   engine keeps its cache from one request to the next, as JAX's does, so
   each engine call that a gate compares gets a fresh engine.  Then their
   fp32 parity as in (d): recurrentgemma at 1 super-block and its 2 extra
   layers (the GQA layer on the fp32 (256, 256) instance), xlstm at 1
   super-block (8 layers; the 32-token prefill is one mLSTM chunk).

6. Observability and snapshots (``[obs]`` lines; nothing compiled again
   that phase 4 compiled).  (a) The obs smoke's logic
   (``repro_torch.obs.smoke.check_app``) for stencil, CNN, KNN and
   PageRank at their binders' default sizes through the 4-ring fabric
   (``congestion_feedback`` compiled in): the traced run gives the
   untraced bits (compared as bit patterns) and counters, the trace's
   bytes equal the report's, the registry reconciles, the critical path
   sums to the makespan; the card's integer counters (sweeps, link bytes
   and flits, channel bytes and tokens, firings per device) equal the
   port's CPU run of the same design.  The partition MILP has tied
   optima that solver releases break differently, so stencil and PageRank
   run once more on the partition ``results/obs_baseline.json`` was taken
   at (``repro_torch.obs.smoke.BASELINE_PINS``), and those runs' metrics
   must pass the baseline (CNN's and KNN's drift from it is printed beside
   the JAX package's own).  (b) Phase 4's four designs at
   full size on the ideal path, untraced then traced: the same bits and
   counters, the event count and ``execute_s`` traced against untraced
   (two runs of each, in turns).
   (c) The full-size stencil killed by a ``FailureInjector`` after a
   ``checkpoint_every`` barrier and resumed with ``resume_execution``
   from a temporary directory: the uninterrupted run's bits, every
   ``agreement()`` value, dilate launched in the resumed run; prints the
   snapshot's bytes, the seconds to save it and to resume, and the extra
   sweeps.
7. The tenant server (``[tenants]`` lines).  (a) The tenant smoke's logic
   (``repro_torch.tenants.smoke.stencil_serves`` / ``bank_serves``) at the
   binders' default sizes, on the card and on the CPU: two stencil tenants
   on the shared 4-ring (placed ``[0, 2]`` and ``[0, 1]``, weights 2 and
   1), the clean co-run and a kill of device 2 at sweep 2 with recompile;
   then two ``axpy`` tenants over one shared ``MemConfig()`` bank model.
   Outputs bit-identical to the solo runs, conservation exact (bank bytes
   per tenant too), the ledger consistent; the card's counters (sweeps,
   per-link flow bytes, per-tenant link and bank bytes, statuses,
   ``killed_at``, ``recovered_as`` / ``recovered_via``, the ledgers) equal
   to the CPU run's; dilate (axpy) launched in each serve.  (b) Full
   width: two stencil tenants, each ``build_graph(2, iters=64)`` on a
   private 2-ring bound at phase 4's images (4096 x 4096 fp32, 2 images,
   ``stage_iters`` 16; seeds 0 and 7), on ``cluster_fabric(
   fpga_ring_cluster(4))``: the clean co-run, a permanent kill of device 2
   at half its sweeps (recompiled onto the survivor), and a transient kill
   there that restores from a sweep barrier (``checkpoint_every`` = half
   the kill sweep, snapshots in a temporary directory).  Every finished
   tenant has its solo ideal-path bits (the recompiled one its
   ``reference()`` within ``atol``), conservation is exact, the ledger is
   consistent and the peer is charged zero, dilate launches in each run
   (counts zeroed and read around ``run()``).  Prints sweeps,
   ``wall_time_s``, each tenant's latency in sweeps and goodput, the
   snapshot bytes and the restore sweeps.
8. The chaos harness (``[chaos]`` lines), at the binders' default sizes:
   the chaos smoke's reduced matrix (drop-mid, down-window, link-death,
   kill-restore) on stencil; drop-mid and kill-restore on CNN, KNN and
   PageRank, on the designs phase 6 compiled; the two per-tenant cells
   (tenant-drop, tenant-kill).  Each cell's record (sweeps, overhead
   sweeps, retransmit and goodput-hop bytes, restore sweeps, the ledger of
   a tenant cell) must equal the port's CPU run of the same cell: the
   faults are drawn on the host from the scenario's seed.  dilate, matmul
   and knn must each launch in their app's cells.

The flash attention row (phase 3) holds both kernels, on the same bf16
inputs, to their plain version at the prefill step's shape (causal), at
chatglm3-6b's prefill shape (32 query heads on 2 KV heads, G = 16, over
all 16 key tiles; causal) and at the feature cases of ``kernels/flash_attention/cases.py`` (GQA, MQA,
Sq < Sk, ragged lengths, window, softcap, both, non-causal, a fully masked
leading block) at d = 128 and d = 64: elementwise within
atol = rtol = 2e-2, each row within 1e-2 of its norm, and the tensor cores
no further than twice the CUDA-core kernel's error from the fp32 plain
version.  Two planted faults at the main shape (the last query block
without its first or its diagonal key tile) must fail the row check.  The
same cases in fp32 at d = 32, 64 and 128 go to the CUDA cores (within
2e-5).  It also times the CUDA-core kernel and a non-causal call at the
main shape.  Its yardstick is ``F.scaled_dot_product_attention``
(``is_causal=True, enable_gqa=True``), its bound the bf16 tensor-core rate
(989 TFLOP/s) over the visible (query, key) pairs.  The matmul row names
the kernel each of its two shapes takes (narrow at N = 4, tiled at
N = 80), checks that two runs agree bit for bit, and times the tiled
kernel at N = 4 beside the narrow one.  The ``flash_attention_mla`` row
holds both kernels' (192, 128) instances at MLA's shape (causal) and at
every feature case at d = 192, dv = 128: bf16 on the tensor cores under
the flash row's gates (and its two planted faults at MLA's shape), fp32
on the CUDA cores within 2e-5; the tensor cores must take at most a
tenth of the CUDA cores' time at MLA's shape.  Its bound counts 2·(d + dv)
operations a visible pair at the bf16 tensor-core rate, its yardstick is
``F.scaled_dot_product_attention(is_causal=True)``, timed with CUDA
events around 10 back-to-back calls.  After the build, ``ptxas``
registers and spills of each flash_kernel and flash_sm90_kernel instance
are printed.

The ``flash_attention_hd256`` row holds the CUDA-core kernel's (256, 256)
instance at recurrentgemma-9b's prefill shape (q [4, 16, 2048, 256], k, v
[4, 1, 2048, 256], causal, window 2048) in bf16 (elementwise and row by
row, with the two planted faults) and fp32 (within 2e-5), at B 1, S 4096,
where the window bites, and at ``cases.HD256_CASES`` in both dtypes.  Its
bound counts 2·(d + dv) operations a visible pair at the bf16 tensor-core
rate, its yardstick is ``F.scaled_dot_product_attention(is_causal=True,
enable_gqa=True)``.

Prints the ``kernels`` JSON line, then the card line, and last
``{"ok": true, "device": {...}}``.  Needs no network and one card.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Data-sheet peaks of one H100 SXM (dense, at the full 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12          # tensor cores, dense

SMOKE_OPTIONS = dict(balance_kind="LUT", balance_tol=0.8,
                     floorplan_devices=(0,), exact_limit=1500)
STENCIL_SPEC = {"h": 4096, "w": 4096, "stage_iters": 16, "streams": 2,
                "seed": 0}
CNN_SPEC = {"h": 32, "w": 32, "cin": 64, "cout_per_col": 4, "streams": 32,
            "seed": 0}
KNN_SPEC = {"n": 4_000_000, "dim": 16, "q": 128, "k": 10, "streams": 2,
            "seed": 0}
# PageRank on the node and edge counts of DATASETS["cit-Patents"] (drawn
# from the seed; nothing is downloaded), for the model's ITERS = 20.
PAGERANK_SPEC = {"n_nodes": 3_774_768, "n_edges": 16_518_948, "iters": 20,
                 "seed": 0}
PAGERANK_REL_TOL = 1e-5
# The three kernel apps of the path phase: (app, spec, kernel), and the
# build_graph arguments of all four (the obs phase traces these designs).
FULL_SIZE = (("stencil", STENCIL_SPEC, "dilate"), ("cnn", CNN_SPEC, "matmul"),
             ("knn", KNN_SPEC, "knn"))
GRAPH_ARGS = {"stencil": (4, 64), "cnn": (4,), "knn": (4,), "pagerank": (4,)}
# The full-width tenants: each stencil tenant is build_graph(2, iters=64)
# on a private 2-ring, bound at STENCIL_SPEC's images.
GRAPH_ARGS_TENANT = (2, 64)
SPECS = {"stencil": STENCIL_SPEC, "cnn": CNN_SPEC, "knn": KNN_SPEC,
         "pagerank": PAGERANK_SPEC}
OBS_APPS = ("stencil", "cnn", "knn", "pagerank")
# The committed obs baseline holds for these apps at its own partition;
# cnn and knn drift from it for the JAX package itself (ROADMAP, reference
# caveat 5), so the card holds them to the port's CPU run, which the CPU
# tests hold to JAX.
BASELINE_APPS = ("stencil", "pagerank")
JAX_BASELINE_DRIFT = {
    "cnn": "JAX package on CPU: exec.device.fired 16/12/2/10 -> 2/2/18/18, "
           "channels 4, 5, 11 -> 0, 1, 10",
    "knn": "JAX package on CPU: exec.device.fired{device=0} 64 -> 56, "
           "channels 75, 76, 89, 95 -> 82, 84, 85, 86"}
# The HBM apps at their graphs' modelled width: N_FULL = 2^26 fp32 per
# vector as [524288, 128]; gemv's M_FULL^2 matrix as [8192, 8192].  Three
# firings each on a 4-FPGA ring: 8 shards, br = 65536 rows (gemv 1024).
VEC_SPEC = {"rows": 524288, "lanes": 128, "streams": 3, "seed": 0}
GEMV_SPEC = {"rows": 8192, "lanes": 8192, "streams": 3, "seed": 0}
HBM_SHARDS = 8
# The LM serving path: qwen3-4b's prefill step over 4 prompts of 2048
# tokens gives the flash kernel q [4, 32, 2048, 128] and k, v
# [4, 8, 2048, 128] (bf16, causal); the engine serves 4 requests of 32
# prompt tokens with 32 new tokens.
LM_ARCH = "qwen3-4b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 32, 32, 128
PARITY_SUPERBLOCKS = 4
# The LM rows after qwen3-4b: (arch, superblocks to keep or None for full
# depth, the flash route every prefill launch takes, the kernels line's row
# that counts those launches, the note beside it).
LM_ROWS = (
    ("chatglm3-6b", None, "tensor_core", "flash_attention",
     "full depth, 28 layers"),
    ("deepseek-v2-236b", 4, "tensor_core", "flash_attention_mla",
     "full width, depth cut from 60 to 4 layers: one H100 holds 80 GB, "
     "the 60 layers are 446 GiB of bf16 weights"),
    ("deepseek-v3-671b", 1, "tensor_core", "flash_attention_mla",
     "full width, depth cut from 61 to 1 layer: one H100 holds 80 GB, "
     "the 61 layers are 1312 GiB of bf16 weights"),
    ("recurrentgemma-9b", None, "cuda_core", "flash_attention_hd256",
     "full depth, 38 layers: 26 RG-LRU and 12 local-attention layers "
     "(head dim 256, one kv head, window 2048)"),
    ("xlstm-1.3b", None, "none", None,
     "full depth, 48 layers: 42 mLSTM and 6 sLSTM, no attention"),
)
# The recurrent archs' fp32 prefill-against-decode parity: (arch,
# superblocks kept, prompt tokens).  recurrentgemma keeps its 2 extra
# layers, so its GQA layer runs the fp32 (256, 256) instance; xlstm's one
# super-block is 8 layers, its 32-token prefill one mLSTM chunk and its
# 1024-token prefill two 512-token chunks, whose (C, n, m) carry decode
# must reproduce.
RECURRENT_PARITY = (("recurrentgemma-9b", 1, SERVE_PROMPT),
                    ("xlstm-1.3b", 1, SERVE_PROMPT), ("xlstm-1.3b", 1, 1024))
# recurrentgemma-9b's local attention: q [B, 16, S, 256], k, v
# [B, 1, S, 256], window 2048; the window bites at S = 4096.
HD256_HEADS, HD256_KV_HEADS, HD256_D, HD256_WINDOW = 16, 1, 256, 2048
MLA_PARITY_ARCH, MLA_PARITY_SUPERBLOCKS = "deepseek-v2-236b", 1
# MLA's prefill operands at full width: q, k [B, 128, S, 192] and v
# [B, 128, S, 128].
MLA_HEADS, MLA_D, MLA_DV = 128, 192, 128
# The flash feature cases run in fp32 at these head dims (the CUDA cores)
# and in bf16 at the tensor cores' two.
FLASH_FP32_DIMS = (32, 64, 128)
FLASH_BF16_DIMS = (128, 64)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def side_stream() -> torch.cuda.Stream:
    """The one stream that warms up every graph before its capture.  A new
    stream per timing would cost a cuBLAS workspace each (32 MiB on the
    H100), held until the process ends."""
    return torch.cuda.Stream()


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device time of one call of ``fn``: ``fn(0) .. fn(reps - 1)``
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events.  The host's launch overhead is left out; ``fn(i)`` may pick
    its operands by ``i`` (so a call can find them cold in L2)."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def device_kernels(fn, reps: int = 20) -> list:
    """``[name, count, mean ms]`` of every CUDA kernel ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [[e.key, e.count, e.device_time_total / e.count / 1e3]
            for e in prof.key_averages()
            if e.count and e.device_time_total > 0]


def device_breakdown(fn, top: int = 6, match: str = "") -> dict:
    """Device time of one call of ``fn``, from ``torch.profiler``: the sum
    over every kernel, and the ``top`` kernels by their summed time as
    ``[name, count, ms]``.  With ``match``, also the summed time and count
    of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(([e.key, e.count, e.device_time_total / 1e3]
                   for e in prof.key_averages()
                   if e.count and e.device_time_total > 0),
                  key=lambda r: -r[2])
    out = {"device_ms": sum(r[2] for r in rows),
           "top": [[r[0][:90], r[1], r[2]] for r in rows[:top]]}
    if match:
        hit = [r for r in rows if match in r[0]]
        out["matched_ms"] = sum(r[2] for r in hit)
        out["matched_launches"] = sum(r[1] for r in hit)
    return out


def aten_ops(fn) -> int:
    """ATen operators that ``fn`` dispatches: each costs the host a pass
    through PyTorch's dispatcher, and most launch a kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def hgmma_counts(lib_path: Path) -> dict:
    """HGMMA (wgmma) instructions in each kernel of the built library whose
    SASS has any, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
        elif current is not None and "HGMMA" in line:
            counts[current] = counts.get(current, 0) + 1
    return counts


def ptxas_report(log: str, match: str) -> dict:
    """Registers, spill bytes and stack of each kernel whose mangled name
    holds ``match``, from the ``ptxas -v`` lines of a build log."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            current = name if match in name else None
        elif current is None:
            continue
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out.setdefault(current, {}).update(
                stack_bytes=nums[0], spill_store_bytes=nums[1],
                spill_load_bytes=nums[2])
        elif "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            out.setdefault(current, {})["registers"] = regs
    return out


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_FP32_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_index_check(q, data, got_i, ref_d, ref_i, tol) -> int:
    """Positions whose index differs from the plain version's, and whose
    point is not within ``tol`` of the plain version's distance there (a
    near-tie may order either way).  Returns their count."""
    diff = got_i != ref_i
    if not bool(diff.any()):
        return 0
    pts = data[got_i.long()].double()                 # [Q, k, D]
    true_d = ((q.double()[:, None, :] - pts) ** 2).sum(-1)
    bad = diff & ((true_d - ref_d.double()).abs() > tol)
    return int(bad.sum())


def knn_pass_ms(kernels: list) -> dict:
    """Mean device time of each KNN pass, from ``device_kernels`` rows."""
    passes = {"knn_range_kernel": "range_pass", "knn_merge_kernel": "merge"}
    return {label: ms for key, label in passes.items()
            for name, _, ms in kernels if key in name}


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_phase(dev) -> dict:
    from repro_torch.kernels import (build, conv_op, dilate_op, knn_op,
                                     matmul_op)
    from repro_torch.kernels.knn.ref import knn_ref
    from repro_torch.kernels.stencil_dilate.images import dilate_image
    from repro_torch.kernels.stencil_dilate.ref import (bit_mismatches,
                                                        dilate_ref)
    from repro_torch.kernels.systolic_matmul.kernel import route as mm_route
    from repro_torch.kernels.systolic_matmul.ref import im2col3x3, matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False     # full fp32 yardstick
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # dilate: one pass over a 4096 x 4096 image, the stencil's tile height,
    # held to the plain version bit for bit (NaN where both are NaN) on the
    # main-path image and on two with NaN, signed zeros, infinities and
    # the largest finite values (``dilate_image``'s ``specials`` and
    # ``zeros_and_negatives``); then 16 passes, as a stage runs them.
    h = w = STENCIL_SPEC["h"]
    br = min(128, h)
    img = torch.randn(h, w, device=dev, generator=gen)
    mismatches = {"main": bit_mismatches(
        dilate_op(img, iters=1, block_rows=br), dilate_ref(img))}
    for kind in ("specials", "zeros_and_negatives"):
        special = torch.from_numpy(dilate_image(kind, h, w, seed=0)).to(dev)
        mismatches[kind] = bit_mismatches(
            dilate_op(special, iters=1, block_rows=br), dilate_ref(special))
    got16 = dilate_op(img, iters=STENCIL_SPEC["stage_iters"], block_rows=br)
    ref16 = img
    for _ in range(STENCIL_SPEC["stage_iters"]):
        ref16 = dilate_ref(ref16)
    mismatches["16_passes"] = bit_mismatches(got16, ref16)
    require(sum(mismatches.values()) == 0,
            f"dilate differs from its plain version: {mismatches} elements")
    out = torch.empty_like(img)
    from repro_torch.kernels.stencil_dilate.kernel import dilate

    def one_pass():
        return dilate(img, out, block_rows=br)

    ms = graph_ms(lambda i: one_pass(), 50)
    plain = graph_ms(lambda i: dilate_ref(img), 10)
    b, by = bound(2 * h * w * 4, 12 * h * w)
    rows["dilate"] = dict(shape=[h, w], max_abs_err=sum(mismatches.values()),
                          mismatches=mismatches, ms=ms,
                          plain_ms=plain, bound_ms=b, bound_by=by,
                          library_ms=None, bytes=2 * h * w * 4,
                          ops=12 * h * w,
                          device_kernels=device_kernels(one_pass))

    # matmul: the CNN column's im2col product and the reference's.
    hh, cin, cpc = CNN_SPEC["h"], CNN_SPEC["cin"], CNN_SPEC["cout_per_col"]
    x = torch.randn(hh, hh, cin, device=dev, generator=gen)
    cols = im2col3x3(x)                                # [1024, 576]
    M, K = cols.shape
    errs, routes = {}, {}
    for N in (cpc, 20 * cpc):
        wt = torch.randn(K, N, device=dev, generator=gen) * 0.05
        got = matmul_op(cols, wt)
        ref = matmul_ref(cols, wt)
        err = float((got - ref).abs().max())
        errs[N] = err
        routes[f"[{M},{K}]x[{K},{N}]"] = mm_route(M, K, N)
        scale = max(1.0, float(ref.abs().max()))
        require(err <= 2e-4 * scale,
                f"matmul [{M},{K}]x[{K},{N}] err {err:.3e} > 2e-4*{scale:.2f}")
        require(torch.equal(got, matmul_op(cols, wt)),
                f"matmul [{M},{K}]x[{K},{N}]: two runs differ")
    require(mm_route(M, K, cpc) == "narrow"
            and mm_route(M, K, 20 * cpc) == "tiled",
            f"matmul routes {routes}: the CNN's N = {cpc} goes to the narrow "
            f"kernel, N = {20 * cpc} to the tiled one")
    wt = torch.randn(K, cpc, device=dev, generator=gen) * 0.05
    wconv = wt.reshape(3, 3, cin, cpc)
    conv_err = float((conv_op(x, wconv)
                      - matmul_ref(cols, wt).reshape(hh, hh, cpc)).abs().max())
    require(conv_err <= 2e-4, f"conv err {conv_err:.3e}")
    from repro_torch.kernels.systolic_matmul.kernel import (_launch_tiled,
                                                            matmul)
    ms = graph_ms(lambda i: matmul(cols, wt), 200)
    tiled_ms = graph_ms(lambda i: _launch_tiled(cols, wt), 200)
    plain = graph_ms(lambda i: matmul_ref(cols, wt), 200)
    lib = graph_ms(lambda i: torch.matmul(cols, wt), 200)
    nbytes = 4 * (M * K + K * cpc + M * cpc)
    ops = 2 * M * K * cpc
    b, by = bound(nbytes, ops)
    rows["matmul"] = dict(shape=[M, K, cpc], max_abs_err=errs[cpc], ms=ms,
                          plain_ms=plain, bound_ms=b,
                          bound_by=by,
                          library_ms=lib, bytes=nbytes, ops=ops,
                          routes=routes, two_runs_equal=True,
                          tiled_ms=tiled_ms,
                          max_abs_err_reference_shape=errs[20 * cpc],
                          device_kernels=device_kernels(
                              lambda: matmul(cols, wt)))

    # knn: a blue module's shard and the whole dataset (the reference).
    n, dim, q, k = (KNN_SPEC[s] for s in ("n", "dim", "q", "k"))
    data = torch.randn(n, dim, device=dev, generator=gen)
    queries = torch.randn(q, dim, device=dev, generator=gen)
    shard_n = -(-n // 72)
    checks = {}
    for name, pts in (("shard", data[:shard_n]), ("full", data)):
        gd, gi = knn_op(queries, pts, k)
        rd, ri = knn_ref(queries, pts, k)
        require(gi.dtype == torch.int32 and gd.dtype == torch.float32,
                "knn output types")
        derr = float((gd - rd).abs().max())
        require(derr <= 1e-4, f"knn {name} distance err {derr:.3e}")
        bad = knn_index_check(queries, pts, gi, rd, ri, 1e-4)
        require(bad == 0, f"knn {name}: {bad} indices differ beyond ties")
        checks[name] = (derr, int((gi != ri).sum()))
    # The general path (D > 64 or k > 32), at small shapes; the data are
    # scaled so the distances stay O(10), where fp32 rounding of either
    # side's sums stays well inside the 1e-4 tolerance.
    general = {}
    for gq, gn, gdim, gk in ((130, 20_000, 128, 10), (64, 20_000, 16, 64),
                             (33, 3_000, 100, 40)):
        gx = torch.randn(gn, gdim, device=dev, generator=gen) * 0.2
        gqs = torch.randn(gq, gdim, device=dev, generator=gen) * 0.2
        gd, gi = knn_op(gqs, gx, gk)
        rd, ri = knn_ref(gqs, gx, gk)
        derr = float((gd - rd).abs().max())
        require(gi.dtype == torch.int32 and derr <= 1e-4,
                f"knn general Q{gq} N{gn} D{gdim} k{gk}: err {derr:.3e}")
        bad = knn_index_check(gqs, gx, gi, rd, ri, 1e-4)
        require(bad == 0, f"knn general D{gdim} k{gk}: {bad} indices differ")
        general[f"Q{gq} N{gn} D{gdim} k{gk}"] = derr
    from repro_torch.kernels.knn.kernel import knn, partial_bytes
    shard = data[:shard_n]
    ms = graph_ms(lambda i: knn(queries, shard, k), 100)
    plain = graph_ms(lambda i: knn_ref(queries, shard, k), 20)
    ms_full = cuda_ms(lambda: knn(queries, data, k), 10)
    plain_full = cuda_ms(lambda: knn_ref(queries, data, k), 3)

    def knn_cost(npts):
        nbytes = 4 * (q * dim + npts * dim) + 8 * q * k
        ops = q * npts * (2 * dim + 4) + 2 * dim * (npts + q)
        return nbytes, ops

    nbytes, ops = knn_cost(shard_n)
    b, by = bound(nbytes, ops)
    fb, fops = knn_cost(n)
    b_full, by_full = bound(fb, fops)
    shard_kernels = device_kernels(lambda: knn(queries, shard, k))
    full_kernels = device_kernels(lambda: knn(queries, data, k), 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = build.library().repro_knn_tile()
    rows["knn"] = dict(shape=[q, shard_n, dim, k],
                       max_abs_err=checks["shard"][0], ms=ms,
                       plain_ms=plain, bound_ms=b,
                       bound_by=by,
                       library_ms=None, bytes=nbytes, ops=ops,
                       index_diffs_at_ties=checks["shard"][1],
                       device_kernels=shard_kernels,
                       pass_ms=knn_pass_ms(shard_kernels),
                       partial_bytes=partial_bytes(shard_n, q, k, sms, tile),
                       general_path_max_abs_err=general,
                       full=dict(shape=[q, n, dim, k],
                                 max_abs_err=checks["full"][0],
                                 index_diffs_at_ties=checks["full"][1],
                                 ms=ms_full, plain_ms=plain_full,
                                 bound_ms=b_full, bound_by=by_full,
                                 device_kernels=full_kernels,
                                 pass_ms=knn_pass_ms(full_kernels),
                                 partial_bytes=partial_bytes(n, q, k, sms,
                                                             tile)))
    rows.update(blas_kernel_rows(dev, gen))
    rows["flash_attention"] = flash_kernel_row(dev, gen)
    rows["flash_attention_mla"] = flash_mla_row(dev, gen)
    t0 = time.perf_counter()
    rows["flash_attention_hd256"] = flash_hd256_row(dev, gen)
    rows["flash_attention_hd256"]["row_s"] = time.perf_counter() - t0
    for name, row in rows.items():
        print(f"[kernel] {name} {json.dumps(row)}", flush=True)
    return rows


def visible_pairs(Sq: int, Sk: int, causal: bool = True) -> int:
    """(query, key) pairs that causal end-aligned masking leaves."""
    if not causal:
        return Sq * Sk
    delta = Sk - Sq
    return sum(max(0, min(Sk, i + delta + 1)) for i in range(Sq))


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def norm_rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def flash_fp32_check(label, q, k, v, **kw) -> float:
    """flash_attention in fp32 on the CUDA cores, within FP32_ATOL of the
    plain version and of its shape.  Returns the error."""
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    require(route(q, k, v) == "cuda_core",
            f"flash_attention fp32 {label} not on the CUDA cores")
    got = flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    require(got.shape == want.shape,
            f"flash_attention fp32 {label}: shape {tuple(got.shape)}")
    err = max_abs(got, want)
    require(err <= cases.FP32_ATOL,
            f"flash_attention fp32 {label}: err {err:.3e}")
    return err


def flash_bf16_check(label, q, k, v, expect="tensor_core", **kw) -> tuple:
    """flash_attention on bf16 inputs, routed to ``expect``, held to the
    plain version elementwise and row by row.  Where that is the tensor
    cores, the CUDA cores run too under the same gates, and the tensor
    cores must be at most twice the CUDA cores' error from the fp32 plain
    version (both round p and the output at the same places).  The output
    must be [B, H, Sq, dv].  Returns the readings by kernel ("tc", "cc"),
    the routed kernel's output and the plain one."""
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (
        _launch_cuda_core, flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    require(route(q, k, v) == expect,
            f"flash_attention bf16 {label} not routed to {expect}")
    want = attention_ref(q, k, v, **kw)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    kernels = (("tc", flash_attention), ("cc", _launch_cuda_core)) \
        if expect == "tensor_core" else (("cc", flash_attention),)
    out, reading = None, {}
    for name, launch in kernels:
        got = launch(q, k, v, **kw)
        require(got.shape == want.shape and got.dtype == q.dtype,
                f"flash_attention bf16 {label} ({name}): "
                f"{tuple(got.shape)} {got.dtype}")
        r = dict(max_abs_err=max_abs(got, want),
                 row_rel_err=cases.row_rel_err(got, want),
                 norm_rel_err=norm_rel(got, want),
                 vs_fp32=max_abs(got, exact))
        excess = cases.excess(got, want)
        require(excess <= cases.ATOL,
                f"flash_attention bf16 {label} ({name}): |got - ref| "
                f"exceeds {cases.ATOL} + {cases.RTOL} |ref| by "
                f"{excess - cases.ATOL:.3e}")
        require(r["row_rel_err"] <= cases.ROW_REL_LIMIT,
                f"flash_attention bf16 {label} ({name}): a row is "
                f"{r['row_rel_err']:.3e} of its norm from the plain "
                f"version > {cases.ROW_REL_LIMIT}")
        reading[name] = r
        out = got if out is None else out
    if "tc" in reading:
        require(reading["tc"]["vs_fp32"] <= 2 * reading["cc"]["vs_fp32"],
                f"flash_attention bf16 {label}: tensor cores "
                f"{reading['tc']['vs_fp32']:.3e} from fp32, CUDA cores "
                f"{reading['cc']['vs_fp32']:.3e}")
    return reading, out, want


def planted_faults(label, q, k, v, got, want) -> dict:
    """The tensor cores' output ``got`` with the last query block's rows
    recomputed without one of their key tiles, as a kernel that skipped
    that tile would give them (q, k, v causal with Sq = Sk).  The row gate
    must reject each; the elementwise gate's reading is printed beside
    it."""
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.ref import attention_ref

    S, T = q.shape[2], 128
    planted = {}
    for name, (kk, vv, causal) in {
            "skips_first_tile": (k[:, :, T:], v[:, :, T:], True),
            "skips_diagonal_tile": (k[:, :, :S - T], v[:, :, :S - T],
                                    False)}.items():
        bad = got.clone()
        bad[:, :, S - T:] = attention_ref(q[:, :, S - T:], kk, vv,
                                          causal=causal)
        planted[name] = dict(row_rel_err=cases.row_rel_err(bad, want),
                             norm_rel_err=norm_rel(bad, want),
                             excess=cases.excess(bad, want))
        require(planted[name]["row_rel_err"] > cases.ROW_REL_LIMIT,
                f"{label}: the row gate passes the planted fault {name} "
                f"({planted[name]})")
        del bad
    return planted


def flash_kernel_row(dev, gen) -> dict:
    """flash_attention at the prefill step's shape in bf16 (causal) on the
    tensor cores, with two planted faults that its row gate must reject,
    and at chatglm3-6b's prefill shape (G = 16) with the same gates; each
    feature case in fp32 on the CUDA cores and in bf16 on the tensor
    cores."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (
        _launch_cuda_core, flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    fp32_cases, bf16_cases = {}, {}
    for name, (B, H, K, Sq, Sk), kw in cases.FEATURE_CASES:
        for d in FLASH_FP32_DIMS:
            q = torch.randn(B, H, Sq, d, device=dev, generator=gen)
            k = torch.randn(B, K, Sk, d, device=dev, generator=gen)
            v = torch.randn(B, K, Sk, d, device=dev, generator=gen)
            label = f"{name} d{d}"
            fp32_cases[label] = flash_fp32_check(label, q, k, v, **kw)
        for d in FLASH_BF16_DIMS:
            q, k, v = (torch.randn(B, n, S, d, device=dev,
                                   generator=gen).to(torch.bfloat16)
                       for n, S in ((H, Sq), (K, Sk), (K, Sk)))
            label = f"{name} d{d}"
            bf16_cases[label] = flash_bf16_check(label, q, k, v, **kw)[0]

    def prefill_qkv(H, K, d):
        """As the model gives them: [B, S, H, d] seen as [B, H, S, d]."""
        return (torch.randn(PREFILL_BATCH, PREFILL_LEN, n, d, device=dev,
                            generator=gen).to(torch.bfloat16).transpose(1, 2)
                for n in (H, K, K))

    # chatglm3-6b's prefill: 32 query heads on 2 KV heads (G = 16) over
    # all 16 key tiles, with the same gates as the main shape.
    glm = get_arch("chatglm3-6b").full()
    glm_shape, _, _ = flash_bf16_check(
        "chatglm3-6b shape",
        *prefill_qkv(glm.num_heads, glm.num_kv_heads, glm.head_dim))

    B, S = PREFILL_BATCH, PREFILL_LEN
    H, K, d = 32, 8, 128
    q, k, v = prefill_qkv(H, K, d)
    main, got, want = flash_bf16_check("main shape", q, k, v)
    planted = planted_faults("flash_attention", q, k, v, got, want)
    del got, want
    nbytes = 2 * 2 * (q.numel() + k.numel())          # q, o; k, v
    ops = 4 * B * H * d * visible_pairs(S, S)
    b, by = bound(nbytes, ops, PEAK_BF16_PER_S)
    ms = graph_ms(lambda i: flash_attention(q, k, v), 10, replays=3)
    cuda_core_ms = graph_ms(lambda i: _launch_cuda_core(q, k, v), 4,
                            replays=2)
    # Without the mask every block walks all 16 key tiles: the time per
    # tile without the short causal blocks' fixed costs.
    noncausal_ms = graph_ms(
        lambda i: flash_attention(q, k, v, causal=False), 10, replays=3)
    plain = cuda_ms(lambda: attention_ref(q, k, v), 3, warmup=1)
    lib = graph_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20, replays=3)
    return dict(shape=[B, H, K, S, S, d], dtype="bf16", causal=True,
                kernel=route(q, k, v),
                max_abs_err=main["tc"]["max_abs_err"], main=main,
                chatglm3_6b_shape=dict(
                    shape=[PREFILL_BATCH, glm.num_heads, glm.num_kv_heads,
                           PREFILL_LEN, PREFILL_LEN, glm.head_dim],
                    **glm_shape),
                atol=cases.ATOL, rtol=cases.RTOL,
                row_rel_limit=cases.ROW_REL_LIMIT, planted_faults=planted,
                bf16_cases=bf16_cases, fp32_max_abs_err=fp32_cases, ms=ms,
                tflops=ops / ms / 1e9, cuda_core_ms=cuda_core_ms,
                noncausal_ms=noncausal_ms,
                noncausal_tflops=4 * B * H * d * S * S / noncausal_ms / 1e9,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                library="F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), bf16",
                bytes=nbytes, ops=ops,
                device_kernels=device_kernels(
                    lambda: flash_attention(q, k, v), 5))


def flash_mla_row(dev, gen) -> dict:
    """flash_attention at MLA's prefill shape (causal; [B, S, H, d] tensors
    seen as [B, H, S, d], as the model gives them): bf16 on the tensor
    cores' (192, 128) instance under the flash row's gates (both kernels
    against the plain version, the tensor cores within twice the CUDA
    cores' error from fp32), with the two planted faults; fp32 on the
    CUDA cores' (192, 128) instance within FP32_ATOL; and every feature
    case at d = 192, dv = 128 in both dtypes.  Times the tensor cores, the
    CUDA cores, a non-causal call, the plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (
        _launch_cuda_core, flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def qkv(B, H, K, Sq, Sk, dtype, bshd=False):
        def one(n, S, d):
            if bshd:
                t = torch.randn(B, S, n, d, device=dev, generator=gen)
                return t.to(dtype).transpose(1, 2)
            return torch.randn(B, n, S, d, device=dev,
                               generator=gen).to(dtype)
        return one(H, Sq, MLA_D), one(K, Sk, MLA_D), one(K, Sk, MLA_DV)

    fp32_cases, bf16_cases = {}, {}
    for name, (B, H, K, Sq, Sk), kw in cases.FEATURE_CASES:
        fp32_cases[name] = flash_fp32_check(
            f"MLA {name}", *qkv(B, H, K, Sq, Sk, torch.float32), **kw)
        bf16_cases[name] = flash_bf16_check(
            f"MLA {name}", *qkv(B, H, K, Sq, Sk, torch.bfloat16), **kw)[0]

    B, S, H = PREFILL_BATCH, PREFILL_LEN, MLA_HEADS
    q, k, v = qkv(B, H, H, S, S, torch.float32, bshd=True)
    fp32_err = flash_fp32_check("MLA main shape", q, k, v)
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = qkv(B, H, H, S, S, torch.bfloat16, bshd=True)
    main, got, want = flash_bf16_check("MLA main shape", q, k, v)
    require(got.transpose(1, 2).is_contiguous(),
            "flash_attention_mla: the output is not laid out like q")
    planted = planted_faults("flash_attention_mla", q, k, v, got, want)
    del got, want
    torch.cuda.empty_cache()
    out_numel = B * H * S * MLA_DV
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out_numel)
    ops = 2 * (MLA_D + MLA_DV) * B * H * visible_pairs(S, S)
    b, by = bound(nbytes, ops, PEAK_BF16_PER_S)
    ms = graph_ms(lambda i: flash_attention(q, k, v), 10, replays=3)
    ms_events = cuda_ms(lambda: flash_attention(q, k, v), 10)
    cuda_core_ms = graph_ms(lambda i: _launch_cuda_core(q, k, v), 3,
                            replays=2)
    require(ms <= cuda_core_ms / 10,
            f"flash_attention_mla: the tensor cores take {ms:.4f} ms, more "
            f"than a tenth of the CUDA cores' {cuda_core_ms:.4f} ms")
    noncausal_ms = graph_ms(
        lambda i: flash_attention(q, k, v, causal=False), 10, replays=3)
    plain = cuda_ms(lambda: attention_ref(q, k, v), 2, warmup=1)
    torch.cuda.empty_cache()
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10, warmup=2)
    return dict(shape=[B, H, H, S, S, MLA_D, MLA_DV], dtype="bf16",
                causal=True, kernel=route(q, k, v),
                max_abs_err=main["tc"]["max_abs_err"], main=main,
                atol=cases.ATOL, rtol=cases.RTOL,
                row_rel_limit=cases.ROW_REL_LIMIT, planted_faults=planted,
                bf16_cases=bf16_cases, fp32_max_abs_err=fp32_err,
                fp32_cases=fp32_cases, ms=ms, ms_events=ms_events,
                tflops=ops / ms / 1e9, cuda_core_ms=cuda_core_ms,
                noncausal_ms=noncausal_ms,
                noncausal_tflops=(2 * (MLA_D + MLA_DV) * B * H * S * S
                                  / noncausal_ms / 1e9),
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                library="F.scaled_dot_product_attention(is_causal=True), "
                        "bf16; 10 back-to-back calls between CUDA events "
                        "(ms_events times the kernel the same way)",
                bytes=nbytes, ops=ops,
                device_kernels=device_kernels(
                    lambda: flash_attention(q, k, v), 5))


def flash_hd256_row(dev, gen) -> dict:
    """The CUDA-core kernel's (256, 256) instance at recurrentgemma-9b's
    prefill shape (q [4, 16, 2048, 256], k, v [4, 1, 2048, 256]; [B, S, H,
    d] tensors seen as [B, H, S, d], as the model gives them; causal,
    window 2048) in bf16 and fp32, at a shape where the window bites (B 1,
    S 4096), and at ``cases.HD256_CASES``: bf16 elementwise and row by row
    against the plain version, fp32 within FP32_ATOL; every call on the
    CUDA cores.  The two planted faults at the main shape must fail the
    row gate.  Times the kernel (CUDA-graph replay), the plain version and
    SDPA (``is_causal=True, enable_gqa=True``; the window does not bite at
    S = 2048, so that is the same function)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def qkv(B, H, K, Sq, Sk, dtype, bshd=False):
        def one(n, S):
            if bshd:
                t = torch.randn(B, S, n, HD256_D, device=dev, generator=gen)
                return t.to(dtype).transpose(1, 2)
            return torch.randn(B, n, S, HD256_D, device=dev,
                               generator=gen).to(dtype)
        return one(H, Sq), one(K, Sk), one(K, Sk)

    fp32_cases, bf16_cases = {}, {}
    for name, shape, kw in cases.HD256_CASES:
        label = f"hd256 {name}"
        fp32_cases[name] = flash_fp32_check(
            label, *qkv(*shape, torch.float32), **kw)
        bf16_cases[name] = flash_bf16_check(
            label, *qkv(*shape, torch.bfloat16), expect="cuda_core",
            **kw)[0]
    H, K, W = HD256_HEADS, HD256_KV_HEADS, HD256_WINDOW
    bites_shape = (1, H, K, 2 * PREFILL_LEN, 2 * PREFILL_LEN)
    bites = dict(fp32=flash_fp32_check(
        "hd256 window bites", *qkv(*bites_shape, torch.float32, bshd=True),
        window=W))
    torch.cuda.empty_cache()
    bites["bf16"] = flash_bf16_check(
        "hd256 window bites", *qkv(*bites_shape, torch.bfloat16, bshd=True),
        expect="cuda_core", window=W)[0]
    torch.cuda.empty_cache()
    B, S = PREFILL_BATCH, PREFILL_LEN
    q, k, v = qkv(B, H, K, S, S, torch.float32, bshd=True)
    fp32_main = flash_fp32_check("hd256 main shape", q, k, v, window=W)
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = qkv(B, H, K, S, S, torch.bfloat16, bshd=True)
    main, got, want = flash_bf16_check("hd256 main shape", q, k, v,
                                       expect="cuda_core", window=W)
    require(got.transpose(1, 2).is_contiguous(),
            "flash_attention_hd256: the output is not laid out like q")
    planted = planted_faults("flash_attention_hd256", q, k, v, got, want)
    del got, want
    torch.cuda.empty_cache()
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, o; k, v
    ops = 2 * 2 * HD256_D * B * H * visible_pairs(S, S)
    b, by = bound(nbytes, ops, PEAK_BF16_PER_S)
    ms = graph_ms(lambda i: flash_attention(q, k, v, window=W), 4,
                  replays=2)
    plain = cuda_ms(lambda: attention_ref(q, k, v, window=W), 2, warmup=1)
    torch.cuda.empty_cache()
    lib = graph_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10, replays=3)
    return dict(shape=[B, H, K, S, S, HD256_D, HD256_D], dtype="bf16",
                causal=True, window=W, kernel=route(q, k, v),
                max_abs_err=main["cc"]["max_abs_err"], main=main,
                fp32_max_abs_err=fp32_main, window_bites=dict(
                    shape=[1, H, K, 2 * S, 2 * S, HD256_D], **bites),
                atol=cases.ATOL, rtol=cases.RTOL,
                row_rel_limit=cases.ROW_REL_LIMIT, planted_faults=planted,
                bf16_cases=bf16_cases, fp32_cases=fp32_cases, ms=ms,
                tflops=ops / ms / 1e9, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib,
                library="F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), bf16",
                bytes=nbytes, ops=ops,
                device_kernels=device_kernels(
                    lambda: flash_attention(q, k, v, window=W), 3))


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the last place of ``want``."""
    mag = want.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((got - want).abs() / ulp).max())


def sum_err(got, want, terms) -> float:
    """Largest |got - want| over the sum of the absolute terms."""
    return float(((got - want).abs() / terms.clamp_min(1e-30)).max())


def dot_tol(n: int) -> float:
    """dot_partials' limit, as a share of the sum of the absolute terms,
    for blocks of ``n`` random-sign products: fp32 rounding of such a sum
    grows like sqrt(n log n) while the sum of the absolute terms grows
    like n, so 64 ulps of that scale.  6.5e-9 at a main-path block (8.4 M
    terms), where one dropped or doubled term is 1.2e-7."""
    return 64 * 2.0 ** -24 * math.sqrt(math.log2(n) + 1) / math.sqrt(n)


def alternating_ms(kernel, library, rounds: int = 5, reps: int = 40) -> dict:
    """``graph_ms`` of a kernel and of its library call in ``rounds``
    alternating rounds (kernel, call, kernel, call, ...).  ``ms`` and
    ``library_ms`` are each one's median, beside its min and max;
    ``slower_than_library`` says whether the kernel's fastest round is
    slower than the call's slowest, i.e. slower outside the spread."""
    k, lib = [], []
    for _ in range(rounds):
        k.append(graph_ms(kernel, reps))
        lib.append(graph_ms(library, reps))
    return dict(ms=float(np.median(k)), ms_min_max=[min(k), max(k)],
                library_ms=float(np.median(lib)),
                library_ms_min_max=[min(lib), max(lib)],
                slower_than_library=min(k) > max(lib))


def blas_kernel_rows(dev, gen) -> dict:
    """axpy, dot_partials and gemv on one shard of the HBM apps' arrays
    (the shard tasks' call) and on the whole array with block_rows = br
    (the reference's call).  Timed calls walk the shards in turn, so each
    finds its operands cold in the 50 MB L2, as a firing does."""
    from repro_torch.kernels.hbm_blas.kernel import (axpy, dot_partials,
                                                     gemv, gemv_vector_loads)
    from repro_torch.kernels.hbm_blas.ref import (axpy_ref,
                                                  dot_partials_ref, gemv_ref)

    S = HBM_SHARDS
    rows_v, lanes = VEC_SPEC["rows"], VEC_SPEC["lanes"]
    br = rows_v // S
    X = torch.randn(rows_v, lanes, device=dev, generator=gen)
    Y = torch.randn(rows_v, lanes, device=dev, generator=gen)
    a = 1.5

    def shard(t, i, rows):
        return t[(i % S) * rows:(i % S + 1) * rows]

    def per_shard(fn, *ts):
        rows = ts[0].shape[0] // S
        return torch.cat([fn(*(shard(t, i, rows) for t in ts))
                          for i in range(S)])

    out = {}
    n = br * lanes

    # axpy: fmaf, one rounding, like its plain version.
    whole = axpy(a, X, Y, br)
    want = axpy_ref(a, X, Y, br)
    err_ulp = ulps(whole, want)
    require(err_ulp <= 1.0, f"axpy {err_ulp} ulp from its plain version")
    require(torch.equal(whole, per_shard(
        lambda x, y: axpy(a, x, y, br), X, Y)),
        "axpy: whole-array launch differs from the per-shard launches")
    nbytes, ops = 3 * n * 4, 2 * n
    b, by = bound(nbytes, ops)
    out["axpy"] = dict(
        shape=[br, lanes], max_abs_err=float((whole - want).abs().max()),
        max_ulp=err_ulp, whole_equals_shards=True,
        **alternating_ms(
            lambda i: axpy(a, shard(X, i, br), shard(Y, i, br), br),
            lambda i: torch.add(shard(Y, i, br), shard(X, i, br), alpha=a)),
        plain_ms=graph_ms(lambda i: axpy_ref(a, shard(X, i, br),
                                             shard(Y, i, br), br), 10),
        bound_ms=b, bound_by=by,
        library="torch.add(y, x, alpha=a)", bytes=nbytes, ops=ops,
        device_kernels=device_kernels(lambda: axpy(a, X[:br], Y[:br], br)))

    # dot_partials: two passes, each block's sum independent of the grid.
    whole = dot_partials(X, Y, br)
    want = dot_partials_ref(X, Y, br)
    terms = (X * Y).abs().reshape(S, -1).sum(1, keepdim=True)
    rel = sum_err(whole, want, terms)
    require(rel <= dot_tol(n),
            f"dot_partials err {rel:.3e} of sum|x*y| > {dot_tol(n):.3e}")
    require(torch.equal(whole, per_shard(
        lambda x, y: dot_partials(x, y, br), X, Y)),
        "dot_partials: whole-array launch differs from the shards")
    nbytes, ops = 2 * n * 4 + 4, 2 * n
    b, by = bound(nbytes, ops)
    out["dot_partials"] = dict(
        shape=[br, lanes], max_abs_err=float((whole - want).abs().max()),
        max_rel_err_of_abs_sum=rel, rel_err_limit=dot_tol(n),
        whole_equals_shards=True,
        **alternating_ms(
            lambda i: dot_partials(shard(X, i, br), shard(Y, i, br), br),
            lambda i: torch.dot(shard(X, i, br).reshape(-1),
                                shard(Y, i, br).reshape(-1))),
        plain_ms=graph_ms(lambda i: dot_partials_ref(
            shard(X, i, br), shard(Y, i, br), br), 10),
        bound_ms=b, bound_by=by,
        library="torch.dot on one block", bytes=nbytes, ops=ops,
        device_kernels=device_kernels(
            lambda: dot_partials(X[:br], Y[:br], br)))
    del X, Y

    # gemv: one thread block per row, its sum independent of M; the vector
    # path on the main path's aligned shards.
    M, N = GEMV_SPEC["rows"], GEMV_SPEC["lanes"]
    gbr = M // S
    A = torch.randn(M, N, device=dev, generator=gen)
    xv = torch.randn(1, N, device=dev, generator=gen)
    whole = gemv(A, xv, gbr)
    want = gemv_ref(A, xv, gbr)
    rel = sum_err(whole, want, (A * xv).abs().sum(1, keepdim=True))
    require(rel <= 1e-6, f"gemv err {rel:.3e} of sum|A*x|")
    require(gemv_vector_loads(A[:gbr], xv),
            "gemv: the main path's shard does not take 16-byte loads")
    require(torch.equal(whole, per_shard(lambda m: gemv(m, xv, gbr), A)),
            "gemv: whole-array launch differs from the shards")
    nbytes, ops = 4 * (gbr * N + N + gbr), 2 * gbr * N
    b, by = bound(nbytes, ops)
    out["gemv"] = dict(
        shape=[gbr, N], max_abs_err=float((whole - want).abs().max()),
        max_rel_err_of_abs_sum=rel, whole_equals_shards=True,
        vector_loads=True,
        **alternating_ms(lambda i: gemv(shard(A, i, gbr), xv, gbr),
                         lambda i: torch.mv(shard(A, i, gbr), xv[0])),
        plain_ms=graph_ms(lambda i: gemv_ref(shard(A, i, gbr), xv, gbr),
                          10),
        bound_ms=b, bound_by=by,
        library="torch.mv", bytes=nbytes, ops=ops,
        device_kernels=device_kernels(lambda: gemv(A[:gbr], xv, gbr)))
    return out


# -- phase 4: the main path --------------------------------------------------

def compile_design(app: str, graph_args: tuple, **options):
    """(graph, design, compile_s): ``app`` compiled onto a 4-FPGA ring
    with the smoke's options."""
    from repro_torch.apps import APPS
    from repro_torch.compiler import CompileOptions, compile
    from repro_torch.core import fpga_ring_cluster

    graph = APPS[app].build_graph(*graph_args)
    t0 = time.perf_counter()
    design = compile(graph, fpga_ring_cluster(4),
                     CompileOptions(**SMOKE_OPTIONS, **options))
    return graph, design, time.perf_counter() - t0


def compile_and_bind(app: str, graph_args: tuple, spec: dict, **options):
    """(graph, design, binding, compile_s, bind_s): ``compile_design``,
    then the binding on the card."""
    from repro_torch.exec import bind_programs

    graph, design, compile_s = compile_design(app, graph_args, **options)
    t0 = time.perf_counter()
    binding = bind_programs(graph, spec)             # on cuda
    torch.cuda.synchronize()
    return graph, design, binding, compile_s, time.perf_counter() - t0


def timed_execute(design, binding, **kw):
    """(result, wall s, launches, peak device bytes, device bytes held
    before it) of one execute(), with the launch counts zeroed just before
    it and read just after."""
    from repro_torch.exec import execute
    from repro_torch.kernels import launch_counts, reset_launch_counts

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = execute(design, binding, **{"fabric": None, **kw})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (result, wall, launch_counts(),
            torch.cuda.max_memory_allocated(), held)


def path_phase(app: str, spec: dict, graph_args: tuple, kernel: str
               ) -> tuple:
    """Returns the row and the design (the obs phase traces it)."""
    graph, design, binding, compile_s, bind_s = compile_and_bind(
        app, graph_args, spec)
    result, exec_s, launches, peak, held = timed_execute(design, binding)

    expected = binding.reference()
    got = result.outputs
    if isinstance(got, tuple):                      # knn: (dists, idx)
        require(got[1].dtype == torch.int32, "knn indices are not int32")
        err = float((got[0] - expected[0]).abs().max())
        idx_diff = int((got[1] != expected[1]).sum())
        require(idx_diff == 0, f"knn path: {idx_diff} indices differ")
        require(got[0].shape == expected[0].shape, "knn output shape")
    else:
        require(got.shape == expected.shape, f"{app} output shape")
        require(bool(torch.isfinite(got).all()), f"{app} output not finite")
        err = float((got - expected).abs().max())
    agree = result.report.agreement()
    rep = result.report
    row = {"app": app, "graph": graph.name, "tasks": len(graph.tasks),
           "compile_s": compile_s, "bind_s": bind_s, "execute_s": exec_s,
           "sweeps": rep.sweeps, "firings": sum(rep.device_fired.values()),
           "measured_inter_bytes": rep.measured_inter_bytes,
           "peak_device_bytes": peak, "held_before_bytes": held,
           "parity_max_err": err,
           "atol": binding.atol, "agreement": agree,
           "starvation_events": rep.starvation_events,
           "launches": launches,
           "partition": design.partition.stats.method}
    print(f"[path] {json.dumps(row)}", flush=True)
    require(err <= binding.atol, f"{app}: parity err {err} > {binding.atol}")
    require(all(agree.values()), f"{app}: agreement {agree}")
    require(not rep.starvation_events, f"{app}: starvation")
    require(launches[kernel] > 0,
            f"{app}: kernel {kernel} never launched during execute")
    return row, design


def largest_segments(spec: dict, pes: int) -> dict:
    """The longest run a segment sum adds in one thread: the largest
    in-degree of the whole graph (``reference()``'s sums) and of any PE's
    shard (the binder's ``np.array_split`` of the edges)."""
    from repro_torch.apps.pagerank import draw_edges, segments

    _, dst = draw_edges(spec["n_nodes"], spec["n_edges"],
                        spec.get("seed", 0), "cuda")
    return {"graph": int(segments(dst)[2].max()),
            "pe_shard": max(int(segments(d)[2].max())
                            for d in dst.tensor_split(pes))}


def pagerank_path_phase() -> tuple:
    """PageRank at cit-Patents' size: the ideal path twice (same bits),
    the reference, the segment sums' device time; then the same binding
    through the ring's fabric.  Returns both rows and the ideal path's
    design."""
    from repro_torch.core import fpga_ring_cluster
    from repro_torch.exec import execute
    from repro_torch.net import cluster_fabric

    spec = PAGERANK_SPEC
    graph, design, binding, compile_s, bind_s = compile_and_bind(
        "pagerank", (4,), spec)
    first, exec_s, launches, peak, held = timed_execute(design, binding)
    second, exec2_s, _, _, _ = timed_execute(design, binding)
    t0 = time.perf_counter()
    expected = binding.reference()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    got = first.outputs
    require(got.shape == expected.shape == (spec["n_nodes"],),
            "pagerank output shape")
    require(bool(torch.isfinite(got).all()), "pagerank output not finite")
    same_bits = torch.equal(got.view(torch.int32),
                            second.outputs.view(torch.int32))
    diff = (got.double() - expected.double()).abs()
    err = float(diff.max())
    rel = err / float(expected.abs().max())
    l1 = float(diff.sum() / expected.double().abs().sum())
    longest = largest_segments(
        spec, sum(t.startswith("pe") for t in graph.tasks))
    # The segment sums are torch.segment_reduce's kernels (*egment*).
    prof = device_breakdown(lambda: execute(design, binding, fabric=None),
                            match="egment")
    rep = first.report
    agree = rep.agreement()
    row = {"app": "pagerank", "graph": graph.name, "tasks": len(graph.tasks),
           "n_nodes": spec["n_nodes"], "n_edges": spec["n_edges"],
           "iters": spec["iters"], "compile_s": compile_s, "bind_s": bind_s,
           "execute_s": exec_s, "second_execute_s": exec2_s,
           "reference_s": ref_s, "sweeps": rep.sweeps,
           "firings": sum(rep.device_fired.values()),
           "measured_inter_bytes": rep.measured_inter_bytes,
           "peak_device_bytes": peak, "held_before_bytes": held,
           "parity_max_err": err, "max_reference": float(expected.max()),
           "rel_err": rel, "l1_rel_err": l1, "rel_tol": PAGERANK_REL_TOL,
           "same_bits_twice": same_bits, "agreement": agree,
           "starvation_events": rep.starvation_events,
           "launches": launches, "device_ms": prof["device_ms"],
           "segment_sum_ms": prof["matched_ms"],
           "segment_sum_launches": prof["matched_launches"],
           "largest_segment": longest,
           "top": prof["top"],
           "partition": design.partition.stats.method}
    print(f"[path] {json.dumps(row)}", flush=True)
    require(rel <= PAGERANK_REL_TOL,
            f"pagerank: error {rel:.3e} of the largest rank > "
            f"{PAGERANK_REL_TOL}")
    require(same_bits, "pagerank: two runs gave different bits")
    require(all(agree.values()), f"pagerank: agreement {agree}")
    require(not rep.starvation_events, "pagerank: starvation")
    require(prof["matched_ms"] > 0,
            "pagerank: the profiler saw no segment_reduce kernel")
    del second, expected, diff

    fgraph, fdesign, fcompile_s = compile_design(
        "pagerank", (4,), fabric=cluster_fabric(fpga_ring_cluster(4)))
    fab, fab_s, flaunches, fpeak, fheld = timed_execute(
        fdesign, binding, fabric=fdesign.fabric)
    frep = fab.report
    fagree = frep.agreement()
    fb = fdesign.pass_record("congestion_feedback").detail
    fab_bits = torch.equal(fab.outputs.view(torch.int32),
                           got.view(torch.int32))
    frow = {"app": "pagerank-fabric", "graph": fgraph.name,
            "tasks": len(fgraph.tasks), "compile_s": fcompile_s,
            "execute_s": fab_s, "ideal_execute_s": exec_s,
            "transport_s": frep.net_model_s, "sweeps": frep.sweeps,
            "ideal_sweeps": rep.sweeps,
            "firings": sum(frep.device_fired.values()),
            "measured_inter_bytes": frep.measured_inter_bytes,
            "net_link_bytes": frep.net_link_bytes,
            "net_hop_weighted_bytes": frep.net_hop_weighted_bytes,
            "max_link_utilization": frep.congestion.max_utilization,
            "congestion_waits": sum(frep.task_congestion_waits.values()),
            "projected_max_utilization": fb["max_utilization_after"],
            "repartitioned": fb["repartitioned"],
            "peak_device_bytes": fpeak, "held_before_bytes": fheld,
            "equals_ideal_bits": fab_bits, "agreement": fagree,
            "starvation_events": frep.starvation_events,
            "launches": flaunches,
            "partition": fdesign.partition.stats.method}
    print(f"[path] {json.dumps(frow)}", flush=True)
    require(fab_bits, "pagerank-fabric: outputs differ from the ideal path")
    require(all(fagree.values()) and fagree.get("link_conservation"),
            f"pagerank-fabric: agreement {fagree}")
    require(frep.net_link_bytes == frep.net_hop_weighted_bytes > 0,
            "pagerank-fabric: link bytes differ from hop-weighted bytes")
    require(not frep.starvation_events, "pagerank-fabric: starvation")
    return row, frow, design


def hbm_path_phase(app: str, spec: dict, kernels: tuple) -> dict:
    """One HBM app at full width: bank path, ideal path, reference."""
    from repro_torch.mem import MemConfig

    graph, design, binding, compile_s, bind_s = compile_and_bind(
        app, (4,), spec, mem=MemConfig())
    banked, bank_s, launches, peak, held = timed_execute(design, binding)
    ideal, ideal_s, ideal_launches, _, _ = timed_execute(design, binding,
                                                         mem=None)
    expected = binding.reference()
    out = banked.outputs
    require(out.shape == expected.shape, f"{app} output shape")
    require(bool(torch.isfinite(out).all()), f"{app} output not finite")
    bank_eq_ideal = torch.equal(out, ideal.outputs)
    bank_eq_ref = torch.equal(out, expected)
    rep, irep = banked.report, ideal.report
    agree, iagree = rep.agreement(), irep.agreement()
    fb = design.pass_record("memory_feedback").detail
    row = {"app": app, "graph": graph.name, "tasks": len(graph.tasks),
           "shape": [spec["rows"], spec["lanes"]],
           "streams": spec["streams"], "compile_s": compile_s,
           "bind_s": bind_s, "execute_s": bank_s,
           "ideal_execute_s": ideal_s, "sweeps": rep.sweeps,
           "ideal_sweeps": irep.sweeps,
           "firings": sum(rep.device_fired.values()),
           "mem_waits": sum(rep.task_mem_waits.values()),
           "ideal_mem_waits": sum(irep.task_mem_waits.values()),
           "bank_bursts": sum(b.bursts for b in rep.mem_contention.banks),
           "bank_bytes": rep.mem_bank_bytes,
           "max_bank_utilization": rep.mem_contention.max_utilization,
           "bank_model_s": rep.mem_model_s,
           "projected_max_utilization": fb["max_utilization_after"],
           "remapped": fb["remapped"], "repartitioned": fb["repartitioned"],
           "peak_device_bytes": peak, "held_before_bytes": held,
           "bank_equals_ideal": bank_eq_ideal,
           "bank_equals_reference": bank_eq_ref, "atol": binding.atol,
           "agreement": agree, "ideal_agreement": iagree,
           "starvation_events": rep.starvation_events,
           "launches": launches, "ideal_launches": ideal_launches,
           "partition": design.partition.stats.method}
    print(f"[path] {json.dumps(row)}", flush=True)
    require(bank_eq_ideal, f"{app}: bank path differs from the ideal path")
    require(bank_eq_ref, f"{app}: bank path differs from reference()")
    require(all(agree.values()) and all(iagree.values()),
            f"{app}: agreement {agree} / ideal {iagree}")
    require(agree.get("mem_delivery_match") and
            agree.get("bank_conservation"), f"{app}: no bank accounting")
    require(rep.mem_contention.max_utilization <= 1.0 + 1e-12,
            f"{app}: measured bank utilization above 1")
    require(not rep.starvation_events, f"{app}: starvation")
    for k in kernels:
        require(launches[k] > 0 and ideal_launches[k] > 0,
                f"{app}: kernel {k} never launched during execute")
    return row


def lm_prompts(vocab: int) -> tuple:
    """The prefill step's PREFILL_BATCH x PREFILL_LEN prompts and the
    engine's PREFILL_BATCH x SERVE_PROMPT ones, from seed 0."""
    rng = np.random.default_rng(0)
    return (rng.integers(1, vocab, (PREFILL_BATCH, PREFILL_LEN)),
            rng.integers(1, vocab, (PREFILL_BATCH, SERVE_PROMPT)))


def serve_row(dev, cfg, route: str) -> dict:
    """One LM at ``cfg`` (bf16, weights drawn on the card from seed 0): the
    prefill step over PREFILL_BATCH prompts of PREFILL_LEN tokens, once to
    warm up and once timed, each launching flash_attention once an
    attention layer on ``route`` (a recurrent layer launches none); then a
    ServingEngine answering PREFILL_BATCH requests of SERVE_PROMPT +
    SERVE_NEW tokens, and the bf16 prefill step against the engine's
    sequential prefill (printed, not gated).  Each engine call that a gate
    compares gets a fresh engine: like JAX's, the engine keeps its cache
    from one request to the next, and a recurrent state carries over."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import init_params, param_count
    from repro_torch.models.transformer import attention_layers
    from repro_torch.serving import ServeConfig, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    require(n_params == param_count(cfg), f"{cfg.name} parameter count")
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    long_prompts, prompts = lm_prompts(cfg.vocab)

    prefill = build_prefill_step(cfg)                 # on cuda
    runs = []
    for _ in range(2):                                # warm-up, timed
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": long_prompts})
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, launch_counts()))
    prefill_s, launches = runs[1]
    n_attn = attention_layers(cfg)
    require((n_attn == 0) == (route == "none"),
            f"{cfg.name}: {n_attn} attention layers on route {route}")
    want_tc = n_attn if route == "tensor_core" else 0
    for _, counts in runs:
        require(counts["flash_attention"] == n_attn,
                f"{cfg.name} prefill launched flash_attention "
                f"{counts['flash_attention']} times, not {n_attn}")
        require(counts["flash_attention_tc"] == want_tc,
                f"{cfg.name} prefill launched the tensor-core "
                f"flash_attention {counts['flash_attention_tc']} times, not "
                f"{want_tc}")
    require(logits.shape == (PREFILL_BATCH, cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"{cfg.name} prefill logits: shape or not finite")
    prefill_profile = device_breakdown(
        lambda: prefill(params, {"tokens": long_prompts}))

    def engine():
        return ServingEngine(params, cfg, ServeConfig(
            batch_slots=PREFILL_BATCH, max_len=SERVE_MAX_LEN))

    reset_launch_counts()
    t0 = time.perf_counter()
    seq_logits, _ = engine().prefill(prompts)
    torch.cuda.synchronize()
    seq_prefill_s = time.perf_counter() - t0
    serving = engine()
    t0 = time.perf_counter()
    out = serving.generate(prompts, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    engine_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # Device time of the engine's steps: a generate of 4 new tokens runs
    # SERVE_PROMPT + 4 serve_steps.
    step_profile = device_breakdown(
        lambda: serving.generate(prompts, max_new=4), top=3)
    step_device_ms = step_profile["device_ms"] / (SERVE_PROMPT + 4)
    step_ops = aten_ops(lambda: serving.generate(prompts, max_new=4)) / (
        SERVE_PROMPT + 4)
    step_wall_ms = generate_s * 1e3 / (SERVE_PROMPT + SERVE_NEW)
    require(out.shape == (PREFILL_BATCH, SERVE_NEW) and out.dtype == np.int32
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"{cfg.name} generated tokens: shape, dtype or range")
    require(bool(torch.isfinite(seq_logits).all()),
            f"{cfg.name} decode logits")
    require(np.array_equal(out[:, 0],
                            seq_logits.argmax(-1).cpu().numpy()),
            f"{cfg.name}: first greedy token is not the argmax of the "
            f"prefill logits")
    kern_logits = prefill(params, {"tokens": prompts})
    bf16_rel = float((kern_logits - seq_logits).abs().max()
                     / seq_logits.abs().max())
    bf16_argmax = int((kern_logits.argmax(-1)
                       == seq_logits.argmax(-1)).sum())
    del params, serving, logits, kern_logits, seq_logits
    torch.cuda.empty_cache()

    new_tokens = PREFILL_BATCH * SERVE_NEW
    tc = launches["flash_attention_tc"]
    return {"app": cfg.name, "params": n_params, "param_bytes": param_bytes,
            "layers": cfg.num_layers, "init_s": init_s,
            "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
            "prefill_s": prefill_s, "prefill_warmup_s": runs[0][0],
            "prefill_tok_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
            "prefill_device_ms": prefill_profile["device_ms"],
            "prefill_top_kernels": prefill_profile["top"],
            "launches": launches,
            "attention_layers": n_attn,
            "flash_launches_by_route": {
                "tensor_core": tc,
                "cuda_core": launches["flash_attention"] - tc},
            "serve_requests": PREFILL_BATCH, "serve_prompt": SERVE_PROMPT,
            "serve_new": SERVE_NEW, "engine_prefill_s": seq_prefill_s,
            "generate_s": generate_s,
            "decode_tok_per_s": new_tokens / (generate_s - seq_prefill_s),
            "step_wall_ms": step_wall_ms, "step_device_ms": step_device_ms,
            "step_device_busy": step_device_ms / step_wall_ms,
            "step_aten_ops": step_ops,
            "step_top_kernels": step_profile["top"],
            "engine_launches": engine_launches,
            "peak_device_bytes": peak,
            "tokens_head": out[:, :8].tolist(),
            "bf16_full_depth_rel_err": bf16_rel,
            "bf16_full_depth_argmax_equal": bf16_argmax}


def fp32_parity(dev, cfg, prompt_len: int = SERVE_PROMPT) -> dict:
    """The prefill step (the flash kernel) against the engine's sequential
    prefill (decode) in fp32 on the SERVE_PROMPT-token prompts, or on the
    first ``prompt_len`` tokens of the prefill step's: within 1e-4 of the
    logits' largest magnitude, one CUDA-core launch an attention layer."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    long_prompts, prompts = lm_prompts(cfg.vocab)
    if prompt_len != SERVE_PROMPT:
        prompts = long_prompts[:, :prompt_len]
    params32 = init_params(torch.Generator(dev).manual_seed(1), cfg)
    reset_launch_counts()
    kern = build_prefill_step(cfg)(params32, {"tokens": prompts})
    counts = launch_counts()
    dec, _ = ServingEngine(params32, cfg, ServeConfig(
        batch_slots=PREFILL_BATCH, max_len=max(SERVE_MAX_LEN, prompt_len))
    ).prefill(prompts)
    rel = float((kern - dec).abs().max() / dec.abs().max())
    del params32
    torch.cuda.empty_cache()
    return {"superblocks": cfg.num_superblocks, "layers": cfg.num_layers,
            "prompt_len": prompts.shape[1], "rel_err": rel,
            "flash_launches": counts["flash_attention"],
            "tc_launches": counts["flash_attention_tc"]}


def check_fp32_parity(name: str, parity: dict, layers: int) -> None:
    """``layers``: the attention layers, each one CUDA-core launch."""
    require(parity["flash_launches"] == layers,
            f"{name} fp32 parity prefill launched flash_attention "
            f"{parity['flash_launches']} times")
    require(parity["tc_launches"] == 0,
            f"{name} fp32 parity prefill took the tensor-core "
            f"flash_attention")
    require(parity["rel_err"] <= 1e-4,
            f"{name} fp32 prefill step against sequential decode: "
            f"{parity['rel_err']:.3e} of the logits' scale > 1e-4")


def lm_path_phase(dev) -> dict:
    """qwen3-4b at full width and depth: the prefill step (flash kernel)
    and the ServingEngine; then prefill-against-decode parity."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import attention_layers

    cfg = get_arch(LM_ARCH).full()
    row = serve_row(dev, cfg, "tensor_core")
    cfg32 = dataclasses.replace(cfg, num_superblocks=PARITY_SUPERBLOCKS,
                                dtype=torch.float32,
                                param_dtype=torch.float32)
    parity = fp32_parity(dev, cfg32)
    row.update({"fp32_parity_superblocks": parity["superblocks"],
                "fp32_parity_rel_err": parity["rel_err"],
                "fp32_parity_flash_launches": parity["flash_launches"],
                "fp32_parity_tc_launches": parity["tc_launches"]})
    print(f"[path] {json.dumps(row)}", flush=True)
    check_fp32_parity(LM_ARCH, parity, attention_layers(cfg32))
    return row


def lm_rows_phase(dev) -> dict:
    """chatglm3-6b, the DeepSeek archs and the recurrent archs
    (``LM_ROWS``), then MLA + MoE parity on deepseek-v2 and the recurrent
    archs' parity (``RECURRENT_PARITY``) in fp32.  Returns each row by
    arch."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import attention_layers

    rows = {}
    for arch, superblocks, route, kernel_row, note in LM_ROWS:
        cfg = get_arch(arch).full()
        if superblocks is not None:
            cfg = dataclasses.replace(cfg, num_superblocks=superblocks)
        t0 = time.perf_counter()
        row = serve_row(dev, cfg, route)
        row["note"] = note
        row["kernel_row"] = kernel_row
        row["row_s"] = time.perf_counter() - t0
        print(f"[path] {json.dumps(row)}", flush=True)
        rows[arch] = row
    cfg = get_arch(MLA_PARITY_ARCH).full()
    moe = cfg.moe
    # Capacity for every token: num_experts / top_k slots a token, so the
    # 32-token prefill drops nothing (decode never does).
    cfg = dataclasses.replace(
        cfg, num_superblocks=MLA_PARITY_SUPERBLOCKS, dtype=torch.float32,
        param_dtype=torch.float32, moe=dataclasses.replace(
            moe, capacity_factor=moe.num_experts / moe.top_k))
    parity = fp32_parity(dev, cfg)
    row = {"app": "mla_moe_fp32_parity", "arch": MLA_PARITY_ARCH,
           "capacity_factor": cfg.moe.capacity_factor, **parity}
    print(f"[path] {json.dumps(row)}", flush=True)
    check_fp32_parity(f"{MLA_PARITY_ARCH} (MLA + MoE)", parity,
                      attention_layers(cfg))
    for arch, superblocks, prompt_len in RECURRENT_PARITY:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            get_arch(arch).full(), num_superblocks=superblocks,
            dtype=torch.float32, param_dtype=torch.float32)
        parity = fp32_parity(dev, cfg, prompt_len)
        row = {"app": "recurrent_fp32_parity", "arch": arch, **parity,
               "row_s": time.perf_counter() - t0}
        print(f"[path] {json.dumps(row)}", flush=True)
        check_fp32_parity(f"{arch} (recurrent, {prompt_len} tokens)",
                          parity, attention_layers(cfg))
    return rows


def release_kernel_phase() -> None:
    """Frees what the kernel phase leaves allocated, so that no path's peak
    counts it: cuBLAS keeps a workspace for every stream it ran on.
    Prints the bytes allocated before and after."""
    gc.collect()
    before = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"kernel phase: {before} device bytes still allocated after it, "
          f"{after} after freeing the cuBLAS workspaces", flush=True)


# -- phase 6: observability and snapshots -----------------------------------

def int_counters(report) -> dict:
    """The integer counters a run must reproduce: the obs smoke's set, with
    per-link flits and per-channel tokens."""
    from repro_torch.obs.smoke import counters

    out = counters(report)
    out["link_flits"] = ([int(l.flits) for l in report.congestion.links]
                         if report.congestion is not None else [])
    out["channel_tokens"] = [c.tokens for c in report.channels]
    return out


def decomposition_sums(crit, sweeps: int) -> bool:
    dec = crit.decomposition()
    return sum(v for k, v in dec.items()
               if k not in ("task", "sweeps")) == sweeps


def obs_fabric_row(app: str, graph, design, dev, compile_s: float,
                   baseline: dict, pinned: bool) -> dict:
    """One app's obs smoke checks on the card (``check_app`` raises on any
    breach), its counters against the port's CPU run of the same design,
    and its metrics against the committed baseline."""
    from repro_torch.exec import bind_programs, execute
    from repro_torch.obs.diff import diff_against_baseline
    from repro_torch.obs.smoke import BASELINE_PINS, check_app

    run = check_app(app, graph, design, dev)
    res, tracer = run["result"], run["tracer"]
    cpu = execute(design, bind_programs(graph, device="cpu"), device="cpu")
    card_counters = int_counters(res.report)
    same_as_cpu = card_counters == int_counters(cpu.report)
    drift = diff_against_baseline(
        dict(baseline, apps={app: baseline["apps"][app]}),
        {app: run["registry"]})[app]
    kinds = {}
    for e in tracer.events:
        kinds[e[0]] = kinds.get(e[0], 0) + 1
    row = {"app": app, "phase": "fabric, obs smoke size",
           "partition": "baseline's (pinned)" if pinned else "compiled here",
           "baseline_partition": (design.partition.assignment
                                  == BASELINE_PINS.get(app)),
           "compile_s": compile_s, "sweeps": res.report.sweeps,
           "events": len(tracer), "events_by_kind": kinds,
           "link_bytes": sum(card_counters["link_bytes"]),
           "critical_task": run["row"]["critical_task"],
           "decomposition": {k: run["row"][k] for k in
                             ("compute", "network", "memory", "fault",
                              "blocked_other", "idle")},
           "agreement": res.report.agreement(),
           "counters_equal_cpu": same_as_cpu,
           "baseline": "OK" if drift.ok else
           f"drift in {len(drift.violations)} series, "
           f"{len(drift.removed)} removed, {len(drift.added)} added"}
    if app in JAX_BASELINE_DRIFT:
        row["jax_baseline_drift"] = JAX_BASELINE_DRIFT[app]
    print(f"[obs] {json.dumps(row)}", flush=True)
    require(all(row["agreement"].values()),
            f"obs {app}: agreement {row['agreement']}")
    require(same_as_cpu, f"obs {app}: the card's counters {card_counters} "
            f"differ from the CPU run's {int_counters(cpu.report)}")
    if pinned:
        require(drift.ok, f"obs {app}: metrics drift from "
                f"results/obs_baseline.json:\n{drift.format()}")
    return row


def obs_fabric_rows(dev) -> None:
    """The obs smoke on the card: the four apps at their binders' default
    sizes through the 4-ring fabric, traced and untraced, each compiled as
    the obs smoke compiles it (through the chaos runner's memo, so the
    chaos phase runs these designs).  The partition MILP has tied optima
    that solver releases break differently, so stencil and pagerank also
    run on the partition the committed baseline was taken at
    (``BASELINE_PINS``), and those runs must pass the baseline."""
    from repro_torch.chaos.runner import compile_app as memo_compile_app
    from repro_torch.obs.diff import load_json
    from repro_torch.obs.smoke import BASELINE_PINS, compile_app

    baseline = load_json(str(ROOT / "results" / "obs_baseline.json"))
    for app in OBS_APPS:
        t0 = time.perf_counter()
        graph, design = memo_compile_app(app, 4)
        compile_s = time.perf_counter() - t0
        obs_fabric_row(app, graph, design, dev, compile_s, baseline,
                       pinned=False)
        if app in BASELINE_APPS:
            t0 = time.perf_counter()
            graph, design = compile_app(app, 4, pins=BASELINE_PINS[app])
            compile_s = time.perf_counter() - t0
            obs_fabric_row(app, graph, design, dev, compile_s, baseline,
                           pinned=True)


def obs_full_size_rows(designs: dict):
    """The path phase's four designs on the ideal path, untraced then
    traced: the same bits and counters, the trace's bytes equal to the
    report's, and the tracer's cost.  Returns stencil's untraced result."""
    from repro_torch.exec import bind_programs, bit_identical
    from repro_torch.obs import (Tracer, analyze,
                                 assert_registry_consistent,
                                 assert_trace_report_consistent)

    kernels = {app: kernel for app, _, kernel in FULL_SIZE}
    for app in OBS_APPS:
        design = designs[app]
        binding = bind_programs(design.graph, SPECS[app])
        # In turns (untraced, traced, untraced, traced): the first run
        # of a fresh binding also pays the allocator's warm-up.
        base, base_s, _, _, _ = timed_execute(design, binding)
        tracer = Tracer()
        res, traced_s, launches, _, _ = timed_execute(design, binding,
                                                      tracer=tracer)
        base_s = [base_s, timed_execute(design, binding)[1]]
        traced_s = [traced_s, timed_execute(design, binding,
                                            tracer=Tracer())[1]]
        bits = bit_identical(base.outputs, res.outputs)
        same = int_counters(base.report) == int_counters(res.report)
        assert_trace_report_consistent(tracer, res.report)
        assert_registry_consistent(res.report.metrics, res.report)
        crit = analyze(tracer, sweeps=res.report.sweeps)
        row = {"app": app, "phase": "ideal path, full size",
               "sweeps": res.report.sweeps, "events": len(tracer),
               "execute_s": base_s, "traced_execute_s": traced_s,
               "traced_over_untraced": min(traced_s) / min(base_s),
               "same_bits": bits, "same_counters": same,
               "critical_task": crit.critical().task,
               "launches": launches}
        print(f"[obs] {json.dumps(row)}", flush=True)
        require(bits, f"obs {app}: the traced run's bits differ")
        require(same, f"obs {app}: the traced run's counters differ")
        require(decomposition_sums(crit, res.report.sweeps),
                f"obs {app}: critical path does not sum to the makespan")
        kernel = kernels.get(app)          # PageRank has no kernel
        require(kernel is None or launches[kernel] > 0,
                f"obs {app}: {kernel} never launched in the traced run")
        if app == "stencil":
            stencil = base
        del base, res, tracer, binding
    return stencil


def obs_snapshot_row(design, untraced) -> None:
    """The full-size stencil killed after a barrier and resumed from its
    snapshot (in a temporary directory outside the checkout): the
    uninterrupted run's bits, every agreement() value, and the snapshot's
    bytes, save and resume seconds and extra sweeps."""
    import shutil
    import tempfile

    from repro_torch.exec import (ExecutionState, bind_programs,
                                  bit_identical, execute, load_snapshot,
                                  restore_state, resume_execution,
                                  save_snapshot, snapshot_steps)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import FailureInjector

    sweeps = untraced.report.sweeps
    kill = sweeps // 2 + 1
    every = max(1, kill // 2)
    require(every < kill < sweeps, f"snapshot: no barrier before the kill "
            f"(sweeps {sweeps}, kill {kill}, every {every})")
    binding = bind_programs(design.graph, STENCIL_SPEC)
    root = tempfile.mkdtemp(prefix="chip_smoke_snapshots_")
    try:
        d = str(Path(root) / "run")
        t0 = time.perf_counter()
        killed = False
        try:
            execute(design, binding, fabric=None,
                    injector=FailureInjector([kill]), checkpoint_dir=d,
                    checkpoint_every=every)
        except FailureInjector.Injected:
            killed = True
        torch.cuda.synchronize()
        killed_s = time.perf_counter() - t0
        require(killed, f"snapshot: the injector at sweep {kill} never fired")
        steps = snapshot_steps(d)
        require(bool(steps) and steps[-1] < kill,
                f"snapshot: barriers {steps} do not precede the kill")
        payload_path = Path(d) / f"step_{steps[-1]}" / "state.pt"
        nbytes = payload_path.stat().st_size
        reset_launch_counts()
        t0 = time.perf_counter()
        resumed = resume_execution(design, d, binding=binding, fabric=None)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        launches = launch_counts()
        # The save alone, of the same barrier's state (restored on the card).
        state = ExecutionState(design, binding, fabric=None)
        restore_state(state, load_snapshot(d, steps[-1]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_snapshot(state, steps[-1], str(Path(root) / "resave"))
        save_s = time.perf_counter() - t0
        del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bits = bit_identical(resumed.outputs, untraced.outputs)
    agree = resumed.report.agreement()
    row = {"app": "stencil", "phase": "snapshot, full size",
           "sweeps": sweeps, "kill_at": kill, "checkpoint_every": every,
           "barriers": steps, "snapshot_bytes": nbytes,
           "save_s": save_s, "resume_s": resume_s,
           "killed_run_s": killed_s,
           "extra_sweeps": resumed.report.sweeps - sweeps,
           "same_bits": bits, "agreement": agree, "launches": launches}
    print(f"[obs] {json.dumps(row)}", flush=True)
    require(bits, "snapshot: the resumed run's bits differ")
    require(all(agree.values()), f"snapshot: agreement {agree}")
    require(launches["dilate"] > 0, "snapshot: dilate never launched in "
            "the resumed run")


def obs_phase(dev, designs: dict) -> None:
    obs_fabric_rows(dev)
    obs_snapshot_row(designs["stencil"], obs_full_size_rows(designs))
    print(f"[obs] card: {card_line()}", flush=True)


# -- phase 7: the tenant server ---------------------------------------------

def tenant_smoke_rows(dev) -> None:
    """The tenant smoke's logic at the binders' default sizes, on the card
    and on the CPU: the stencil co-run and kill, and the axpy co-run and
    kill over one shared bank model.  Each raises on a broken guarantee
    (bits against the solo runs, conservation, the ledger); the card's
    integer counters must equal the CPU run's, and the app's kernel must
    launch in each card run."""
    from repro_torch.tenants.smoke import bank_serves, stencil_serves

    for name, serve, kernel in (("stencil", stencil_serves, "dilate"),
                                ("axpy, shared banks", bank_serves, "axpy")):
        t0 = time.perf_counter()
        card = serve(dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cpu = serve(torch.device("cpu"))
        same = card["counters"] == cpu["counters"]
        corun = card["counters"]["corun"]
        row = {"tenants": name, "phase": "tenant smoke, default size",
               "corun_sweeps": corun["sweeps"],
               "kill_sweeps": card["counters"]["kill"]["sweeps"],
               "conservation": corun["conservation"],
               "kill_records": [
                   {k: r[k] for k in ("name", "status", "killed_at",
                                      "recovered_as", "recovered_via")}
                   for r in card["counters"]["kill"]["records"]],
               "wall_time_s": card["wall_time_s"], "phase_s": card_s,
               "launches": {k: v[kernel] for k, v in
                            card["launches"].items()},
               "counters_equal_cpu": same}
        print(f"[tenants] {json.dumps(row)}", flush=True)
        require(same, f"tenants {name}: the card's counters "
                f"{card['counters']} differ from the CPU run's "
                f"{cpu['counters']}")
        require(all(v[kernel] > 0 for v in card["launches"].values()),
                f"tenants {name}: {kernel} never launched in a serve")


def tenant_full_width_rows(dev) -> None:
    """Two stencil tenants at phase 4's image size (4096 x 4096 fp32, 2
    images, ``stage_iters`` 16), each ``build_graph(2, iters=64)`` compiled
    on a private 2-ring, co-run on the shared 4-ring fabric: clean, with a
    permanent kill of device 2 mid-run (recompiled onto the survivor), and
    with a transient kill that restores from a sweep barrier.  Every
    finished tenant has its solo ideal-path bits (a recompiled one its
    ``reference()`` within ``atol``), conservation is exact, the ledger is
    consistent and the peer is charged zero; dilate launches in each run."""
    import shutil
    import tempfile

    from repro_torch.exec import bind_programs, bit_identical
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import (assert_ledger_consistent,
                                 assert_peers_uncharged, build_ledger,
                                 substrate_metrics)
    from repro_torch.tenants import DeviceKill, TenantServer
    from repro_torch.tenants.smoke import (STENCIL_SEEDS, compile_tenants,
                                           make_tenants, shared_fabric,
                                           solo_runs)

    spec = {k: v for k, v in STENCIL_SPEC.items() if k != "seed"}
    t0 = time.perf_counter()
    specs, graphs, designs = compile_tenants(
        "stencil", STENCIL_SEEDS, graph_args=GRAPH_ARGS_TENANT, spec=spec)
    compile_s = time.perf_counter() - t0
    solo = solo_runs(graphs, designs, specs, dev)
    ref_a = bind_programs(graphs["a"], specs["a"], device=dev)
    reference_a = ref_a.reference()

    def serve(name, faults=(), fields=None, checkpoint_every=None):
        server = TenantServer(shared_fabric(),
                              make_tenants(designs, specs, **(fields or {})),
                              device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        out = server.run(faults=list(faults),
                         checkpoint_every=checkpoint_every)
        torch.cuda.synchronize()
        launches = launch_counts()
        ledger = build_ledger(server)
        assert_ledger_consistent(ledger, server,
                                 registry=substrate_metrics(server))
        if faults:
            assert_peers_uncharged(ledger, ["a"])
        cons = out.conservation
        duration = out.sweeps * server.net_config.sweep_time_s
        tenants, bits = {}, {}
        for rec in out.records:
            row = {"status": rec.status, "flow": rec.flow,
                   "link_bytes": cons["per_tenant_link_bytes"][rec.name]}
            if rec.status == "done":
                row["latency_sweeps"] = rec.end_sweep - rec.start_sweep
                row["goodput_Bps"] = row["link_bytes"] / duration
                if rec.recovered_via == "recompile":
                    err = float((rec.result.outputs.double()
                                 - reference_a.double()).abs().max())
                    row["parity_max_err"] = err
                    bits[rec.name] = err <= ref_a.atol
                else:
                    bits[rec.name] = bit_identical(
                        rec.result.outputs, solo[rec.name[0]].outputs)
            if rec.killed_at is not None:
                row["killed_at"] = rec.killed_at
            if rec.recovered_via is not None:
                row["recovered_via"] = rec.recovered_via
            tenants[rec.name] = row
        by = ledger.by_lineage()
        row = {"tenants": "stencil, full width", "run": name,
               "sweeps": out.sweeps, "wall_time_s": out.wall_time_s,
               "total_link_bytes": cons["total_link_bytes"],
               "conservation_exact": cons["exact"], "tenant": tenants,
               "cancelled_bytes": by["a"]["cancelled_bytes"],
               "restore_sweeps": by["a"]["restore_sweeps"],
               "solo_bits_or_reference": bits,
               "launches": launches["dilate"]}
        require(all(r.status in ("done", "killed") for r in out.records)
                and sum(r.status == "done" for r in out.records) == 2,
                f"tenants full width {name}: {tenants}")
        require(all(bits.values()),
                f"tenants full width {name}: outputs differ {bits}")
        require(cons["exact"], f"tenants full width {name}: conservation")
        require(launches["dilate"] > 0,
                f"tenants full width {name}: dilate never launched")
        return out, row

    clean, row = serve("clean co-run")
    row["compile_s"] = compile_s
    print(f"[tenants] {json.dumps(row)}", flush=True)
    kill = clean.sweeps // 2
    _, row = serve("permanent kill", [DeviceKill(device=2, sweep=kill)])
    print(f"[tenants] {json.dumps(row)}", flush=True)
    every = kill // 2
    root = tempfile.mkdtemp(prefix="chip_smoke_tenants_")
    try:
        out, row = serve("transient kill, restore",
                         [DeviceKill(device=2, sweep=kill, transient=True)],
                         fields={"a": {"checkpoint_dir": root}},
                         checkpoint_every=every)
        steps = sorted(int(p.name[len("step_"):])
                       for p in Path(root).glob("step_*")
                       if not p.name.endswith(".tmp"))
        row.update({"checkpoint_every": every, "barriers": steps,
                    "snapshot_bytes": sum(f.stat().st_size for f in
                                          Path(root).rglob("*")
                                          if f.is_file()),
                    "extra_sweeps": out.sweeps - clean.sweeps})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[tenants] {json.dumps(row)}", flush=True)
    require(row["tenant"]["a+recovered"].get("recovered_via") == "restore",
            "tenants full width: the transient kill did not restore")


def tenants_phase(dev) -> None:
    tenant_smoke_rows(dev)
    tenant_full_width_rows(dev)
    print(f"[tenants] card: {card_line()}", flush=True)


# -- phase 8: the chaos harness ---------------------------------------------

def chaos_phase(dev) -> None:
    """The chaos smoke's reduced matrix on stencil, drop-mid and
    kill-restore on CNN, KNN and PageRank (on the obs phase's designs),
    and the two per-tenant cells, at the binders' default sizes: each
    cell's record must equal the port's CPU run of the same cell, and the
    app's kernel must launch in its cells."""
    from repro_torch.chaos.runner import run_matrix, run_tenant_cell
    from repro_torch.chaos.smoke import SMOKE_SCENARIOS, TENANT_SCENARIOS
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cpu = torch.device("cpu")
    kernels = {"stencil": "dilate", "cnn": "matmul", "knn": "knn"}
    short = tuple(sc for sc in SMOKE_SCENARIOS
                  if sc.name in ("drop-mid", "kill-restore"))
    for app in OBS_APPS:
        scenarios = SMOKE_SCENARIOS if app == "stencil" else short
        reset_launch_counts()
        t0 = time.perf_counter()
        card = run_matrix((app,), scenarios, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = launch_counts()
        ref = run_matrix((app,), scenarios, device=cpu)
        for cell, want in zip(card["cells"], ref["cells"]):
            row = {"app": app, "scenario": cell["scenario"],
                   **{k: cell.get(k) for k in (
                       "baseline_sweeps", "sweeps", "overhead_sweeps",
                       "retransmit_bytes", "goodput_hop_bytes",
                       "restore_extra_sweeps")},
                   "equal_cpu": cell == want}
            print(f"[chaos] {json.dumps(row)}", flush=True)
            require(cell == want, f"chaos {app} {cell['scenario']}: the "
                    f"card's record {cell} differs from the CPU's {want}")
        kernel = kernels.get(app)            # PageRank has no kernel
        summary = {"app": app, "matrix_s": card_s, "launches": launches}
        print(f"[chaos] {json.dumps(summary)}", flush=True)
        require(kernel is None or launches[kernel] > 0,
                f"chaos {app}: {kernel} never launched in its cells")
    for sc in TENANT_SCENARIOS:
        reset_launch_counts()
        cell = run_tenant_cell(sc, device=dev)
        torch.cuda.synchronize()
        launches = launch_counts()
        want = run_tenant_cell(sc, device=cpu)
        row = {"tenants": "stencil", "scenario": sc.name,
               "sweeps": cell["sweeps"], "clean_sweeps": cell["clean_sweeps"],
               "by_lineage": cell["ledger"]["by_lineage"],
               "equal_cpu": cell == want, "launches": launches["dilate"]}
        print(f"[chaos] {json.dumps(row)}", flush=True)
        require(cell == want, f"chaos {sc.name}: the card's record differs "
                f"from the CPU's")
        require(launches["dilate"] > 0, f"chaos {sc.name}: dilate never "
                "launched")
    print(f"[chaos] card: {card_line()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script (expected "
              f"{ROOT / 'src' / 'repro_torch'}): {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    import scipy           # its HiGHS breaks the partition MILP's ties
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, scipy {scipy.__version__}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    info = build.build()
    print(f"build: {'built' if info.built else 'reused'} {info.path.name} "
          f"in {info.seconds:.2f} s", flush=True)
    if info.built:
        print(info.log.rstrip(), flush=True)
        cuda_core = ptxas_report(info.log, "flash_kernel")
        print(f"ptxas: flash_kernel instances {json.dumps(cuda_core)}",
              flush=True)
        hd256 = {n: r for n, r in cuda_core.items() if "Li256ELi256E" in n}
        print(f"ptxas: the (256, 256) flash_kernel instances "
              f"{json.dumps(hd256)}", flush=True)
        require(len(hd256) == 2, f"ptxas: {len(hd256)} (256, 256) "
                f"flash_kernel instances, not 2 (fp32, bf16)")
        sm90 = ptxas_report(info.log, "flash_sm90_kernel")
        print(f"ptxas: flash_sm90_kernel instances {json.dumps(sm90)}",
              flush=True)
        mla = [n for n in sm90 if "Li192ELi128E" in n]
        require(len(mla) == 1 and sm90[mla[0]].get("spill_store_bytes") == 0
                and sm90[mla[0]].get("spill_load_bytes") == 0,
                f"ptxas: the (192, 128) flash_sm90_kernel instance spills "
                f"or is missing: {sm90}")
    build.library()
    hgmma = hgmma_counts(info.path)
    print(f"sass: HGMMA instructions per kernel {json.dumps(hgmma)}",
          flush=True)
    tc_kernels = [n for n in hgmma if "flash_sm90_kernel" in n]
    require(len(tc_kernels) == 3 and all(hgmma[n] > 0 for n in tc_kernels),
            f"cuobjdump finds HGMMA in {len(tc_kernels)} tensor-core flash "
            f"kernels, not 3")

    rows = kernel_phase(dev)
    release_kernel_phase()

    launches, designs = {}, {}
    for app, spec, kernel in FULL_SIZE:
        row, designs[app] = path_phase(app, spec, GRAPH_ARGS[app], kernel)
        launches[kernel] = row["launches"][kernel]
    designs["pagerank"] = pagerank_path_phase()[2]
    torch.cuda.empty_cache()
    for app, spec, ks in (("axpy", VEC_SPEC, ("axpy",)),
                          ("dot", VEC_SPEC, ("dot_partials",)),
                          ("gemv", GEMV_SPEC, ("gemv",)),
                          ("axpydot", VEC_SPEC, ("axpy", "dot_partials"))):
        row = hbm_path_phase(app, spec, ks)
        for k in ks:                 # the bank path is the main path
            launches[k] = launches.get(k, 0) + row["launches"][k]
        torch.cuda.empty_cache()
    lm = lm_path_phase(dev)
    lm_rows = lm_rows_phase(dev)
    # Each row's prefill launches are all on its route (serve_row gates
    # it); the kernels line counts them under the row of their head dims.
    launches["flash_attention"] = lm["launches"]["flash_attention"]
    launches["flash_attention_mla"] = launches["flash_attention_hd256"] = 0
    for r in lm_rows.values():
        if r["kernel_row"] is not None:
            launches[r["kernel_row"]] += r["launches"]["flash_attention"]
    torch.cuda.empty_cache()
    obs_phase(dev, designs)
    tenants_phase(dev)
    chaos_phase(dev)

    blas = "src/repro/kernels/hbm_blas/kernel.py"
    sources = {"dilate": ("src/repro_torch/csrc/dilate.cu",
                          "src/repro/kernels/stencil_dilate/kernel.py:52"),
               "matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/systolic_matmul/kernel.py:42"),
               "knn": ("src/repro_torch/csrc/knn.cu",
                       "src/repro/kernels/knn/kernel.py:72"),
               "axpy": ("src/repro_torch/csrc/hbm_blas.cu", f"{blas}:23"),
               "dot_partials": ("src/repro_torch/csrc/hbm_blas.cu",
                                f"{blas}:48"),
               "gemv": ("src/repro_torch/csrc/hbm_blas.cu", f"{blas}:97"),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention_sm90.cu",
                   "src/repro/kernels/flash_attention/kernel.py:99"),
               "flash_attention_mla": (
                   "src/repro_torch/csrc/flash_attention_sm90.cu",
                   "src/repro/kernels/flash_attention/kernel.py:99"),
               "flash_attention_hd256": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:99")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": repl, "launches": launches[name],
                "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
                "bound_ms": rows[name]["bound_ms"],
                "bound_by": rows[name]["bound_by"],
                "library_ms": rows[name]["library_ms"]}
               for name, (src, repl) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
