"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` (one
   ``nvcc`` per source, in parallel) and prints ``ptxas -v`` on a fresh
   build (a spill in the tensor-core flash kernel's (192, 128) or
   (256, 256) instance is a failure; the CUDA-core kernel's two
   (256, 256) instances, fp32 and bf16, are printed on a line of their
   own, and the (64, 64) kernel's two instances, two and three consumer
   warpgroups, on another); counts the ``HGMMA`` instructions that
   ``cuobjdump -sass`` finds in each of the five tensor-core flash
   attention instances, three of ``flash_sm90_kernel`` and two of
   ``flash_sm90_d64_kernel`` (none is a failure).
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
   local-attention layers launch the tensor-core kernel's (256, 256)
   instance once each, all 12 on ``flash_attention_tc``; its RG-LRU
   layers none) and xlstm-1.3b (48 mLSTM and sLSTM layers, 3.4 GiB; no
   launch).  The
   engine keeps its cache from one request to the next, as JAX's does, so
   each engine call that a gate compares gets a fresh engine.  Then their
   fp32 parity as in (d): recurrentgemma at 1 super-block and its 2 extra
   layers (the GQA layer on the CUDA-core kernel's fp32 (256, 256)
   instance), xlstm at 1
   super-block (8 layers; the 32-token prefill is one mLSTM chunk).
   (f) mistral-nemo-12b (40 layers, 22.8 GiB) and gemma2-27b (46 layers,
   50.7 GiB: softcaps 50 and 30, window 4096, post-norms, GeGLU) at full
   size, as the rows of (c), every launch on the tensor cores; then
   seamless-m4t-large-v2 (24 encoder and 24 decoder layers, 3.30 GiB) and
   llava-next-34b (60 layers, 64.05 GiB, last, with every earlier row's
   weights freed) at full size.  seamless's prefill step takes 512 frame
   embeddings ``src`` [4, 512, 1024] beside its 4 x 2048 tokens and
   launches 72 flash kernels (24 encoder layers without a mask, 24
   causal, 24 cross attention: 2048 queries on 512 keys, no mask);
   llava's takes 576 patch embeddings ``frontend`` [4, 576, 7168] and
   4 x 1472 tokens, 60 launches at G = 7; all on the tensor cores.  Both
   inputs are drawn on the card from seed 0.  The engine serves both on
   text tokens alone, as JAX's does (ROADMAP reference caveat 7); seamless
   also decodes through ``build_serve_step`` with the prefill's encoder
   output (32 + 32 tokens; one cross-attention launch a decoder layer and
   step, all on the tensor cores), printing its tokens/s and a step's
   wall and device ms.  Their fp32 parity at cut depth, gated at 1e-4:
   mistral-nemo 2 layers, gemma2 1 super-block (a local and a global
   layer), seamless one encoder and one decoder layer (decode with the
   encoder's output over 512 frames), llava 2 layers (the prefill's 576
   patches are the embeddings of a 576-token prompt prefix, decode runs
   the 608 tokens).
5b. Training (``[train]`` lines, after the LM rows; its flash launches
   stay off the ``kernels`` line, whose counts are the serve path's).
   (a) Six rows (``TRAIN_ROWS``), each at full width in bf16 taking steps
   (JAX's optimizer defaults) through ``build_train_step`` at 4 x 2048
   tokens from the port's pipeline (seed 0), each row's state freed
   before the next: qwen3-4b (4.02 B parameters) with AdamW, one warm-up
   step and four timed; then one warm-up step and two timed each for
   recurrentgemma-9b (9.40 B, 38 layers) with Adafactor, xlstm-1.3b (48
   layers, the per-layer recompute of its 8-layer pattern) with AdamW,
   seamless-m4t-large-v2 (1.77 B, 24 encoder layers over src
   [4, 512, 1024] and 24 decoder layers with cross attention, all at
   (64, 64)) with AdamW, llava-next-34b cut to 6 of 60 layers (4.26 B,
   576 patches among the 2048 positions, G = 7) with AdamW, and
   deepseek-v2-236b cut to 1 of 60 layers (5.02 B: MLA at (192, 128),
   160 routed experts) with Adafactor.  Each
   prints every step's loss, wall seconds, tokens/s and MFU (the model
   FLOPs of ``train_step_flops``: 6 × the weights a token uses × the
   tokens, the encoder's on its frames, a MoE layer's routed experts at
   top_k / num_experts, plus the attention's products at each use's
   pairs and dims, forward and backward, over the wall time,
   against 989 TFLOP/s), then one step under the profiler (device ms, by
   kernel class and the top kernels, and their share of the mean step's
   wall time), one optimizer update alone, the step's and the row's peak
   device bytes, and ``launch.analytic``'s ``train_flops`` and
   ``train_hbm_bytes`` for the step.  Gates: every loss finite, each
   step's flash launches ``train_flash_launches`` (qwen3-4b 72,
   recurrentgemma 24: each attention layer's forward and its recompute;
   xlstm none; seamless 144; llava 12; deepseek-v2 2), all on the tensor
   cores, the peak within 76 GB; each row prints its depth and ``row_s``.
   (b) fp32 at full width and cut depth (qwen3-4b 2 layers, gemma2-27b
   one super-block: softcaps, window, post-norms; recurrentgemma-9b one
   super-block and its 2 extra layers; xlstm-1.3b one super-block of 8
   layers; seamless one encoder and one decoder layer; llava 2 layers
   with its patches) on 1 x 2048 tokens: ``train_loss`` and every leaf's gradient
   with the flash kernel forward and the backward of
   ``kernels/flash_attention/backward.py``, RG-LRU's scan Function,
   sLSTM's prefill form and the recompute, against autograd of the plain
   versions (``attention_ref``, ``rglru_scan_ref``, sLSTM's step loop)
   with nothing recomputed: the loss within 1e-5 relative, each leaf
   within 1e-4 of its norm.  (c) The flash op alone at each
   tensor-core shape of rows 7 to 7e, batch 1: dq, dk, dv in bf16 within
   twice the error of autograd of ``attention_ref`` on the same bf16
   operands, both from fp32; the backward's time at (a)'s shape beside
   the forward's.  (d) The Trainer on qwen3-4b ``smoke()`` in fp32
   (AdamW, lr 1e-3): 6 steps saving every 2, killed after step 3 and
   resumed under ``run_with_restarts``, the same params bit for bit as an
   uninterrupted run; and 30 steps on one batch (lr 3e-3) halve the loss.
5c. The mesh (``[mesh]`` lines, after the training rows), on a one-rank
   NCCL group's (1, 1) ('data', 'model') mesh (NCCL cannot place two
   ranks on one card; the multi-rank checks are the CPU tests').  (a)
   qwen3-4b ``full()`` with AdamW at 4 x 2048 tokens: two steps through
   ``build_train_step(mesh=)`` from the seeded state sharded by the rules
   (``shard_state``), against two no-mesh steps from the same state and
   batches (their leaves kept on the host): each loss and every param
   and moment leaf the same bits (every collective at world 1 is an
   identity), 72 flash launches a step, all on the tensor cores, the
   peak within 76 GB; each step's wall seconds beside the ``[train]``
   row's mean.  (b) ``compressed_psum`` of a full-width fp32 leaf over
   that group: the bits of the same call on the CPU over a one-rank gloo
   group.  (c) The prefill step over the 4 x 2048 prompts and 8 decode
   steps of qwen3-4b through ``mesh=`` (the train layout for the
   prefill, the serving layout and ``cache_shardings`` for decode): the
   no-mesh logits bit for bit.
5d. The dry run (``[dryrun]`` lines, last): ``python -m
   repro_torch.launch.dryrun`` for qwen3-4b ``train_4k`` on the 16 x 16
   mesh and deepseek-v3-671b ``decode_32k`` on the 2 x 16 x 16 one, each
   in a subprocess on the host's CPU (its fake process group cannot share
   a process with the NCCL one), both started after the last timed card
   phase (so no timed phase shares the host with them; phase 9 runs
   beside them), with 600 s each.  Each record must be ``ok``;
   prints its plan, memory, FLOPs and bytes per rank, collective bytes by
   kind within a pod and across pods, and the roofline terms at the
   H100's data-sheet rates.

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
9. The entry points and the examples (``[examples]`` lines, on the card
   while the dry runs use the host's CPU).  (a) ``run_numeric`` of
   stencil, KNN, CNN and PageRank at the JAX package's defaults, and CNN's
   at a VGG-16 conv3 layer (56 x 56 x 256 -> 256), each against the same
   call with ``device="cpu"`` (the plain versions): stencil bit for bit,
   KNN within 1e-4 with equal indices, CNN within 2e-4 of the output's
   scale, PageRank within 1e-5 of the largest rank; dilate must launch 4
   times (``iters``), knn once, and CNN's product once on the tiled
   kernel (``route`` is ``"tiled"``; the ``matmul`` counter 1 as well, so
   the narrow kernel never ran), which gives the ``matmul_tiled`` rows'
   launches.  (b) The examples' card parts, called from
   ``examples/torch_*.py``: the quickstart's KNN design (compiled without
   floorplans) executed on the card, its outputs within 1e-4 of the same
   design executed with ``device="cpu"``, equal indices, every
   ``agreement()`` value true, knn launched; its 20 AdamW steps of
   qwen3-4b ``smoke()``, every loss finite and the last below the first;
   multi_fpga_apps' ``fabric_execution``, bit-identical to the ideal path,
   dilate launched; serve_lm twice, equal tokens from the generator's seed
   7; train_lm ending at step 60 after one injected failure, resumed from
   the step-20 checkpoint, every loss finite.  Prints the phase's wall
   time.

The flash attention row (phase 3) holds both kernels, on the same bf16
inputs, to their plain version at the prefill step's shape (causal), at
chatglm3-6b's prefill shape (32 query heads on 2 KV heads, G = 16, over
all 16 key tiles; causal) and at the feature cases of ``kernels/flash_attention/cases.py`` (GQA, MQA,
Sq < Sk, ragged lengths, window, softcap, both, non-causal, a fully masked
leading block) at d = 128 and d = 64: elementwise within
atol = rtol = 2e-2, each row within 1e-2 of its norm, and the tensor cores
no further than twice the CUDA-core kernel's error from the fp32 plain
version.  Three planted faults at the main shape (the last query block's
rows without their first or their diagonal key tile, at the instance's
key tile: 128 keys, 64 at (256, 256); and the last query tile's rows
never written, at the instance's query tile: 128 rows, and at head dim
64 192 past Sq = 512) must fail the row check.  The
same cases in fp32 at d = 32, 64 and 128 go to the CUDA cores (within
2e-5).  It also times the CUDA-core kernel and a non-causal call at the
main shape.  Its yardstick is ``F.scaled_dot_product_attention``
(``is_causal=True, enable_gqa=True``), its bound the bf16 tensor-core rate
(989 TFLOP/s) over the visible (query, key) pairs.  The matmul row names
the kernel each of its two shapes takes (narrow at N = 4, tiled at
N = 80), checks that two runs agree bit for bit, and times the tiled
kernel at N = 4 beside the narrow one.  The ``matmul_tiled`` and
``matmul_tiled_vgg_conv3`` rows hold the tiled kernel at the products
``route()`` sends it from CNN's ``run_numeric``: its default, [1024, 576]
x [576, 64], and a VGG-16 conv3 layer, 56 x 56 x 256 -> 256 ([3136, 2304]
x [2304, 256]); each within 2e-4 of ``matmul_ref``'s scale (TF32 off),
two runs bit-equal, timed beside ``matmul_ref`` and ``torch.matmul``
(TF32 off), its bound fp32 operations at the CUDA cores' rate against the
bytes; their launches are phase 9's.  Each of the three matmul rows
prints ``tiled_plan``'s plan (tile, K splits, blocks).  The
``matmul_tiled_edges`` row holds the tiled route at its edges, each within
2e-4 of ``matmul_ref``'s scale and two runs bit-equal: [1024, 576] x
[576, 17] (just past the narrow route), N % 4 != 0 (300 x 200 x 150),
K % 4 != 0 (65 x 17 x 129, 1024 x 575 x 64), 1 x 1 x 32, a deep split
(64 x 4096 x 64), an A 4 bytes past a 16-byte boundary (a [1024, 576]
view of a flat buffer from element 1) and M = 4,194,305, past the grid
limit of the kernel it replaced.  After the build a ``ptxas:`` line gives
the three tiled instances' registers and spills (a spill fails the smoke).
The ``flash_attention_mla`` row
holds both kernels' (192, 128) instances at MLA's shape (causal) and at
every feature case at d = 192, dv = 128: bf16 on the tensor cores under
the flash row's gates (and its two planted faults at MLA's shape), fp32
on the CUDA cores within 2e-5; the tensor cores must take at most a
tenth of the CUDA cores' time at MLA's shape.  Its bound counts 2·(d + dv)
operations a visible pair at the bf16 tensor-core rate, its yardstick is
``F.scaled_dot_product_attention(is_causal=True)``, timed with CUDA
events around 10 back-to-back calls.  After the build, ``ptxas``
registers and spills of each flash_kernel, flash_sm90_kernel and
flash_sm90_d64_kernel instance are printed.

The ``flash_attention_g7`` row (llava-next-34b's q [4, 56, 2048, 128]
on k, v [4, 8, 2048, 128], causal) and the ``flash_attention_seamless``
row's three uses (head dim 64: the encoder's [4, 16, 512, 64] and the
decoder's [4, 16, 2048, 64], cross attention's 2048 queries on 512 keys;
the encoder's and cross attention's without a mask) hold the tensor
cores under the flash row's gates, each with three planted faults (one key
tile skipped: the first or the diagonal one when causal, the first or the
last one without a mask; the last query tile never written: seamless's
decoder and cross attention the ragged 128 rows past 10 tiles of 192);
the cross use also holds the decode step's one query on 512 keys.  Each
is timed beside the plain version and SDPA (``enable_gqa`` at G = 7);
their bound counts 2 B an element of q, k, v and o and 4·d operations a
visible pair.  The seamless row's times and bound are its three uses'
means (its prefill launches each 24 times); each use prints its TFLOP/s,
its instance of ``flash_sm90_d64_kernel`` (two consumer warpgroups at
the encoder's 512 rows, three at 2048) and that instance's ``ptxas``
registers and spills.

The ``flash_attention_hd256`` row holds both kernels' (256, 256)
instances at recurrentgemma-9b's prefill shape (q [4, 16, 2048, 256], k,
v [4, 1, 2048, 256], causal, window 2048), at B 1, S 4096, where the
window bites, and at ``cases.HD256_CASES``: bf16 on the tensor cores'
64-key tiles under the flash row's gates (both kernels against the plain
version, the tensor cores within twice the CUDA cores' error from fp32),
with the two planted faults at 64 keys; fp32 on the CUDA cores within
2e-5.  The tensor cores must take at most a tenth of the CUDA cores' time
at the main shape.  Its bound counts 2·(d + dv) operations a visible pair
at the bf16 tensor-core rate, its yardstick is
``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``.

Prints the ``kernels`` JSON line, then the card line, and last
``{"ok": true, "device": {...}}``.  Needs no network and one card.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import logging
import math
import os
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
# A decode step's device ms and ATen ops are read over a generate of this
# many steps (half prompt, half new tokens): a step's work does not depend
# on its position (attention reads the whole SERVE_MAX_LEN cache), and the
# profiler and the op count cost the host far more than the steps.
PROFILE_STEPS = 8
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
    ("recurrentgemma-9b", None, "tensor_core", "flash_attention_hd256",
     "full depth, 38 layers: 26 RG-LRU and 12 local-attention layers "
     "(head dim 256, one kv head, window 2048)"),
    ("xlstm-1.3b", None, "none", None,
     "full depth, 48 layers: 42 mLSTM and 6 sLSTM, no attention"),
    ("mistral-nemo-12b", None, "tensor_core", "flash_attention",
     "full depth, 40 layers"),
    ("gemma2-27b", None, "tensor_core", "flash_attention",
     "full depth, 46 layers: 23 local (window 4096) and 23 global, "
     "attention softcap 50, final softcap 30, post-norms, GeGLU"),
    ("seamless-m4t-large-v2", None, "tensor_core", "flash_attention_seamless",
     "full depth, 24 encoder and 24 decoder layers; the prefill's encoder "
     "runs over 512 frames (src [4, 512, 1024]), each decoder layer's "
     "cross attention over its output"),
    # Last: its 64.05 GiB of bf16 weights need the rows before it freed.
    ("llava-next-34b", None, "tensor_core", "flash_attention_g7",
     "full depth, 60 layers (G = 7); the prefill's 2048 positions are 576 "
     "patch embeddings (frontend [4, 576, 7168]) and 1472 tokens"),
)
# fp32 prefill-against-decode parity at cut depth: (arch, superblocks
# kept, an enc-dec config's encoder super-blocks too, prompt tokens).
# recurrentgemma keeps its 2 extra layers, so its GQA layer runs the fp32
# (256, 256) instance; xlstm's one super-block is 8 layers, its 32-token
# prefill one mLSTM chunk and its 1024-token prefill two 512-token chunks,
# whose (C, n, m) carry decode must reproduce.  seamless decodes with the
# encoder's output over 512 frames; llava's prefill takes the embeddings
# of a 576-token prompt prefix as its patches, decode the prefix as tokens.
FP32_PARITY = (("recurrentgemma-9b", 1, SERVE_PROMPT),
               ("xlstm-1.3b", 1, SERVE_PROMPT), ("xlstm-1.3b", 1, 1024),
               ("mistral-nemo-12b", 2, SERVE_PROMPT),
               ("gemma2-27b", 1, SERVE_PROMPT),
               ("seamless-m4t-large-v2", 1, SERVE_PROMPT),
               ("llava-next-34b", 2, SERVE_PROMPT))
# recurrentgemma-9b's local attention: q [B, 16, S, 256], k, v
# [B, 1, S, 256], window 2048; the window bites at S = 4096.
HD256_HEADS, HD256_KV_HEADS, HD256_D, HD256_WINDOW = 16, 1, 256, 2048
MLA_PARITY_ARCH, MLA_PARITY_SUPERBLOCKS = "deepseek-v2-236b", 1
# MLA's prefill operands at full width: q, k [B, 128, S, 192] and v
# [B, 128, S, 128].
MLA_HEADS, MLA_D, MLA_DV = 128, 192, 128
# llava-next-34b's prefill attention: q [4, 56, 2048, 128], k, v
# [4, 8, 2048, 128] (G = 7), causal.  seamless-m4t-large-v2's, at head
# dim 64 with 16 heads (G = 1): the encoder's [4, 16, 512, 64], the
# decoder's [4, 16, 2048, 64], and cross attention's 2048 queries on 512
# keys (the encoder's frames: seq // 4).
G7_HEADS, G7_KV_HEADS = 56, 8
SEAMLESS_HEADS, SEAMLESS_D, SEAMLESS_FRAMES = 16, 64, PREFILL_LEN // 4
# The flash feature cases run in fp32 at these head dims (the CUDA cores)
# and in bf16 at the tensor cores' two.
FLASH_FP32_DIMS = (32, 64, 128)
FLASH_BF16_DIMS = (128, 64)
# The [train] phase's full-width rows: (arch, optimizer, timed steps,
# super-blocks to keep or None for full depth), each at the prefill's
# 4 × 2048 tokens from the port's pipeline, one warm-up step before the
# timed ones, each on a fresh batch.
# - qwen3-4b, AdamW (JAX's defaults).  Its memory from the code: bf16
#   params 8.04 GB, bf16 grads 8.04 GB and fp32 moments 32.2 GB (48.3 GB),
#   the 36 saved layer inputs 1.51 GB, one layer's recompute, one 512-row
#   cross-entropy chunk (fp32 logits [4, 512, 151936], 1.24 GB) and the
#   fp32 table copy of `unembed` (1.56 GB): about 60 GB of the 80.
# - recurrentgemma-9b, Adafactor: 9.40 B parameters, whose AdamW state
#   (75 GB of fp32 moments) would not fit.  bf16 params and grads 37.6 GB,
#   Adafactor's fp32 temporaries on the 1.05 B-element embedding about
#   17 GB, `unembed`'s fp32 table copies (4.2 GB each): its peak on an
#   H100 80GB HBM3 read 71.4 GB.
# - xlstm-1.3b, AdamW: 1.82 B parameters by the config's count, 48 layers
#   with the per-layer recompute of its 8-layer pattern.
# - seamless-m4t-large-v2, AdamW, full depth (24 encoder and 24 decoder
#   layers): 1.772 B parameters; bf16 params and grads 7.1 GB, fp32
#   moments 14.2 GB, one 512-row chunk's fp32 logits over 256,206 words
#   2.1 GB, `unembed`'s fp32 table copy 1.05 GB: about 28 GB (its peak on
#   an H100 80GB HBM3 read 30.5 GB).  The encoder runs over src
#   [4, 512, 1024]; 144 flash launches a step at (64, 64): encoder,
#   decoder and cross attention.
# - llava-next-34b, AdamW, 6 of its 60 layers (G = 7, the 576 patches among
#   the 2048 positions): 4.265 B parameters; bf16 params and grads
#   17.1 GB, fp32 moments 34.1 GB, `unembed`'s fp32 copy of the untied
#   64000 × 7168 table 1.84 GB, one layer's recompute about 1.3 GB: about
#   58 GB (read 58.7 GB).  The 60 layers' params, grads and moments would
#   be 413 GB.
# - deepseek-v2-236b, Adafactor, 1 of its 60 layers (MLA at (192, 128),
#   160 routed experts, top 6, capacity 384 slots an expert a step):
#   5.021 B parameters; bf16 params and grads 20.1 GB, Adafactor's fp32
#   temporaries on the 1.26 B-element expert leaves: its peak read
#   60.5 GB.  AdamW's moments (40 GB) would not fit beside them.
TRAIN_ROWS = (("qwen3-4b", "adamw", 4, None),
              ("recurrentgemma-9b", "adafactor", 2, None),
              ("xlstm-1.3b", "adamw", 2, None),
              ("seamless-m4t-large-v2", "adamw", 2, None),
              ("llava-next-34b", "adamw", 2, 6),
              ("deepseek-v2-236b", "adafactor", 2, 1))
TRAIN_ARCH = LM_ARCH
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS = PREFILL_BATCH, PREFILL_LEN, 36
TRAIN_WARMUP = 1
TRAIN_PEAK_LIMIT = 76e9
# Gradient parity at cut depth and full width, fp32, 1 × 2048 tokens:
# qwen3-4b's first 2 layers; gemma2-27b's first super-block (a local and a
# global layer: softcap 50, window 4096, final softcap 30);
# recurrentgemma-9b's first super-block and its 2 extra layers (4 RG-LRU
# layers, one local-attention layer at (256, 256)); xlstm-1.3b's first
# super-block (7 mLSTM layers and an sLSTM, under both recompute levels);
# seamless-m4t-large-v2's first encoder and first decoder layer (the
# encoder's cut to the decoder's super-blocks: encoder, decoder and cross
# attention at (64, 64) over 512 frames); llava-next-34b's first 2 layers
# with its 576 patches (G = 7).
GRAD_PARITY = (("qwen3-4b", 2), ("gemma2-27b", 1),
               ("recurrentgemma-9b", 1), ("xlstm-1.3b", 1),
               ("seamless-m4t-large-v2", 1), ("llava-next-34b", 2))
GRAD_SEQ = PREFILL_LEN
# The flash op's gradient at each tensor-core shape of the serve rows,
# batch 1: (row, (B, H, K, Sq, Sk, d, dv), keywords).
FLASH_GRAD_CASES = (
    ("7", (1, 32, 8, 2048, 2048, 128, 128), {}),
    ("7b", (1, 128, 128, 2048, 2048, 192, 128), {}),
    ("7c", (1, 16, 1, 2048, 2048, 256, 256), {"window": HD256_WINDOW}),
    ("7d", (1, G7_HEADS, G7_KV_HEADS, 2048, 2048, 128, 128), {}),
    ("7e encoder", (1, 16, 16, 512, 512, 64, 64), {"causal": False}),
    ("7e decoder", (1, 16, 16, 2048, 2048, 64, 64), {}),
    ("7e cross", (1, 16, 16, 2048, 512, 64, 64), {"causal": False}),
)

# The tiled matmul's own rows: CNN's run_numeric at the JAX package's
# default (32 x 32 x 64 -> 64) and a VGG-16 conv3 layer (56 x 56 x 256 ->
# 256), each an im2col product that route() sends to the tiled kernel:
# (kernels-line row, (h, w, cin, cout), reps a CUDA graph holds).
TILED_ROWS = (("matmul_tiled", (32, 32, 64, 64), 200),
              ("matmul_tiled_vgg_conv3", (56, 56, 256, 256), 20))
# The tiled matmul's edges (M, K, N, A's offset in floats from a 16-byte
# boundary), held in the kernel phase (``matmul_tiled_edges``).
TILED_EDGES = ((1024, 576, 17, 0), (300, 200, 150, 0), (65, 17, 129, 0),
               (1024, 575, 64, 0), (1, 1, 32, 0), (64, 4096, 64, 0),
               (1024, 576, 64, 1), (4_194_305, 4, 17, 0))
# The examples phase: each entry point's run_numeric on the card against
# the same call with device="cpu" (the plain versions): (app, keywords,
# the launch counter it must raise, by how much, the kernels-line row
# whose launches it gives).
NUMERIC_RUNS = (("stencil", {}, "dilate", 4, None),
                ("knn", {}, "knn", 1, None),
                ("cnn", {}, "matmul_tiled", 1, "matmul_tiled"),
                ("cnn", {"h": 56, "w": 56, "cin": 256, "cout": 256},
                 "matmul_tiled", 1, "matmul_tiled_vgg_conv3"),
                ("pagerank", {}, None, 0, None))


# ptxas -v of the (64, 64) kernel's two instances (two and three consumer
# warpgroups), by mangled name, from the build: the seamless uses print
# their instance's.
D64_PTXAS: dict = {}


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
                          tiled_ms=tiled_ms, tiled_plan=plan_of(M, K, cpc),
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
    t0 = time.perf_counter()
    new = flash_new_arch_rows(dev, gen)
    new["flash_attention_g7"]["rows_s"] = time.perf_counter() - t0
    rows.update(new)
    rows.update(matmul_tiled_rows(dev))
    rows["matmul_tiled_edges"] = matmul_tiled_edges(dev)
    for name, row in rows.items():
        print(f"[kernel] {name} {json.dumps(row)}", flush=True)
    return rows


def matmul_tiled_rows(dev) -> dict:
    """The tiled matmul kernel at TILED_ROWS' im2col products (inputs from
    a generator of their own, seed 1, so the earlier rows' inputs stay
    as they were): route() must pick it; held to ``matmul_ref`` with TF32
    off within 2e-4 of the output's scale, two runs bit-equal; ``ms`` (the
    wrapper), ``plain_ms`` (``matmul_ref``) and ``library_ms``
    (``torch.matmul``, TF32 off) as CUDA-graph device times, the bound
    from fp32 operations at the CUDA cores' peak against the bytes."""
    from repro_torch.kernels.systolic_matmul.kernel import matmul, route
    from repro_torch.kernels.systolic_matmul.ref import im2col3x3, matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    for name, (h, w, cin, cout), reps in TILED_ROWS:
        x = torch.randn(h, w, cin, device=dev, generator=gen)
        a = im2col3x3(x)
        b = torch.randn(9 * cin, cout, device=dev, generator=gen) * 0.05
        (M, K), N = a.shape, cout
        require(route(M, K, N) == "tiled",
                f"{name}: route({M}, {K}, {N}) is {route(M, K, N)}")
        got = matmul(a, b)
        ref = matmul_ref(a, b)
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        require(err <= 2e-4 * scale,
                f"{name} [{M},{K}]x[{K},{N}] err {err:.3e} > 2e-4*{scale:.2f}")
        require(torch.equal(got, matmul(a, b)),
                f"{name} [{M},{K}]x[{K},{N}]: two runs differ")
        ms = graph_ms(lambda i: matmul(a, b), reps)
        plain = graph_ms(lambda i: matmul_ref(a, b), reps)
        lib = graph_ms(lambda i: torch.matmul(a, b), reps)
        nbytes = 4 * (M * K + K * N + M * N)
        ops = 2 * M * K * N
        bnd, by = bound(nbytes, ops)
        rows[name] = dict(shape=[M, K, N], conv=[h, w, cin, cout],
                          route="tiled", max_abs_err=err, scale=scale,
                          two_runs_equal=True, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bnd, bound_by=by,
                          bytes=nbytes, ops=ops, tflops=ops / ms / 1e9,
                          over_library=ms / lib, plan=plan_of(M, K, N),
                          device_kernels=device_kernels(
                              lambda: matmul(a, b)))
        del x, a, b, got, ref
    return rows


def plan_of(M: int, K: int, N: int) -> dict:
    """The tiled kernel's plan for [M, K] x [K, N] (``tiled_plan``)."""
    from repro_torch.kernels.systolic_matmul.kernel import tiled_plan
    plan = tiled_plan(M, K, N)
    return dict(tile=[plan.bm, plan.bn], splits=plan.splits,
                blocks=plan.blocks)


def matmul_tiled_edges(dev) -> dict:
    """The tiled route at TILED_EDGES' products (inputs from a generator of
    their own, seed 2): route() must pick it; each within 2e-4 of
    ``matmul_ref``'s scale (TF32 off), two runs bit-equal, with its plan."""
    from repro_torch.kernels.systolic_matmul.kernel import matmul, route
    from repro_torch.kernels.systolic_matmul.ref import matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {}
    for M, K, N, offset in TILED_EDGES:
        name = f"{M}x{K}x{N}" + (f"+{4 * offset}B" if offset else "")
        flat = torch.randn(M * K + offset, device=dev, generator=gen)
        a = flat[offset:].view(M, K)
        b = torch.randn(K, N, device=dev, generator=gen) * 0.05
        require(route(M, K, N) == "tiled",
                f"tiled edge {name}: route is {route(M, K, N)}")
        require((a.data_ptr() % 16 == 0) == (offset == 0),
                f"tiled edge {name}: A's alignment is not the case's")
        got = matmul(a, b)
        ref = matmul_ref(a, b)
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        require(err <= 2e-4 * scale,
                f"tiled edge {name}: err {err:.3e} > 2e-4*{scale:.2f}")
        require(torch.equal(got, matmul(a, b)),
                f"tiled edge {name}: two runs differ")
        errs[name] = dict(max_abs_err=err, scale=scale,
                          plan=plan_of(M, K, N))
        del flat, a, b, got, ref
    worst = max(r["max_abs_err"] / r["scale"] for r in errs.values())
    return dict(max_abs_err_over_scale=worst, two_runs_equal=True,
                cases=errs)


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


def flash_bf16_check(label, q, k, v, **kw) -> tuple:
    """flash_attention on bf16 inputs, routed to the tensor cores, held to
    the plain version elementwise and row by row.  The CUDA cores run too
    under the same gates, and the tensor cores must be at most twice the
    CUDA cores' error from the fp32 plain version (both round p and the
    output at the same places).  The output must be [B, H, Sq, dv].
    Returns the readings by kernel ("tc", "cc"), the tensor cores' output
    and the plain one."""
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (
        _launch_cuda_core, flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    require(route(q, k, v) == "tensor_core",
            f"flash_attention bf16 {label} not routed to the tensor cores")
    want = attention_ref(q, k, v, **kw)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    out, reading = None, {}
    for name, launch in (("tc", flash_attention), ("cc", _launch_cuda_core)):
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
    require(reading["tc"]["vs_fp32"] <= 2 * reading["cc"]["vs_fp32"],
            f"flash_attention bf16 {label}: tensor cores "
            f"{reading['tc']['vs_fp32']:.3e} from fp32, CUDA cores "
            f"{reading['cc']['vs_fp32']:.3e}")
    return reading, out, want


def planted_faults(label, q, k, v, got, want, causal=True) -> dict:
    """The tensor cores' output ``got`` with its last T rows recomputed
    without one of their key tiles of T keys, T the key tile of the
    instance that takes q's head dim (``tc_key_tile``: 128, 64 at 256), as
    a kernel that skipped that tile would give them: the first tile or
    the diagonal one (causal, Sq = Sk), the first tile or the last one
    (no mask, any Sq and Sk); and with the rows of its last query tile
    (``tc_query_tile``: 128, and at head dim 64 192 past Sq = 512, the
    ragged 128 rows from 1920 at Sq = 2048) never written, as a kernel
    that skipped that work tile would leave them (zeros here: the
    wrapper's ``torch.empty`` holds whatever the memory held).  The row
    gate must reject each; the elementwise gate's reading is printed
    beside it."""
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (tc_key_tile,
                                                            tc_query_tile)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    Sq, Sk, T = q.shape[2], k.shape[2], tc_key_tile(q.shape[3])
    R = tc_query_tile(q.shape[3], Sq)
    if causal:
        require(Sq == Sk, f"{label}: causal planted faults need Sq == Sk")
        faults = {"skips_first_tile": (k[:, :, T:], v[:, :, T:], True),
                  "skips_diagonal_tile": (k[:, :, :Sk - T], v[:, :, :Sk - T],
                                          False)}
    else:
        faults = {"skips_first_tile": (k[:, :, T:], v[:, :, T:], False),
                  "skips_last_tile": (k[:, :, :Sk - T], v[:, :, :Sk - T],
                                      False)}
    planted = {}
    for name, (kk, vv, fault_causal) in faults.items():
        bad = got.clone()
        bad[:, :, Sq - T:] = attention_ref(q[:, :, Sq - T:], kk, vv,
                                           causal=fault_causal)
        planted[name] = dict(row_rel_err=cases.row_rel_err(bad, want),
                             norm_rel_err=norm_rel(bad, want),
                             excess=cases.excess(bad, want))
        require(planted[name]["row_rel_err"] > cases.ROW_REL_LIMIT,
                f"{label}: the row gate passes the planted fault {name} "
                f"({planted[name]})")
        del bad
    bad = got.clone()
    bad[:, :, (Sq - 1) // R * R:] = 0
    planted["skips_last_query_tile"] = dict(
        rows=[(Sq - 1) // R * R, Sq],
        row_rel_err=cases.row_rel_err(bad, want),
        norm_rel_err=norm_rel(bad, want), excess=cases.excess(bad, want))
    require(planted["skips_last_query_tile"]["row_rel_err"]
            > cases.ROW_REL_LIMIT,
            f"{label}: the row gate passes the planted fault "
            f"skips_last_query_tile ({planted['skips_last_query_tile']})")
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
    """Both kernels' (256, 256) instances at recurrentgemma-9b's prefill
    shape (q [4, 16, 2048, 256], k, v [4, 1, 2048, 256]; [B, S, H, d]
    tensors seen as [B, H, S, d], as the model gives them; causal, window
    2048), at a shape where the window bites (B 1, S 4096), and at
    ``cases.HD256_CASES``: bf16 on the tensor cores' 64-key tiles under the
    flash row's gates (both kernels against the plain version elementwise
    and row by row, the tensor cores within twice the CUDA cores' error
    from fp32), fp32 on the CUDA cores within FP32_ATOL.  The two planted
    faults at the main shape, each one 64-key tile skipped, must fail the
    row gate.  Times the tensor cores, the CUDA cores and a non-causal
    call (CUDA-graph replay), the plain version and SDPA
    (``is_causal=True, enable_gqa=True``; the window does not bite at
    S = 2048, so that is the same function); the tensor cores must take at
    most a tenth of the CUDA cores' time."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (
        _launch_cuda_core, flash_attention, route, tc_key_tile)
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
            label, *qkv(*shape, torch.bfloat16), **kw)[0]
    H, K, W = HD256_HEADS, HD256_KV_HEADS, HD256_WINDOW
    bites_shape = (1, H, K, 2 * PREFILL_LEN, 2 * PREFILL_LEN)
    bites = dict(fp32=flash_fp32_check(
        "hd256 window bites", *qkv(*bites_shape, torch.float32, bshd=True),
        window=W))
    torch.cuda.empty_cache()
    bites["bf16"] = flash_bf16_check(
        "hd256 window bites", *qkv(*bites_shape, torch.bfloat16, bshd=True),
        window=W)[0]
    torch.cuda.empty_cache()
    B, S = PREFILL_BATCH, PREFILL_LEN
    q, k, v = qkv(B, H, K, S, S, torch.float32, bshd=True)
    fp32_main = flash_fp32_check("hd256 main shape", q, k, v, window=W)
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = qkv(B, H, K, S, S, torch.bfloat16, bshd=True)
    main, got, want = flash_bf16_check("hd256 main shape", q, k, v,
                                       window=W)
    require(got.transpose(1, 2).is_contiguous(),
            "flash_attention_hd256: the output is not laid out like q")
    planted = planted_faults("flash_attention_hd256", q, k, v, got, want)
    del got, want
    torch.cuda.empty_cache()
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, o; k, v
    ops = 2 * 2 * HD256_D * B * H * visible_pairs(S, S)
    b, by = bound(nbytes, ops, PEAK_BF16_PER_S)
    ms = graph_ms(lambda i: flash_attention(q, k, v, window=W), 10,
                  replays=3)
    cuda_core_ms = graph_ms(lambda i: _launch_cuda_core(q, k, v, window=W),
                            2, replays=2)
    require(ms <= cuda_core_ms / 10,
            f"flash_attention_hd256: the tensor cores take {ms:.4f} ms, "
            f"more than a tenth of the CUDA cores' {cuda_core_ms:.4f} ms")
    noncausal_ms = graph_ms(
        lambda i: flash_attention(q, k, v, causal=False), 10, replays=3)
    plain = cuda_ms(lambda: attention_ref(q, k, v, window=W), 2, warmup=1)
    torch.cuda.empty_cache()
    lib = graph_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10, replays=3)
    return dict(shape=[B, H, K, S, S, HD256_D, HD256_D], dtype="bf16",
                causal=True, window=W, kernel=route(q, k, v),
                key_tile=tc_key_tile(HD256_D),
                max_abs_err=main["tc"]["max_abs_err"], main=main,
                fp32_max_abs_err=fp32_main, window_bites=dict(
                    shape=[1, H, K, 2 * S, 2 * S, HD256_D], **bites),
                atol=cases.ATOL, rtol=cases.RTOL,
                row_rel_limit=cases.ROW_REL_LIMIT, planted_faults=planted,
                bf16_cases=bf16_cases, fp32_cases=fp32_cases, ms=ms,
                tflops=ops / ms / 1e9, cuda_core_ms=cuda_core_ms,
                noncausal_ms=noncausal_ms,
                noncausal_tflops=4 * HD256_D * B * H * S * S
                / noncausal_ms / 1e9,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
                library="F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), bf16",
                bytes=nbytes, ops=ops,
                device_kernels=device_kernels(
                    lambda: flash_attention(q, k, v, window=W), 5))


def flash_use_row(label, dev, gen, B, H, K, Sq, Sk, d, causal) -> dict:
    """flash_attention at one prefill shape of an arch: q [B, H, Sq, d], k,
    v [B, K, Sk, d] in bf16, ``[B, S, H, d]`` tensors seen as
    ``[B, H, S, d]`` as the model gives them, ``causal`` or no mask.  Held
    under the flash row's gates (both kernels against the plain version
    elementwise and row by row, the tensor cores within twice the CUDA
    cores' error from fp32), with two planted faults (one key tile
    skipped) that the row gate must reject.  Times the kernel (CUDA-graph
    replay), the plain version and SDPA (``enable_gqa`` where G > 1);
    the bound counts 2 B an element of q, k, v and o against 3.35 TB/s and
    2·(d + d) operations a visible pair against 989 TFLOP/s."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            route)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def bshd(n, S):
        return torch.randn(B, S, n, d, device=dev, generator=gen).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v = bshd(H, Sq), bshd(K, Sk), bshd(K, Sk)
    main, got, want = flash_bf16_check(label, q, k, v, causal=causal)
    require(got.transpose(1, 2).is_contiguous(),
            f"{label}: the output is not laid out like q")
    planted = planted_faults(label, q, k, v, got, want, causal=causal)
    del got, want
    torch.cuda.empty_cache()
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, o; k, v
    ops = 2 * 2 * d * B * H * visible_pairs(Sq, Sk, causal)
    b, by = bound(nbytes, ops, PEAK_BF16_PER_S)
    ms = graph_ms(lambda i: flash_attention(q, k, v, causal=causal), 10,
                  replays=3)
    plain = cuda_ms(lambda: attention_ref(q, k, v, causal=causal), 3,
                    warmup=1)
    torch.cuda.empty_cache()
    gqa = H != K
    lib = graph_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=gqa), 10, replays=3)
    return dict(shape=[B, H, K, Sq, Sk, d], dtype="bf16", causal=causal,
                kernel=route(q, k, v), max_abs_err=main["tc"]["max_abs_err"],
                main=main, atol=cases.ATOL, rtol=cases.RTOL,
                row_rel_limit=cases.ROW_REL_LIMIT, planted_faults=planted,
                ms=ms, tflops=ops / ms / 1e9, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib,
                library=f"F.scaled_dot_product_attention(is_causal={causal}"
                        f"{', enable_gqa=True' if gqa else ''}), bf16",
                bytes=nbytes, ops=ops,
                device_kernels=device_kernels(
                    lambda: flash_attention(q, k, v, causal=causal), 5))


def flash_new_arch_rows(dev, gen) -> dict:
    """The flash kernel at the prefill shapes of llava-next-34b (G = 7:
    q [4, 56, 2048, 128], k, v [4, 8, 2048, 128], causal) and of
    seamless-m4t-large-v2 (head dim 64, G = 1): the encoder's
    [4, 16, 512, 64] with no mask, the decoder's [4, 16, 2048, 64] causal,
    and cross attention's 2048 queries on 512 keys with no mask (Sq > Sk);
    each held and timed by ``flash_use_row``.  seamless's decode step runs
    cross attention with one query on the same 512 keys: held to the plain
    version beside the cross use.  llava's is a row of the kernels line,
    seamless's three uses are one row (``uses``), each with its TFLOP/s,
    its instance of the (64, 64) kernel and that instance's ptxas
    registers and spills."""
    from repro_torch.kernels.flash_attention.kernel import (route,
                                                            tc_query_tile)

    B, S = PREFILL_BATCH, PREFILL_LEN
    rows = {"flash_attention_g7": flash_use_row(
        "llava-next-34b shape (G = 7)", dev, gen, B, G7_HEADS, G7_KV_HEADS,
        S, S, 128, True)}
    H, d, E = SEAMLESS_HEADS, SEAMLESS_D, SEAMLESS_FRAMES
    uses = {}
    for use, (Sq, Sk, causal) in {"encoder": (E, E, False),
                                  "decoder": (S, S, True),
                                  "cross": (S, E, False)}.items():
        uses[use] = flash_use_row(f"seamless {use} shape", dev, gen, B, H, H,
                                  Sq, Sk, d, causal)
        # The (64, 64) kernel's instance: a consumer warpgroup a 64 rows of
        # the work tile.
        wgs = tc_query_tile(d, Sq) // 64
        uses[use].update(
            query_tile=tc_query_tile(d, Sq),
            instance=f"flash_sm90_d64_kernel<{wgs}>",
            ptxas=next((r for n, r in D64_PTXAS.items()
                        if f"d64_kernelILi{wgs}E" in n), None))
        print(f"[kernel] seamless {use}: {uses[use]['ms']:.5f} ms, "
              f"{uses[use]['tflops']:.1f} TFLOP/s, "
              f"{uses[use]['instance']}, ptxas {uses[use]['ptxas']}",
              flush=True)
    q1, k, v = (torch.randn(B, n, H, d, device=dev, generator=gen).to(
        torch.bfloat16).transpose(1, 2) for n in (1, E, E))
    require(route(q1, k, v) == "tensor_core",
            "seamless's decode-step cross attention is not on the tensor "
            "cores")
    uses["cross"]["decode_step"] = dict(
        shape=[B, H, H, 1, E, d], **flash_bf16_check(
            "seamless cross decode step", q1, k, v, causal=False)[0])
    # One row of the kernels line: the prefill launches each use once a
    # layer (24 of each), so a launch's times and bound are the uses'
    # means; it is bound by what bounds the use with the largest bound.
    mean = {key: sum(u[key] for u in uses.values()) / len(uses)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    rows["flash_attention_seamless"] = dict(
        **mean, max_abs_err=max(u["max_abs_err"] for u in uses.values()),
        bound_by=max(uses.values(), key=lambda u: u["bound_ms"])["bound_by"],
        uses=uses)
    return rows


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


def prefill_inputs(dev, cfg, tokens: np.ndarray, positions: int,
                   seed: int = 0) -> dict:
    """A prefill batch over ``positions`` positions from ``tokens``, in the
    shapes of ``prefill_input_shapes``: a vision config's first
    ``frontend_tokens`` positions are patch embeddings (the tokens fill
    the rest), an enc-dec config's encoder takes ``positions // 4`` frame
    embeddings; both drawn on the card from ``seed`` in ``cfg.dtype``."""
    from repro_torch.configs.base import prefill_input_shapes

    gen = torch.Generator(dev).manual_seed(seed)
    shapes = prefill_input_shapes(cfg, tokens.shape[0], positions)
    batch = {"tokens": tokens[:, :shapes.pop("tokens")[1]]}
    batch.update({k: torch.randn(shape, device=dev, generator=gen).to(
        cfg.dtype) for k, shape in shapes.items()})
    return batch


def enc_out_decode(params, cfg, prompts: np.ndarray, enc_out, new: int):
    """Greedy decode through ``build_serve_step`` with ``enc_out`` (the
    engine, like JAX's, passes none): the prompts teacher-forced, then
    ``new`` tokens.  Returns the logits after the prompt, the tokens, the
    seconds of the prompt and of the whole loop."""
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import init_cache

    step = build_serve_step(cfg)
    cache = init_cache(cfg, prompts.shape[0], prompts.shape[1] + new)
    toks = torch.as_tensor(prompts, device=enc_out.device)
    t0 = time.perf_counter()
    for t in range(prompts.shape[1]):
        cache, logits = step(params, cache, toks[:, t:t + 1], t, enc_out)
    prompt_logits = logits
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    out = []
    for i in range(new):
        tok = logits.argmax(-1)
        out.append(tok)
        cache, logits = step(params, cache, tok[:, None],
                             prompts.shape[1] + i, enc_out)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    tokens = torch.stack(out, 1).cpu().numpy() if out else None
    return prompt_logits, tokens, prompt_s, loop_s


def serve_row(dev, cfg, route: str) -> dict:
    """One LM at ``cfg`` (bf16, weights drawn on the card from seed 0): the
    prefill step over PREFILL_BATCH sequences of PREFILL_LEN positions
    (``prefill_inputs``: llava's first 576 are patches, seamless's encoder
    takes 512 frames), once to warm up and once timed, each launching
    flash_attention ``prefill_flash_launches`` times on ``route`` (a
    recurrent layer launches none; an enc-dec config launches one more a
    decoder layer, for cross attention, and one an encoder layer); then a
    ServingEngine answering PREFILL_BATCH requests of SERVE_PROMPT +
    SERVE_NEW tokens, and the bf16 prefill step against the engine's
    sequential prefill (printed, not gated; llava's prefill takes the
    first half of each prompt as patch embeddings of its tokens).  Each
    engine call that a gate compares gets a fresh engine: like JAX's, the
    engine keeps its cache from one request to the next, and a recurrent
    state carries over.  Like JAX's, it passes no encoder output, so an
    enc-dec row also decodes through ``build_serve_step`` with the
    prefill's encoder output (``enc_out_decode``), whose cross attention
    launches the kernel once a decoder layer and step; its bf16 prefill
    comparison is against that loop."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_prefill_step, encode
    from repro_torch.models import (init_params, layers, param_count,
                                    prefill_flash_launches)
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
    batch = prefill_inputs(dev, cfg, long_prompts, PREFILL_LEN)
    input_shapes = {k: list(v.shape) for k, v in batch.items()}

    prefill = build_prefill_step(cfg)                 # on cuda
    runs = []
    for _ in range(2):                                # warm-up, timed
        reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, launch_counts()))
    prefill_s, launches = runs[1]
    n_attn = prefill_flash_launches(cfg)
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
    prefill_profile = device_breakdown(lambda: prefill(params, batch))

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
    # Device time and ATen ops of the engine's steps, over PROFILE_STEPS.
    short = prompts[:, :PROFILE_STEPS // 2]
    step_profile = device_breakdown(
        lambda: serving.generate(short, max_new=PROFILE_STEPS // 2), top=3)
    step_device_ms = step_profile["device_ms"] / PROFILE_STEPS
    step_ops = aten_ops(lambda: serving.generate(
        short, max_new=PROFILE_STEPS // 2)) / PROFILE_STEPS
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
    encdec = {}
    if cfg.arch == "encdec":
        enc_out = encode(params, cfg, batch["src"])
        reset_launch_counts()
        ref_logits, enc_toks, prompt_s, loop_s = enc_out_decode(
            params, cfg, prompts, enc_out, SERVE_NEW)
        loop_launches = launch_counts()
        steps = SERVE_PROMPT + SERVE_NEW
        n_cross = cfg.num_layers * steps
        require(loop_launches["flash_attention"] == n_cross
                and loop_launches["flash_attention_tc"] == n_cross,
                f"{cfg.name} decode with enc_out launched flash_attention "
                f"{loop_launches}, not {n_cross} on the tensor cores (one "
                f"cross attention a decoder layer and step)")
        require(bool(torch.isfinite(ref_logits).all()) and bool(
            ((enc_toks >= 0) & (enc_toks < cfg.vocab)).all()),
            f"{cfg.name} decode with enc_out: logits or tokens")
        profile = device_breakdown(lambda: enc_out_decode(
            params, cfg, prompts[:, :4], enc_out, 0), top=3)
        encdec = {"enc_out_shape": list(enc_out.shape),
                  "enc_out_decode_s": loop_s,
                  "enc_out_decode_tok_per_s":
                      PREFILL_BATCH * SERVE_NEW / (loop_s - prompt_s),
                  "enc_out_step_wall_ms": loop_s * 1e3 / steps,
                  "enc_out_step_device_ms": profile["device_ms"] / 4,
                  "enc_out_step_top_kernels": profile["top"],
                  "enc_out_decode_launches": loop_launches,
                  "enc_out_tokens_head": enc_toks[:, :8].tolist()}
        kern_logits = prefill(params, {"tokens": prompts,
                                       "src": batch["src"]})
        del enc_out
    else:
        ref_logits = seq_logits
        kern_batch = {"tokens": prompts}
        if cfg.frontend == "vision":
            half = SERVE_PROMPT // 2
            kern_batch = {"tokens": prompts[:, half:],
                          "frontend": layers.embed_lookup(
                              params["embed_vd"],
                              torch.as_tensor(prompts[:, :half], device=dev),
                              cfg.scale_embed)}
        kern_logits = prefill(params, kern_batch)
    bf16_rel = float((kern_logits - ref_logits).abs().max()
                     / ref_logits.abs().max())
    bf16_argmax = int((kern_logits.argmax(-1)
                       == ref_logits.argmax(-1)).sum())
    del params, serving, logits, kern_logits, seq_logits, ref_logits, batch
    torch.cuda.empty_cache()

    new_tokens = PREFILL_BATCH * SERVE_NEW
    tc = launches["flash_attention_tc"]
    return {"app": cfg.name, "params": n_params, "param_bytes": param_bytes,
            "layers": cfg.num_layers, "init_s": init_s,
            "prefill_shape": [PREFILL_BATCH, PREFILL_LEN],
            "prefill_inputs": input_shapes,
            "prefill_s": prefill_s, "prefill_warmup_s": runs[0][0],
            "prefill_tok_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
            "prefill_device_ms": prefill_profile["device_ms"],
            "prefill_top_kernels": prefill_profile["top"],
            "launches": launches,
            "prefill_flash_launches": n_attn,
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
            "bf16_full_depth_argmax_equal": bf16_argmax, **encdec}


def fp32_parity(dev, cfg, prompt_len: int = SERVE_PROMPT) -> dict:
    """The prefill step (the flash kernel) against sequential decode in
    fp32 on the SERVE_PROMPT-token prompts, or on the first ``prompt_len``
    tokens of the prefill step's: within 1e-4 of the logits' largest
    magnitude, one CUDA-core launch an attention layer (and an encoder
    layer, and a cross block).  Decode is the engine's prefill, but for
    two configs: a vision config decodes ``frontend_tokens`` more prompt
    tokens first, whose embeddings are the prefill's patches (so the
    concatenation and its positions are held exactly); an enc-dec config's
    prefill takes 512 frames from the card's generator and decode runs
    ``build_serve_step`` with the encoder's output over them (the engine,
    like JAX's, passes none)."""
    from repro_torch.configs.base import _frontend_len
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_prefill_step, encode
    from repro_torch.models import init_params, layers
    from repro_torch.serving import ServeConfig, ServingEngine

    long_prompts, prompts = lm_prompts(cfg.vocab)
    P = _frontend_len(cfg)
    if prompt_len != SERVE_PROMPT or P:
        prompts = long_prompts[:, :P + prompt_len]
    params32 = init_params(torch.Generator(dev).manual_seed(1), cfg)
    batch = {"tokens": prompts}
    if P:
        batch = {"tokens": prompts[:, P:], "frontend": layers.embed_lookup(
            params32["embed_vd"], torch.as_tensor(prompts[:, :P], device=dev),
            cfg.scale_embed)}
    if cfg.arch == "encdec":
        batch["src"] = prefill_inputs(dev, cfg, long_prompts, PREFILL_LEN,
                                      seed=2)["src"]
    reset_launch_counts()
    kern = build_prefill_step(cfg)(params32, batch)
    counts = launch_counts()
    if cfg.arch == "encdec":
        dec = enc_out_decode(params32, cfg, prompts, encode(
            params32, cfg, batch["src"]), 0)[0]
    else:
        dec, _ = ServingEngine(params32, cfg, ServeConfig(
            batch_slots=PREFILL_BATCH,
            max_len=max(SERVE_MAX_LEN, prompts.shape[1]))).prefill(prompts)
    rel = float((kern - dec).abs().max() / dec.abs().max())
    del params32, batch
    torch.cuda.empty_cache()
    return {"superblocks": cfg.num_superblocks, "layers": cfg.num_layers,
            "enc_layers": cfg.enc_superblocks * len(cfg.enc_pattern),
            "prompt_len": prompts.shape[1], "prefill_tokens": prompt_len,
            "rel_err": rel, "flash_launches": counts["flash_attention"],
            "tc_launches": counts["flash_attention_tc"]}


def check_fp32_parity(name: str, parity: dict, layers: int) -> None:
    """``layers``: the prefill's flash launches (``prefill_flash_launches``),
    each on the CUDA cores."""
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
    from repro_torch.models import prefill_flash_launches

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
    check_fp32_parity(LM_ARCH, parity, prefill_flash_launches(cfg32))
    return row


def cut_depth(cfg, superblocks):
    """``cfg`` at full width with ``superblocks`` super-blocks (an enc-dec
    encoder cut to as many), or as it is for None."""
    if superblocks is None:
        return cfg
    return dataclasses.replace(
        cfg, num_superblocks=superblocks,
        enc_superblocks=min(cfg.enc_superblocks, superblocks))


def lm_rows_phase(dev) -> dict:
    """chatglm3-6b, the DeepSeek archs, the recurrent archs, mistral-nemo,
    gemma2, seamless and llava (``LM_ROWS``), then MLA + MoE parity on
    deepseek-v2 and the other archs' parity at cut depth (``FP32_PARITY``)
    in fp32.  Returns each row by arch."""
    from repro_torch.configs import get_arch
    from repro_torch.models import prefill_flash_launches

    rows = {}
    for arch, superblocks, route, kernel_row, note in LM_ROWS:
        cfg = cut_depth(get_arch(arch).full(), superblocks)
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
                      prefill_flash_launches(cfg))
    for arch, superblocks, prompt_len in FP32_PARITY:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            cut_depth(get_arch(arch).full(), superblocks),
            dtype=torch.float32, param_dtype=torch.float32)
        parity = fp32_parity(dev, cfg, prompt_len)
        row = {"app": "fp32_parity", "arch": arch, **parity,
               "row_s": time.perf_counter() - t0}
        print(f"[path] {json.dumps(row)}", flush=True)
        check_fp32_parity(f"{arch} ({prompt_len} tokens)", parity,
                          prefill_flash_launches(cfg))
    return rows


# -- phase 5b: training -----------------------------------------------------

def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (no recompute): 6 × the weights
    that a token's products use × its tokens, plus the attention's score
    and value products, forward and backward (three times the forward's
    2·(d + dv) a visible pair and head).

    The decoder's weights act on its ``batch × seq`` positions (patches
    included), the unembedding table once (twice with the MTP head's
    second cross-entropy); an untied input table is a lookup and counts
    nothing.  A MoE layer's routed experts count ``top_k / num_experts``
    of theirs (the useful work: the capacity buffer's empty slots are not
    counted).  An enc-dec encoder's weights, and a cross block's K and V
    projections, act on the ``seq // 4`` frames of each row.  Pairs:
    causal (and within a window) in the decoder's GQA and MLA layers and
    the MTP block, at MLA's own head count and dims; every pair in the
    encoder and in cross attention (``seq`` queries on the frames)."""
    from repro_torch.models import param_count
    from repro_torch.models.transformer import (
        ATTENTION_MIXERS, _layer_count, enc_layer_specs, layer_specs)

    D, hd = cfg.d_model, cfg.head_dim
    frames = seq // 4 if cfg.arch == "encdec" else 0
    enc = enc_layer_specs(cfg)
    dec = layer_specs(cfg)
    enc_params = (sum(_layer_count(cfg, s) for s in enc) + D) if enc else 0
    cross_kv = 2 * D * cfg.num_kv_heads * hd if frames else 0
    idle = 0
    if cfg.moe is not None:
        m = cfg.moe
        routed = 3 * m.num_experts * D * m.d_ff_expert
        idle = (sum(s.ffn == "moe" for s in dec)
                * routed * (1 - m.top_k / m.num_experts))
    table = cfg.vocab * D
    per_token = (param_count(cfg) - enc_params - cross_kv * len(dec) - idle
                 - (0 if cfg.tie_embeddings else table)
                 + (table if cfg.mtp else 0))
    per_frame = enc_params + cross_kv * len(dec)

    gqa = (cfg.num_heads, hd, hd)
    mla = cfg.mla and (cfg.mla.num_heads,
                       cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim,
                       cfg.mla.v_head_dim)

    def pairs(dims, Sq, Sk, causal=True, window=None):
        """Three times the forward's score and value FLOPs of one row."""
        heads, d, dv = dims
        n = (sum(min(i + 1, window) for i in range(Sq))
             if causal and window is not None
             else visible_pairs(Sq, Sk, causal))
        return 3 * 2 * (d + dv) * heads * n

    attn = sum(pairs(gqa if s.mixer == "gqa" else mla, seq, seq,
                     window=s.window)
               for s in dec if s.mixer in ATTENTION_MIXERS)
    attn += sum(pairs(gqa, frames, frames, causal=False)
                for s in enc if s.mixer == "gqa")
    if frames:
        attn += len(dec) * pairs(gqa, seq, frames, causal=False)
    if cfg.mtp:
        attn += pairs(gqa, seq, seq)
    return (6.0 * batch * (per_token * seq + per_frame * frames)
            + batch * attn)


#: Kernel classes of a training step's profile, by name: the first class
#: whose every word a kernel's name holds.  fp32 products run as SIMT
#: SGEMM (``sgemm``) or FFMA xmma (``f32f32_f32f32``) kernels; cuBLAS's
#: bf16 products on Hopper as ``nvjet`` kernels.
KERNEL_CLASSES = (("flash_forward", ("flash_sm90",)),
                  ("fp32_gemm", ("sgemm",)),
                  ("fp32_gemm", ("f32f32_f32f32",)),
                  ("bf16_gemm", ("nvjet",)),
                  ("bf16_gemm", ("gemm", "bf16")))


def train_step_profile(fn) -> dict:
    """``device_breakdown`` of one call of ``fn`` with its kernels summed
    by ``KERNEL_CLASSES`` (the rest as ``other``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(([e.key, e.count, e.device_time_total / 1e3]
                   for e in prof.key_averages()
                   if e.count and e.device_time_total > 0),
                  key=lambda r: -r[2])
    ms, launches = {}, {}
    for name, count, t in rows:
        cls = next((c for c, words in KERNEL_CLASSES
                    if all(w in name for w in words)), "other")
        ms[cls] = ms.get(cls, 0.0) + t
        launches[cls] = launches.get(cls, 0) + count
    return {"device_ms": sum(r[2] for r in rows), "by_class": ms,
            "launches_by_class": launches,
            "top": [[r[0][:90], r[1], r[2]] for r in rows[:12]]}


def train_full_width(dev, arch: str, optimizer: str, timed: int,
                     superblocks) -> dict:
    """(a) One TRAIN_ROWS row: ``arch``'s ``full()`` in bf16, at
    ``superblocks`` super-blocks (None: full depth), taking
    ``optimizer`` steps (JAX's defaults) at TRAIN_BATCH × TRAIN_SEQ tokens
    from the port's pipeline (seed 0): TRAIN_WARMUP + ``timed`` steps,
    each on a fresh batch, then one more under the profiler, and one
    optimizer update alone.  Prints the
    step's analytic FLOPs and HBM bytes (``launch.analytic``) beside the
    model FLOPs of the MFU.  Gates: every loss finite, each step's flash
    launches ``train_flash_launches(cfg)``, all on the tensor cores, and
    the peak device bytes within TRAIN_PEAK_LIMIT."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import analytic
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.launch.train import data_config
    from repro_torch.models import param_count, train_flash_launches
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import (AdafactorConfig, AdamWConfig,
                                   adafactor_update, adamw_update)

    row_t0 = time.perf_counter()
    cfg = cut_depth(get_arch(arch).full(), superblocks)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(cfg, optimizer, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = build_train_step(cfg, optimizer, device=dev)
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    want = train_flash_launches(cfg)
    pipe = make_pipeline(data_config(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    steps = []
    try:
        for i in range(TRAIN_WARMUP + timed):
            batch = next(pipe)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            steps.append({"step": i + 1, "warmup": i < TRAIN_WARMUP,
                          "loss": loss, "wall_s": wall,
                          "tokens_per_s": tokens / wall,
                          "mfu": flops / wall / PEAK_BF16_PER_S,
                          "flash_tensor_core": counts["flash_attention_tc"],
                          "flash_cuda_core": counts["flash_attention"]
                          - counts["flash_attention_tc"]})
            print(f"[train] {arch} step {i + 1}: {json.dumps(steps[-1])}",
                  flush=True)
            require(math.isfinite(loss),
                    f"[train] {arch} step {i + 1}: loss {loss}")
            require(counts["flash_attention"] == want
                    and counts["flash_attention_tc"] == want,
                    f"[train] {arch} step {i + 1}: flash launches {counts}, "
                    f"not {want} on the tensor cores")
        batch = next(pipe)
        profile = train_step_profile(lambda: step(state, batch))
    finally:
        pipe.close()
    step_peak = torch.cuda.max_memory_allocated()
    # One optimizer update alone, over the whole state, with zero
    # gradients (the step's update is interleaved with nothing, so this
    # is its time).
    grads = tree_map(torch.zeros_like, state["params"])
    if optimizer == "adamw":
        update = functools.partial(adamw_update, state["params"], grads,
                                   state["opt"], AdamWConfig())
    else:
        update = functools.partial(adafactor_update, state["params"], grads,
                                   state["opt"], AdafactorConfig())
    update_ms = cuda_ms(update, reps=2, warmup=1)
    del grads, update
    peak = torch.cuda.max_memory_allocated()
    timed_steps = [s for s in steps if not s["warmup"]]
    wall = sum(s["wall_s"] for s in timed_steps) / len(timed_steps)
    row = {"check": "full_width", "arch": cfg.name,
           "layers": cfg.num_layers, "superblocks": cfg.num_superblocks,
           "enc_layers": cfg.enc_superblocks * len(cfg.enc_pattern),
           "params": param_count(cfg), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "optimizer": optimizer, "dtype": "bfloat16",
           "init_s": init_s, "steps": steps, "mean_wall_s": wall,
           "tokens_per_s": tokens / wall,
           "model_flops": flops, "mfu": flops / wall / PEAK_BF16_PER_S,
           "analytic_train_flops": analytic.train_flops(cfg, TRAIN_BATCH,
                                                        TRAIN_SEQ),
           "analytic_train_hbm_bytes": analytic.train_hbm_bytes(
               cfg, TRAIN_BATCH, TRAIN_SEQ),
           "profiled_step_device_ms": profile["device_ms"],
           "device_busy_share": profile["device_ms"] / (wall * 1e3),
           "device_ms_by_class": profile["by_class"],
           "launches_by_class": profile["launches_by_class"],
           "top_kernels": profile["top"], "update_ms": update_ms,
           "step_peak_bytes": step_peak, "peak_bytes": peak,
           "held_before_bytes": held, "flash_launches_per_step": want,
           "row_s": time.perf_counter() - row_t0, "card": card_line()}
    print(f"[train] {json.dumps(row)}", flush=True)
    require(peak <= TRAIN_PEAK_LIMIT,
            f"[train] {arch}: peak {peak} device bytes over "
            f"{TRAIN_PEAK_LIMIT}")
    del state, step
    return row


def loss_and_grads(params, cfg, batch) -> tuple:
    """``train_loss`` and the gradient of every param leaf (zeros where
    the loss does not reach a leaf)."""
    from repro_torch.models import train_loss
    from repro_torch.models.layers import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = train_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]


def train_grad_parity(dev) -> list:
    """(b) fp32 at cut depth and full width (GRAD_PARITY): ``train_loss``
    and every leaf's gradient with the flash kernel forward and the
    backward of ``backward.py``, RG-LRU's scan Function, sLSTM's prefill
    form (its stabilizer's Function and the scan) and the recompute
    (super-blocks, xlstm's layers, cross-entropy chunks) against the same
    loss with the plain versions under autograd: ``attention_ref``,
    ``rglru_scan_ref`` and sLSTM's step loop, with nothing recomputed, on
    one batch of GRAD_SEQ tokens.  The plain side's ``attention_ref``
    takes ``flash_attention_op``'s name in ``attention``, through which
    ``attention_core`` reaches it for every use: GQA, MLA, the encoder and
    cross attention.  Gates: the loss within 1e-5 relative, each leaf
    within 1e-4 of that leaf's gradient norm."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.steps import batch_to_device
    from repro_torch.launch.train import data_config
    from repro_torch.models import (attention, init_params, recurrent,
                                    train_flash_launches, transformer)
    from repro_torch.models.layers import tree_paths

    def no_recompute(fn, *args, use_reentrant):
        return fn(*args)

    slstm_forward = recurrent.slstm_forward

    def slstm_loop(params, cfg, x, state=None):
        """sLSTM's step loop (its decode form) from a fresh state."""
        fresh = recurrent.init_slstm_state(cfg, x.shape[0], device=x.device)
        return slstm_forward(params, cfg, x, fresh)[0], None

    rows = []
    for arch, superblocks in GRAD_PARITY:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            cut_depth(get_arch(arch).full(), superblocks),
            dtype=torch.float32, param_dtype=torch.float32)
        params = init_params(torch.Generator(dev).manual_seed(0), cfg)
        pipe = make_pipeline(data_config(cfg, 1, GRAD_SEQ, seed=0))
        batch = batch_to_device(cfg, next(pipe), dev)
        pipe.close()
        reset_launch_counts()
        loss, got = loss_and_grads(params, cfg, batch)
        counts = launch_counts()
        with ExitStack() as plain:
            for module, name, fn in (
                    (attention, "flash_attention_op", attention_ref),
                    (recurrent, "rglru_scan", recurrent.rglru_scan_ref),
                    (recurrent, "slstm_forward", slstm_loop),
                    (transformer, "checkpoint", no_recompute)):
                plain.enter_context(mock.patch.object(module, name, fn))
            want_loss, want = loss_and_grads(params, cfg, batch)
        errs = []
        for (path, _), g, w in zip(tree_paths(params), got, want):
            n = float(w.norm())
            e = float((g - w).norm())
            errs.append((e / n if n > 0 else e, path))
        worst = max(errs)
        row = {"check": "grad_parity", "arch": arch,
               "superblocks": superblocks, "layers": cfg.num_layers,
               "enc_layers": cfg.enc_superblocks * len(cfg.enc_pattern),
               "dtype": "float32",
               "tokens": GRAD_SEQ, "loss": loss, "ref_loss": want_loss,
               "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
               "leaves": len(errs), "worst_leaf": worst[1],
               "worst_leaf_rel_err": worst[0],
               "flash_launches": counts["flash_attention"],
               "row_s": time.perf_counter() - t0}
        print(f"[train] {json.dumps(row)}", flush=True)
        require(math.isfinite(loss) and row["loss_rel_err"] <= 1e-5,
                f"[train] {arch}: loss {loss} against {want_loss}")
        require(worst[0] <= 1e-4,
                f"[train] {arch}: gradient leaf {worst[1]} off by "
                f"{worst[0]:.3e} of its norm")
        require(counts["flash_attention"] == train_flash_launches(cfg),
                f"[train] {arch}: {counts['flash_attention']} flash "
                f"launches, not {train_flash_launches(cfg)}")
        rows.append(row)
        del params, got, want
    return rows


def train_flash_grads(dev) -> list:
    """(c) The flash op alone at each tensor-core shape of the serve
    rows (FLASH_GRAD_CASES, batch 1): dq, dk, dv from the bf16 kernel
    forward and ``backward.py`` within ``cases.GRAD_GATE`` times the
    error of autograd of ``attention_ref`` run on the same bf16 operands,
    both from fp32 autograd of ``attention_ref``.  Also times the
    backward at the [train] step's shape (q [4, 32, 2048, 128])."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import cases
    from repro_torch.kernels.flash_attention.backward import (
        flash_attention_backward)
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    rows = []
    for label, (B, H, K, Sq, Sk, d, dv), kw in FLASH_GRAD_CASES:
        q, k, v = randn(B, H, Sq, d), randn(B, K, Sk, d), randn(B, K, Sk, dv)
        do = randn(B, H, Sq, dv)
        reset_launch_counts()
        errs = cases.grad_errors(q, k, v, do, **kw)
        tc = launch_counts()["flash_attention_tc"]
        row = {"check": "flash_grad", "row": label,
               "q": [B, H, Sq, d], "kv": [B, K, Sk, dv], **kw,
               **{f"{n}_err": e[0] for n, e in errs.items()},
               **{f"{n}_plain_err": e[1] for n, e in errs.items()},
               "tensor_core_launches": tc}
        print(f"[train] {json.dumps(row)}", flush=True)
        require(tc == 1, f"[train] flash grad {label}: {tc} tensor-core "
                f"launches")
        for name, (op, plain) in errs.items():
            require(op <= cases.GRAD_GATE * plain,
                    f"[train] flash grad {label} {name}: {op:.3e} over "
                    f"{cases.GRAD_GATE} x {plain:.3e}")
        rows.append(row)
        del q, k, v, do
    B, H, K, S, d = TRAIN_BATCH, 32, 8, TRAIN_SEQ, 128
    q, k, v, do = (randn(B, H, S, d), randn(B, K, S, d), randn(B, K, S, d),
                   randn(B, H, S, d))
    fwd = cuda_ms(lambda: flash_attention(q, k, v), reps=10)
    bwd = cuda_ms(lambda: flash_attention_backward(q, k, v, do), reps=3,
                  warmup=1)
    # Five products a visible pair and head (S recomputed, dV, dP, dQ, dK),
    # 2·d operations each, in fp32 on the CUDA cores.
    ops = 5 * 2 * d * B * H * visible_pairs(S, S)
    row = {"check": "flash_backward_time", "q": [B, H, S, d],
           "kv": [B, K, S, d], "forward_ms": fwd, "backward_ms": bwd,
           "backward_ops": ops,
           "backward_fp32_bound_ms": ops / PEAK_FP32_PER_S * 1e3,
           "per_step_ms": TRAIN_LAYERS * (2 * fwd + bwd)}
    print(f"[train] {json.dumps(row)}", flush=True)
    rows.append(row)
    return rows


def adamw_step(cfg, ocfg, dev):
    """A train step with AdamW at ``ocfg`` (``build_train_step`` takes
    JAX's defaults): ``train_loss``'s gradient, then ``adamw_update``."""
    from repro_torch.launch.steps import batch_to_device
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw_update

    def step(state, batch):
        loss, grads = loss_and_grads(state["params"], cfg,
                                     batch_to_device(cfg, batch, dev))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), state["params"])
        params, opt = adamw_update(state["params"], grads, state["opt"],
                                   ocfg)
        return ({"params": params,
                 "opt": {k: opt[k] for k in ("mu", "nu", "count")},
                 "step": state["step"] + 1},
                {"loss": torch.tensor(loss)})
    return step


def train_restart(dev) -> list:
    """(d) The Trainer on the card: qwen3-4b ``smoke()`` in fp32 with
    AdamW(lr 1e-3), 6 steps saving every 2, killed by ``FailureInjector``
    after step 3 and resumed under ``run_with_restarts`` (the stream at
    the restored step's batch), against an uninterrupted run: within 1e-6
    (``tests/test_system.py::test_checkpoint_restart_bitexact``), and
    bit-equal.  Then that test's ``test_training_reduces_loss`` setup: 30
    steps at lr 3e-3 on one fixed batch halve the loss."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import init_train_state
    from repro_torch.launch.train import data_config, train_with_restarts
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureInjector, TrainerConfig

    cfg = get_arch(TRAIN_ARCH).smoke()
    step_fn = adamw_step(cfg, AdamWConfig(lr=1e-3), dev)
    dcfg = data_config(cfg, 2, 32)
    t0 = time.perf_counter()

    def train(ckpt, fail_at):
        return train_with_restarts(
            step_fn, lambda: init_train_state(cfg, device=dev), dcfg,
            TrainerConfig(total_steps=6, ckpt_dir=ckpt, save_interval=2),
            FailureInjector(fail_at))

    with tempfile.TemporaryDirectory() as d:
        straight, straight_state = train(os.path.join(d, "a"), None)
        resumed, resumed_state = train(os.path.join(d, "b"), [3])
    a = tree_leaves(straight_state["params"])
    b = tree_leaves(resumed_state["params"])
    diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
    bits = all(torch.equal(x, y) for x, y in zip(a, b))
    row = {"check": "restart", "arch": cfg.name, "dtype": "float32",
           "steps": 6, "save_interval": 2, "killed_after": 3,
           "attempts": len(resumed),
           "resumed_from": resumed[-1].metrics_history[0]["step"] - 1,
           "max_abs_diff": diff, "bit_equal": bits,
           "final_loss": resumed[-1].metrics_history[-1]["loss"],
           "uninterrupted_final_loss":
               straight[-1].metrics_history[-1]["loss"],
           "row_s": time.perf_counter() - t0}
    print(f"[train] {json.dumps(row)}", flush=True)
    require(len(straight) == 1 and len(resumed) == 2
            and int(resumed_state["step"]) == 6, "[train] restart: attempts")
    require(diff <= 1e-6, f"[train] restart: params differ by {diff}")
    require(bits, "[train] restart: the resumed params differ in bits")

    t0 = time.perf_counter()
    state = init_train_state(cfg, device=dev)
    step_fn = adamw_step(cfg, AdamWConfig(lr=3e-3), dev)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             "weights": np.ones(toks.shape, np.float32)}
    losses = []
    for _ in range(30):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    row2 = {"check": "reduces_loss", "arch": cfg.name, "steps": 30,
            "first_loss": losses[0], "last_loss": losses[-1],
            "row_s": time.perf_counter() - t0}
    print(f"[train] {json.dumps(row2)}", flush=True)
    require(losses[-1] < 0.5 * losses[0],
            f"[train] 30 steps took the loss from {losses[0]} to "
            f"{losses[-1]}")
    return [row, row2]


def train_phase(dev) -> list:
    """Training on the card: (a) full width (TRAIN_ROWS, each row's state
    freed before the next), (b) gradient parity at cut depth, (c) the
    flash op's gradient alone, (d) restart and convergence.  Prints
    ``[train]`` rows; returns (a)'s."""
    t0 = time.perf_counter()
    full = []
    for row in TRAIN_ROWS:
        gc.collect()
        torch.cuda.empty_cache()
        full.append(train_full_width(dev, *row))
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_flash_grads(dev)
    train_restart(dev)
    print(f"[train] phase {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return full


# -- phase 5c: the mesh -------------------------------------------------------

MESH_STEPS = 2
MESH_DECODE_STEPS = 8
#: The dry run's cells (arch, shape, mesh) and each one's time limit.
#: deepseek-v3-671b's train_4k cell on the multi-pod mesh did not finish
#: in 1000 s on the card's host; its decode_32k cell takes about 25 s,
#: qwen3-4b's train_4k about 370 s.
DRYRUN_CELLS = (("qwen3-4b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"))
DRYRUN_TIMEOUT = 600


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bit patterns (-0.0 is not 0.0, NaN is its
    own bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[a.element_size()]
    return torch.equal(a.reshape(-1).view(width), b.reshape(-1).view(width))


def one_rank_mesh(dev):
    """A (1, 1) ('data', 'model') mesh over a one-rank NCCL group (NCCL
    cannot place two ranks on one card; the multi-rank checks run in the
    CPU tests)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    # DTensor warns of every reduction over the two mesh dims in turn.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    return make_mesh((1, 1), ("data", "model"))


def mesh_train_row(dev, mesh, train_wall_s: float) -> dict:
    """(a) qwen3-4b ``full()`` with AdamW at TRAIN_BATCH x TRAIN_SEQ:
    MESH_STEPS no-mesh steps from the seeded state, its leaves kept on the
    host, then the same steps through ``mesh=`` from the same state and
    batches.  Gates: each loss and every param and moment leaf the same
    bits, each step's flash launches ``train_flash_launches(cfg)``, all
    on the tensor cores, and the mesh run's peak within
    TRAIN_PEAK_LIMIT."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import (build_train_step,
                                          init_train_state, shard_state)
    from repro_torch.launch.train import data_config
    from repro_torch.models import train_flash_launches
    from repro_torch.models.layers import tree_paths

    cfg = get_arch(TRAIN_ARCH).full()
    want = train_flash_launches(cfg)
    pipe = make_pipeline(data_config(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    try:
        batches = [next(pipe) for _ in range(MESH_STEPS)]
    finally:
        pipe.close()

    def run(on_mesh):
        state = init_train_state(cfg, "adamw", device=dev)
        if on_mesh is not None:
            state = shard_state(state, cfg, on_mesh, "adamw")
        step = build_train_step(cfg, "adamw", device=dev, mesh=on_mesh)
        out = []
        for i, batch in enumerate(batches):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            out.append({"step": i + 1, "loss": metrics["loss"].detach()
                        .cpu(), "wall_s": wall,
                        "flash_tensor_core": counts["flash_attention_tc"],
                        "flash_cuda_core": counts["flash_attention"]
                        - counts["flash_attention_tc"]})
        return state, out

    def leaves(state):
        return tree_paths({"params": state["params"],
                           "mu": state["opt"]["mu"],
                           "nu": state["opt"]["nu"]})

    gc.collect()
    torch.cuda.empty_cache()
    state, ref_steps = run(None)
    ref = {path: t.detach().cpu() for path, t in leaves(state)}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, steps = run(mesh)
    peak = torch.cuda.max_memory_allocated()
    differ = []
    for path, t in leaves(state):
        local = t.detach().to_local() if hasattr(t, "to_local") else t
        if not same_bits(local, ref.pop(path).to(dev)):
            differ.append(path)
    require(not ref, f"[mesh] leaves missing from the mesh state: "
            f"{list(ref)[:3]}")
    del state
    losses_same = all(same_bits(a["loss"], b["loss"])
                      for a, b in zip(steps, ref_steps))
    for s in steps + ref_steps:
        s["loss"] = float(s["loss"])
    row = {"check": "mesh_train", "arch": cfg.name, "mesh": [1, 1],
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "optimizer": "adamw",
           "steps": steps, "no_mesh_steps": ref_steps,
           "train_phase_mean_wall_s": train_wall_s,
           "losses_same_bits": losses_same,
           "leaves_differing": len(differ), "differing": differ[:8],
           "peak_bytes": peak, "flash_launches_per_step": want,
           "card": card_line()}
    print(f"[mesh] {json.dumps(row)}", flush=True)
    require(losses_same and not differ,
            f"[mesh] the mesh steps differ from the no-mesh steps: losses "
            f"same {losses_same}, {len(differ)} leaves {differ[:4]}")
    for s in steps:
        require(s["flash_tensor_core"] == want and s["flash_cuda_core"] == 0,
                f"[mesh] step {s['step']}: flash launches {s}, not {want} "
                f"on the tensor cores")
    require(peak <= TRAIN_PEAK_LIMIT,
            f"[mesh] peak {peak} device bytes over {TRAIN_PEAK_LIMIT}")
    return row


def mesh_psum_row(dev, mesh) -> dict:
    """(b) ``compressed_psum`` over the mesh's one-rank NCCL group of a
    full-width gradient-shaped leaf (qwen3-4b's ``wo_fd`` [9728, 2560],
    fp32 from seed 0 at a gradient's scale) against the same call on the
    CPU over a one-rank gloo group: the same bits."""
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((9728, 2560), generator=gen, device=dev) * 1e-3
    t0 = time.perf_counter()
    got = compressed_psum(x, group=mesh.get_group("data"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    gloo = dist.new_group(ranks=[0], backend="gloo")
    want = compressed_psum(x.cpu(), group=gloo)
    same = same_bits(got.cpu(), want)
    row = {"check": "compressed_psum", "shape": list(x.shape),
           "same_bits_as_gloo_cpu": same, "card_s": card_s,
           "max_abs": float((got.cpu() - want).abs().max())}
    print(f"[mesh] {json.dumps(row)}", flush=True)
    require(same, f"[mesh] compressed_psum on the card differs from the "
            f"CPU's: {row}")
    return row


def mesh_serve_row(dev, mesh) -> dict:
    """(c) qwen3-4b ``full()`` (bf16, seed 0): the prefill step over the
    PREFILL_BATCH x PREFILL_LEN prompts and MESH_DECODE_STEPS decode steps
    through ``mesh=`` (params in the train layout for the prefill, the
    serving layout for decode; the cache placed by ``cache_shardings``)
    against the no-mesh steps: the logits the same bits."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, shard_cache,
                                          shard_params)
    from repro_torch.models import init_cache, init_params

    cfg = get_arch(LM_ARCH).full()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts, _ = lm_prompts(cfg.vocab)
    tokens = torch.as_tensor(prompts, device=dev)
    rng = np.random.default_rng(1)
    new = torch.as_tensor(rng.integers(1, cfg.vocab, (
        PREFILL_BATCH, MESH_DECODE_STEPS)), device=dev)
    t0 = time.perf_counter()
    want_pre = build_prefill_step(cfg, device=dev)(params, {"tokens": tokens})
    step = build_serve_step(cfg, device=dev)
    cache = init_cache(cfg, PREFILL_BATCH, MESH_DECODE_STEPS, device=dev)
    want_dec = []
    for t in range(MESH_DECODE_STEPS):
        cache, lg = step(params, cache, new[:, t:t + 1], t)
        want_dec.append(lg)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del cache
    train_layout = shard_params(params, cfg, mesh)
    serve_layout = shard_params(params, cfg, mesh, serve=True)
    t0 = time.perf_counter()
    got_pre = build_prefill_step(cfg, device=dev, mesh=mesh)(
        train_layout, {"tokens": tokens})
    step = build_serve_step(cfg, device=dev, mesh=mesh)
    cache = shard_cache(init_cache(cfg, PREFILL_BATCH, MESH_DECODE_STEPS,
                                   device=dev), cfg, mesh)
    got_dec = []
    for t in range(MESH_DECODE_STEPS):
        cache, lg = step(serve_layout, cache, new[:, t:t + 1], t)
        got_dec.append(lg)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    same_pre = same_bits(got_pre, want_pre)
    same_dec = [same_bits(a, b) for a, b in zip(got_dec, want_dec)]
    row = {"check": "mesh_serve", "arch": cfg.name, "mesh": [1, 1],
           "prefill": [PREFILL_BATCH, PREFILL_LEN],
           "decode_steps": MESH_DECODE_STEPS,
           "prefill_same_bits": same_pre, "decode_same_bits": same_dec,
           "no_mesh_s": plain_s, "mesh_s": mesh_s,
           "prefill_finite": bool(torch.isfinite(got_pre).all())}
    print(f"[mesh] {json.dumps(row)}", flush=True)
    require(same_pre and all(same_dec) and row["prefill_finite"],
            f"[mesh] prefill/decode through mesh= differ: {row}")
    del params, train_layout, serve_layout, cache
    return row


def mesh_phase(dev, train_wall_s: float) -> list:
    """The mesh on the card (``[mesh]`` lines): (a) train steps, (b)
    ``compressed_psum``, (c) prefill and decode, on a one-rank NCCL group's
    (1, 1) mesh; the group is destroyed after."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = one_rank_mesh(dev)
    try:
        rows = [mesh_train_row(dev, mesh, train_wall_s)]
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(mesh_psum_row(dev, mesh))
        rows.append(mesh_serve_row(dev, mesh))
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] phase {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}", flush=True)
    return rows


# -- phase 5d: the dry run ----------------------------------------------------

def start_dryrun(out_dir: Path) -> list:
    """Starts ``python -m repro_torch.launch.dryrun`` for each of
    DRYRUN_CELLS, one subprocess each (the fake process group cannot share
    a process with the NCCL one), on the host's CPU.  Returns (cell,
    process, log path, start time)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = out_dir / f"{arch}__{shape}__{mesh}.log"
        with open(log, "w") as f:
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", str(out_dir)], stdout=f, stderr=subprocess.STDOUT,
                cwd=ROOT, env=env)
        procs.append(((arch, shape, mesh), p, log, time.perf_counter()))
    return procs


def dryrun_phase(out_dir: Path) -> tuple:
    """Runs the dry-run cells side by side after the card's timed phases
    (so none of those shares the host with them), and phase 9 on the card
    while they run on the host's CPU; waits for each cell (DRYRUN_TIMEOUT
    from its start; a cell past it is killed and fails the phase); prints
    its record's memory, FLOPs, collective bytes by kind (within a pod and
    across pods) and roofline terms.  Every record must be ``ok``.
    Returns (phase 9's launches by kernels-line row, the rows)."""
    t0 = time.perf_counter()
    procs = start_dryrun(out_dir)
    try:
        launches = examples_phase()
        rows = [dryrun_row(out_dir, *proc) for proc in procs]
    finally:
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[dryrun] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, rows


def dryrun_row(out_dir: Path, cell: tuple, p, log: Path,
               started: float) -> dict:
    arch, shape, mesh = cell
    left = max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - started))
    try:
        rc = p.wait(timeout=left)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        rc = None
    name = {"single": "16x16", "multi": "2x16x16"}[mesh]
    path = out_dir / f"{arch}__{shape}__{name}.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    row = {"check": "dryrun", "arch": arch, "shape": shape,
           "mesh": name, "rc": rc, "ok": rec.get("ok"),
           "wall_s": time.perf_counter() - started,
           "record_total_s": rec.get("total_s"),
           "plan": {k: rec.get("plan", {}).get(k) for k in
                    ("optimizer", "pod_strategy", "microbatches")},
           "memory": rec.get("memory"),
           "flops_per_chip": rec.get("cost_raw", {}).get("flops"),
           "bytes_accessed_per_chip": rec.get("cost_raw", {}).get(
               "bytes_accessed"),
           "collectives": rec.get("collectives"),
           "roofline": rec.get("roofline"),
           "error": rec.get("error")}
    print(f"[dryrun] {json.dumps(row)}", flush=True)
    require(rc == 0 and rec.get("ok") is True,
            f"[dryrun] {arch}/{shape}/{name}: rc {rc}, "
            f"{rec.get('error')}; log {log.read_text()[-1500:]}")
    return row


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


# -- phase 9: the entry points and the examples ------------------------------

def example_module(name: str):
    """``examples/<name>.py`` as a module (``examples`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numeric_rows() -> dict:
    """(a) NUMERIC_RUNS: each ``run_numeric`` on the card (its default
    device) against the same call with ``device="cpu"``: stencil bit for
    bit, KNN within 1e-4 with equal indices, CNN within 2e-4 of the
    output's scale, PageRank within 1e-5 of the largest rank; each raises
    its kernel's counter by the count given (counts zeroed just before the
    card's call, read just after), CNN's on the tiled kernel that route()
    picks and on no other.  Returns the launches by kernels-line row."""
    import inspect

    from repro_torch.apps import APPS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.stencil_dilate.ref import bit_mismatches
    from repro_torch.kernels.systolic_matmul.kernel import route

    out = {}
    for app, kw, counter, want_launches, kernel_row in NUMERIC_RUNS:
        fn = APPS[app].run_numeric
        args = inspect.signature(fn).bind(**kw)
        args.apply_defaults()
        t0 = time.perf_counter()
        reset_launch_counts()
        got = fn(**kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        card_s = time.perf_counter() - t0
        want = fn(**kw, device="cpu")
        row = {"check": "run_numeric", "app": app, **args.arguments,
               "card_s": card_s}
        if app == "stencil":
            row["bit_mismatches"] = bit_mismatches(got.cpu(), want)
            ok = row["bit_mismatches"] == 0
        elif app == "knn":
            row["max_abs_err"] = float((got[0].cpu() - want[0]).abs().max())
            row["index_diffs"] = int((got[1].cpu() != want[1]).sum())
            ok = row["max_abs_err"] <= 1e-4 and row["index_diffs"] == 0
        elif app == "cnn":
            a = args.arguments
            row["route"] = route(a["h"] * a["w"], 9 * a["cin"], a["cout"])
            row["max_abs_err"] = float((got.cpu() - want).abs().max())
            row["scale"] = max(1.0, float(want.abs().max()))
            ok = (row["route"] == "tiled" and counts["matmul"] == 1
                  and row["max_abs_err"] <= 2e-4 * row["scale"])
        else:
            row["rel_err"] = (float((got.cpu() - want).abs().max())
                              / float(want.max()))
            ok = row["rel_err"] <= PAGERANK_REL_TOL
        row["launches"] = {k: v for k, v in counts.items() if v}
        print(f"[examples] {json.dumps(row)}", flush=True)
        require(ok, f"[examples] {app} run_numeric {kw}: the card's output "
                f"differs from the CPU's: {row}")
        if counter is not None:
            require(counts[counter] == want_launches,
                    f"[examples] {app} run_numeric {kw}: {counter} launched "
                    f"{counts[counter]} times, not {want_launches}")
        if kernel_row is not None:
            out[kernel_row] = counts[counter]
    return out


def example_rows() -> None:
    """(b) The examples' card parts, called from their modules: the
    quickstart's KNN design (compiled without floorplans: host work the
    path phase already does) executed on the card and on the CPU, and its
    20 LM steps; multi_fpga_apps' fabric execution; serve_lm twice;
    train_lm with its injected failure."""
    from repro_torch.exec import bit_identical
    from repro_torch.kernels import launch_counts, reset_launch_counts

    qs = example_module("torch_quickstart")
    t0 = time.perf_counter()
    design = qs.compile_flow(floorplan_devices=())
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_launch_counts()
    res = qs.execute_flow(design)
    torch.cuda.synchronize()
    launches = launch_counts()["knn"]
    execute_s = time.perf_counter() - t0
    cpu = qs.execute_flow(design, "cpu")
    (gd, gi), (wd, wi) = res.outputs, cpu.outputs
    row = {"check": "quickstart_execute", "compile_s": compile_s,
           "execute_s": execute_s, "knn_launches": launches,
           "max_abs_err": float((gd.cpu() - wd).abs().max()),
           "index_diffs": int((gi.cpu() != wi).sum()),
           "agreement": res.report.agreement()}
    print(f"[examples] {json.dumps(row)}", flush=True)
    require(row["max_abs_err"] <= 1e-4 and row["index_diffs"] == 0
            and all(row["agreement"].values()) and launches > 0,
            f"[examples] quickstart execute: {row}")

    t0 = time.perf_counter()
    losses = qs.tiny_lm_train()
    row = {"check": "quickstart_lm", "steps": len(losses),
           "first_loss": losses[0], "last_loss": losses[-1],
           "row_s": time.perf_counter() - t0}
    print(f"[examples] {json.dumps(row)}", flush=True)
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0], f"[examples] quickstart LM: {row}")

    mf = example_module("torch_multi_fpga_apps")
    t0 = time.perf_counter()
    reset_launch_counts()
    fabric, ideal = mf.fabric_execution()
    torch.cuda.synchronize()
    row = {"check": "fabric_execution",
           "bit_identical": bit_identical(fabric.outputs, ideal.outputs),
           "agreement": fabric.report.agreement(),
           "dilate_launches": launch_counts()["dilate"],
           "row_s": time.perf_counter() - t0}
    print(f"[examples] {json.dumps(row)}", flush=True)
    require(row["bit_identical"] and all(row["agreement"].values())
            and row["dilate_launches"] > 0, f"[examples] fabric: {row}")

    sv = example_module("torch_serve_lm")
    t0 = time.perf_counter()
    first, second = sv.main(), sv.main()
    row = {"check": "serve_lm", "tokens": list(first.shape),
           "equal": bool(np.array_equal(first, second)),
           "row_s": time.perf_counter() - t0}
    print(f"[examples] {json.dumps(row)}", flush=True)
    require(row["equal"], "[examples] serve_lm: two runs with generator "
            "seed 7 give other tokens")

    tl = example_module("torch_train_lm")
    t0 = time.perf_counter()
    final, attempts = tl.main()
    losses = [m["loss"] for h in attempts for m in h]
    row = {"check": "train_lm", "final_step": final,
           "attempts": len(attempts),
           "resumed_from": attempts[-1][0]["step"] - 1,
           "first_loss": losses[0], "last_loss": losses[-1],
           "row_s": time.perf_counter() - t0}
    print(f"[examples] {json.dumps(row)}", flush=True)
    require(final == 60 and len(attempts) == 2
            and row["resumed_from"] == 20
            and all(math.isfinite(x) for x in losses),
            f"[examples] train_lm: {row}")


def examples_phase() -> dict:
    """(a) the entry points' ``run_numeric``s, (b) the examples' card
    parts; prints the phase's wall time.  Returns (a)'s launches by
    kernels-line row."""
    t0 = time.perf_counter()
    launches = numeric_rows()
    example_rows()
    print(f"[examples] phase {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}", flush=True)
    return launches


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
        for pair in ("Li192ELi128E", "Li256ELi256E"):
            inst = [n for n in sm90 if pair in n]
            require(len(inst) == 1
                    and sm90[inst[0]].get("spill_store_bytes") == 0
                    and sm90[inst[0]].get("spill_load_bytes") == 0,
                    f"ptxas: the {pair} flash_sm90_kernel instance spills "
                    f"or is missing: {sm90}")
        tiled = ptxas_report(info.log, "matmul_kernel")
        print(f"ptxas: matmul_kernel instances {json.dumps(tiled)}",
              flush=True)
        require(len(tiled) == 3
                and all(r.get("spill_store_bytes") == 0
                        and r.get("spill_load_bytes") == 0
                        for r in tiled.values()),
                f"ptxas: the tiled matmul_kernel's three instances spill or "
                f"are missing: {tiled}")
        D64_PTXAS.update(ptxas_report(info.log, "flash_sm90_d64_kernel"))
        print(f"ptxas: flash_sm90_d64_kernel instances "
              f"{json.dumps(D64_PTXAS)}", flush=True)
        require(len(D64_PTXAS) == 2, f"ptxas: {len(D64_PTXAS)} "
                f"flash_sm90_d64_kernel instances, not 2 (two and three "
                f"consumer warpgroups)")
    build.library()
    hgmma = hgmma_counts(info.path)
    print(f"sass: HGMMA instructions per kernel {json.dumps(hgmma)}",
          flush=True)
    tc_kernels = [n for n in hgmma
                  if "flash_sm90_kernel" in n or "flash_sm90_d64_kernel" in n]
    require(len(tc_kernels) == 5 and all(hgmma[n] > 0 for n in tc_kernels),
            f"cuobjdump finds HGMMA in {len(tc_kernels)} tensor-core flash "
            f"kernels, not 5 (three flash_sm90_kernel instances, two "
            f"flash_sm90_d64_kernel)")

    return card_phases(dev)


def card_phases(dev) -> int:
    """Phases 3 to 8, phase 9 beside the dry runs, the kernels line and the
    last line."""
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
    for name in ("flash_attention_mla", "flash_attention_hd256",
                 "flash_attention_g7", "flash_attention_seamless"):
        launches[name] = 0
    for r in lm_rows.values():
        if r["kernel_row"] is not None:
            launches[r["kernel_row"]] += r["launches"]["flash_attention"]
    torch.cuda.empty_cache()
    train_rows = train_phase(dev)
    mesh_phase(dev, train_rows[0]["mean_wall_s"])
    obs_phase(dev, designs)
    tenants_phase(dev)
    chaos_phase(dev)
    tiled, _ = dryrun_phase(ROOT / "results" / "dryrun_torch")
    launches.update(tiled)

    blas = "src/repro/kernels/hbm_blas/kernel.py"
    sources = {"dilate": ("src/repro_torch/csrc/dilate.cu",
                          "src/repro/kernels/stencil_dilate/kernel.py:52"),
               "matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/systolic_matmul/kernel.py:42"),
               "matmul_tiled": (
                   "src/repro_torch/csrc/matmul.cu",
                   "src/repro/kernels/systolic_matmul/kernel.py:42"),
               "matmul_tiled_vgg_conv3": (
                   "src/repro_torch/csrc/matmul.cu",
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
                   "src/repro_torch/csrc/flash_attention_sm90.cu",
                   "src/repro/kernels/flash_attention/kernel.py:99"),
               "flash_attention_g7": (
                   "src/repro_torch/csrc/flash_attention_sm90.cu",
                   "src/repro/kernels/flash_attention/kernel.py:99"),
               "flash_attention_seamless": (
                   "src/repro_torch/csrc/flash_attention_sm90.cu",
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
