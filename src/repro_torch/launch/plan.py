"""Partition plan: the TAPA-CS compiler pipeline (graph → normalize →
ILP partition → pipelining, via repro_torch.compiler.compile) applied to
an (arch × shape × mesh) cell.

The plan records what the tool decided and why — it is consumed by
steps.py (which optimizer, which pod strategy) and reported by
dryrun.py.  A copy of the JAX package's module on the port's
``compiler``, ``core`` and ``graphs``, with the per-chip memory as an
argument: ``hbm_per_chip`` defaults to the reference's 16 GiB chip
(``REFERENCE_HBM_PER_CHIP``, the JAX package's TPU model, so a plan
equals JAX's), and the dry run passes the H100's 80 GB.  The Eq. 1
budgets that were fixed fractions of the 16 GiB chip (AdamW state up to
9 GiB, 6 GiB of state before doubling the microbatches) scale with it.
The step-time estimate behind the pod strategy keeps the reference's
rates (``core.costmodel``'s TPU model).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..compiler import CompileOptions, CompiledDesign
from ..compiler import compile as tapa_compile
from ..configs.base import SHAPES
from ..core import Partition, lm_pod_strategy, tpu_pod_cluster
from ..core.costmodel import TPU_DCN_BW, TPU_PEAK_FLOPS
from ..models import ModelConfig
from .graphs import build_lm_graph, total_param_bytes

#: The JAX package's per-chip memory (its TPU model): a plan at this value
#: equals the reference's.
REFERENCE_HBM_PER_CHIP = 16 * 1024 ** 3


@dataclasses.dataclass
class Plan:
    arch: str
    shape: str
    num_pods: int
    pod_strategy: str                 # dp | pp
    optimizer: str                    # adamw | adafactor
    microbatches: int
    partition: Optional[Partition]
    pipeline_depths: Optional[dict]
    param_bytes: float
    state_bytes_per_chip: float
    rationale: str
    compiled: Optional[CompiledDesign] = None


def make_plan(arch: str, cfg: ModelConfig, shape: str,
              num_pods: int = 1, chips_per_pod: int = 256,
              hbm_per_chip: float = REFERENCE_HBM_PER_CHIP) -> Plan:
    cell = SHAPES[shape]
    hbm = hbm_per_chip / REFERENCE_HBM_PER_CHIP   # 1 for the reference
    pbytes = total_param_bytes(cfg)
    # Optimizer choice (Eq. 1 resource gate): AdamW keeps bf16 params +
    # fp32 grad-accum + 2×fp32 moments = 7×param_bytes of state; if that
    # exceeds 9/16 of a chip's HBM (leaving headroom for activations),
    # fall back to Adafactor (3×param_bytes).
    adam_state = pbytes * 7.0
    optimizer = ("adamw"
                 if adam_state / chips_per_pod <= 9 * 1024 ** 3 * hbm
                 else "adafactor")
    state = pbytes * (7.0 if optimizer == "adamw" else 3.1)
    state_per_chip = state / chips_per_pod

    part = None
    depths = None
    design = None
    strategy = "dp"
    rationale = ""
    if cell.kind == "train":
        # Build the task graph and run the real partitioner across pods.
        g = build_lm_graph(cfg, cell.global_batch, cell.seq_len,
                           state_mult=6.0 if optimizer == "adamw" else 3.1)
        flops_step = sum(float(t.meta.get("ops", 0.0))
                         for t in g.tasks.values())
        step_s = flops_step / (TPU_PEAK_FLOPS * chips_per_pod * num_pods
                               * 0.4)
        strategy = lm_pod_strategy(
            pbytes, 0.0, flops_step, num_pods, hbm_per_chip, chips_per_pod,
            TPU_DCN_BW, step_s)
        rationale = (f"pod strategy {strategy}: params {pbytes/1e9:.1f} GB, "
                     f"est step {step_s*1e3:.0f} ms")
        if num_pods > 1:
            cluster = tpu_pod_cluster(num_pods)
            # Per-pod HBM capacity = chips × per-chip HBM; FLOPs are a
            # balance target, not a capacity (per-step work vs per-second
            # throughput), so the compiler relaxes that cap above the graph
            # total and the balance band does the compute-load balancing.
            # Unit normalization (raw 1e15-scale coefficients would trip
            # HiGHS) happens inside the pipeline on solver-facing copies —
            # task areas and the shared TPU_V5E DeviceSpec stay untouched.
            opts = CompileOptions(
                passes=("normalize_units", "partition",
                        "pipeline_interconnect"),
                balance_kind="flops", balance_tol=0.9,
                exact_limit=2000, partition_time_limit=30.0,
                capacity_override={
                    "hbm_bytes": hbm_per_chip * chips_per_pod},
                relax_capacity_kinds=("flops",))
            design = tapa_compile(g, cluster, opts)
            part = design.partition
            depths = design.pipeline_report.depth
    # Microbatch count: 8 default; 16 when optimizer state already eats
    # most of the chip's budget (6/16 of it; v3: state ≈ 10 GB of a 16 GB
    # chip), or when the
    # arch carries sequence-scan recurrences whose backward stacks per-step
    # carries (xlstm mLSTM/sLSTM: 19.5 GB at mb=8 → fits at 16).
    specs_all = list(cfg.pattern) + list(cfg.extra_layers)
    recurrent_heavy = any(s.mixer in ("mlstm", "slstm") for s in specs_all)
    microbatches = (16 if (state_per_chip > 6 * 1024 ** 3 * hbm
                           or recurrent_heavy) else 8)
    # Each microbatch must still cover every batch shard (data × pod), or
    # the batch dim de-shards and activations replicate.
    batch_shards = 16 * num_pods
    if cell.kind == "train":
        microbatches = min(microbatches,
                           max(1, cell.global_batch // batch_shards))
    return Plan(arch=arch, shape=shape, num_pods=num_pods,
                pod_strategy=strategy, optimizer=optimizer,
                microbatches=microbatches, partition=part,
                pipeline_depths=depths,
                param_bytes=pbytes, state_bytes_per_chip=state_per_chip,
                rationale=rationale, compiled=design)
