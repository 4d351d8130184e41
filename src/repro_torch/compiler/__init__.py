"""repro_torch.compiler — the unified TAPA-CS pass pipeline.

The paper's promise is that TAPA-CS "automatically partitions and compiles a
large design across a cluster of FPGAs with no additional user effort".
This package is that promise as an API: one call

    from repro_torch.compiler import CompileOptions, compile

    design = compile(graph, cluster, CompileOptions(balance_kind="LUT"))

runs the whole flow — graph → partition → floorplan → interconnect
pipelining → cost-model schedule — and returns a single immutable
:class:`CompiledDesign` artifact.  The flow is structured as a
:class:`CompilerPipeline` of named, registered passes (following the pass
organization of TAPA itself and the staged lowering of Prabhakar et al.'s
configurable-hardware generation), so a future scaling feature is a new
pass, not another copy of the call chain.

Passes
======

``normalize_units``
    Builds solver-facing *copies* of the graph and cluster with per-kind
    areas/capacities scaled by powers of two into HiGHS's comfortable
    coefficient range (raw TPU-scale values, bytes ~1e13 / flops ~1e15,
    previously had to be rescaled in place at the call site in
    launch/plan.py).  Power-of-two factors make descaling bit-exact; FPGA
    LUT/DSP-scale values pass through untouched.  Also owns capacity
    shaping: ``capacity_override`` (e.g. pod-aggregate HBM) and
    ``relax_capacity_kinds`` (turn a kind into a pure balance target by
    setting its capacity to ``relax_capacity_slack`` × the graph total).
    The caller's graph and cluster are never mutated.

``partition``
    Inter-device ILP partitioning (paper Eq. 1–2) via
    ``repro.core.partitioner``: exact product-linearized MILP up to
    ``exact_limit``, recursive bisection beyond, KL polish.  Controlled by
    ``balance_kind`` / ``balance_tol`` (compute-load band), ``pins``
    (task → device pre-assignments), ``partition_time_limit``.  Resource
    usage in the resulting :class:`~repro.core.Partition` is reported in
    the caller's original units.

``floorplan``
    Per-device slot placement (paper Eq. 4) for every device that received
    tasks (or ``floorplan_devices``).  ``grid`` defaults to the U55C
    2×3 grid (TPU_POD_GRID for tpu-* devices); ``hbm_tasks`` are softly
    pinned to HBM-adjacent rows (§4.5 channel binding);
    ``floorplan_threshold`` is the Eq. 1 slot threshold, escalated on
    infeasibility unless ``floorplan_strict``.

``pipeline_interconnect``
    §4.6 register insertion on every slot/device crossing plus cut-set
    balancing of reconvergent paths.  Writes the balanced FIFO ``depth``
    onto the caller's graph channels (the one deliberate in-place effect —
    depths are consumed downstream by launch/steps.py) and records a
    :class:`~repro.core.PipelineReport`.  ``min_depth`` floors every FIFO.

``congestion_feedback``
    §4.3 congestion control over the network fabric (``repro_torch.net``),
    auto-inserted after ``partition`` when ``options.fabric`` is set.
    Projects per-link traffic from the current partition over the fabric's
    routing tables; when a link's utilization (demanded bytes per step
    over the link's per-step service) exceeds ``congestion_threshold``, the
    partition is re-solved against congestion-calibrated pair costs
    (per-link λ inflated by the overshoot, ``congestion_penalty``),
    dropping the balance band if ``congestion_relax_balance`` — accepted
    retries re-tag ``partition.stats.method`` with ``"-congested"``.  The
    fabric and the final projected :class:`~repro_torch.net.CongestionReport`
    land on the artifact (``design.fabric`` / ``design.congestion``), and
    ``design.execute()`` then routes inter-device tokens through the
    fabric's links.

``schedule``
    Event-driven cost-model simulation (§5): per-task roofline times,
    transfer overlap (``overlap``), HBM bandwidth sharing
    (``hbm_efficiency``), clocks from ``freq_hz`` (float, per-device
    mapping, or device fmax by default).  Produces a
    :class:`~repro.core.ScheduleResult`.

CompileOptions field reference
==============================

===========================  =============================================
field                        meaning (consuming pass)
===========================  =============================================
passes                       ordered pass names; None = the full default
                             pipeline (pipeline shape)
normalize_units              enable power-of-two unit scaling (normalize)
capacity_override            device-resource overrides, original units,
                             applied to a copy (normalize)
relax_capacity_kinds         kinds whose capacity becomes slack × graph
                             total — pure balance targets (normalize)
relax_capacity_slack         the slack factor above, default 2.0
balance_kind / balance_tol   compute-balance band ±tol around the mean
                             (partition)
pins                         task → device pre-assignments (partition)
exact_limit                  max edges × device-pairs for the exact MILP
                             (partition)
partition_time_limit         HiGHS time budget in seconds (partition)
grid                         SlotGrid; None = U55C/TPU default (floorplan)
floorplan_threshold          per-slot utilization threshold T (floorplan)
hbm_tasks                    HBM-reading tasks, filtered per device
                             (floorplan)
floorplan_time_limit         per-device HiGHS budget (floorplan)
floorplan_strict             fail instead of escalating/greedy (floorplan)
floorplan_devices            explicit device subset; None = all occupied
                             (floorplan)
min_depth                    minimum FIFO depth (pipeline_interconnect)
fabric                       explicit repro.net Fabric; enables the
                             congestion_feedback pass + fabric execution
congestion_threshold         per-link utilization trigger, default 0.75
                             (congestion_feedback)
congestion_step_time_s       projection time base; None = the transport
                             sweep time (congestion_feedback)
congestion_penalty           λ inflation per unit overshoot, default 2.0
                             (congestion_feedback)
congestion_max_retries       repartition attempts, default 2
                             (congestion_feedback)
congestion_relax_balance     drop the balance band on hot repartitions,
                             default True (congestion_feedback)
freq_hz                      clock per device: None = fmax, float, or
                             mapping (schedule)
overlap                      stream transfers alongside compute (schedule)
hbm_efficiency               achievable fraction of HBM bandwidth
                             (schedule)
===========================  =============================================

Extending
=========

Register a new pass and name it in ``CompileOptions.passes``::

    from repro_torch.compiler import register_pass

    @register_pass("repartition_congested")
    def repartition_congested(state):
        ...mutate state.partition...
        return {"moved": n}

The legacy free functions (``repro.core.partition`` /
``floorplan_device`` / ``pipeline_interconnect``) remain as deprecated
shims that forward to the same implementations these passes call.
"""
from .artifact import CompiledDesign, PassRecord
from .options import CompileOptions
from .passes import (CompileError, CompileState, PASS_REGISTRY,
                     register_pass)
from .pipeline import DEFAULT_PASSES, FABRIC_PASSES, CompilerPipeline, compile

__all__ = [
    "CompileError", "CompileOptions", "CompileState", "CompiledDesign",
    "CompilerPipeline", "DEFAULT_PASSES", "FABRIC_PASSES", "PASS_REGISTRY",
    "PassRecord", "compile", "register_pass",
]
