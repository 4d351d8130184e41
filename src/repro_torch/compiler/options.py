"""`CompileOptions` — the single, frozen configuration record for the
TAPA-CS compiler pipeline.

Every knob that used to be passed positionally to one of the legacy free
functions (``partition`` / ``floorplan_device`` / ``pipeline_interconnect`` /
``simulate``) or hacked in-place at a call site (the unit rescaling in
``launch/plan.py``) lives here, grouped by the pass that consumes it.  See
``repro.compiler`` (the package docstring) for the field-by-field reference.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping, Optional, Tuple, Union

from ..core.floorplan import SlotGrid

if TYPE_CHECKING:                     # avoid a runtime compiler<->net cycle
    from ..mem.banks import MemConfig
    from ..net.fabric import Fabric


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Frozen options bundle consumed by :func:`repro.compiler.compile`.

    The defaults reproduce the paper's single-node FPGA flow (Eq. 1–2
    partition, Eq. 4 floorplan, §4.6 pipelining, §5 schedule simulation).
    """

    # -- pipeline shape ----------------------------------------------------
    # Ordered pass names; None = the default full pipeline
    # (normalize_units, partition, floorplan, pipeline_interconnect,
    # schedule).  Subsets compose: launch/plan.py runs without floorplan
    # and schedule.
    passes: Optional[Tuple[str, ...]] = None

    # -- normalize_units pass ---------------------------------------------
    # Scale per-kind areas/capacities by powers of two into a solver-safe
    # range (HiGHS misbehaves on 1e15-scale coefficients) and scale results
    # back.  Power-of-two factors make the round trip bit-exact.
    normalize_units: bool = True
    # Device-resource overrides (original units) applied to a *copy* of the
    # cluster's DeviceSpec — e.g. pod-aggregate HBM = per-chip HBM × chips.
    capacity_override: Optional[Mapping[str, float]] = None
    # Kinds whose capacity is set to slack × (graph total): turns a kind
    # into a pure balance target so Eq. 1 never binds on it.
    relax_capacity_kinds: Tuple[str, ...] = ()
    relax_capacity_slack: float = 2.0

    # -- partition pass (Eq. 1–2) -----------------------------------------
    balance_kind: Optional[str] = None
    balance_tol: float = 0.35
    pins: Optional[Mapping[str, int]] = None
    exact_limit: int = 20000
    partition_time_limit: float = 60.0

    # -- floorplan pass (Eq. 4) -------------------------------------------
    # None = U55C_GRID for FPGA devices, TPU_POD_GRID for tpu-* devices.
    grid: Optional[SlotGrid] = None
    floorplan_threshold: float = 0.70
    # Tasks that read HBM (softly pinned to HBM-adjacent rows); filtered
    # per device by membership.
    hbm_tasks: Tuple[str, ...] = ()
    floorplan_time_limit: float = 30.0
    floorplan_strict: bool = False
    # None = every device that received tasks.
    floorplan_devices: Optional[Tuple[int, ...]] = None

    # -- pipeline_interconnect pass (§4.6) --------------------------------
    min_depth: int = 2

    # -- congestion_feedback pass (repro.net, §4.3) -----------------------
    # Explicit network fabric.  When set, compile() appends the
    # congestion_feedback pass after partition (unless options.passes
    # overrides the pipeline), the artifact carries the fabric, and
    # design.execute() routes inter-device tokens through it.  None with
    # an explicit congestion_feedback pass derives the fabric from the
    # cluster topology.
    fabric: Optional["Fabric"] = None
    # A link whose projected utilization — OFFERED load: demanded bytes
    # per step over the link's bandwidth × step-time service, may exceed
    # 1 — passes this threshold triggers a calibrated repartition.
    congestion_threshold: float = 0.75
    # Time base of one step for the projection.  None = the transport's
    # NetConfig.sweep_time_s default (the same time base the executor's
    # sweeps use).
    congestion_step_time_s: Optional[float] = None
    # λ inflation per unit of relative utilization overshoot on hot links.
    congestion_penalty: float = 2.0
    congestion_max_retries: int = 2
    # §4.3: congestion control outranks load balance — hot repartitions
    # drop the balance band so traffic may consolidate off hot links.
    congestion_relax_balance: bool = True

    # -- memory_feedback pass (repro.mem) ---------------------------------
    # HBM bank model.  When set, compile() appends the memory_feedback
    # pass after partition (and after congestion_feedback when a fabric is
    # also set), the artifact carries the MemConfig + task→bank map, and
    # design.execute() steps banks per sweep.
    mem: Optional["MemConfig"] = None
    # A bank whose projected utilization — offered load, like the link
    # threshold above — passes this triggers a bank re-map and, failing
    # that, a membound repartition.
    mem_threshold: float = 0.75
    # None = the MemConfig's sweep-time base (shared with the transport).
    mem_step_time_s: Optional[float] = None
    # Allow the membound repartition stage (bank re-map alone is always on).
    mem_repartition: bool = True

    # -- schedule pass (cost model, §5) -----------------------------------
    # None = device fmax (or 1.0 when the device has no fabric clock);
    # a float applies to every device; a mapping is per-device.
    freq_hz: Optional[Union[float, Mapping[int, float]]] = None
    overlap: bool = True
    hbm_efficiency: float = 1.0

    def replace(self, **changes) -> "CompileOptions":
        return dataclasses.replace(self, **changes)
