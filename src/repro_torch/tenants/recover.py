"""Re-compile-and-re-admit — the tenant layer's half of the fault story.

The substrate half (cancel the dead tenant's flits and bank requests,
release its credits, leave every peer's stream untouched) lives in the
transport and the memory system; this module owns what happens next: the
paper's elasticity claim is that a TAPA-CS design is *re-compilable* onto
whatever devices survive, because the compile flow is a pure function of
(graph, cluster, options).  :func:`recompile` exercises exactly that —
same graph, same options, a cluster shrunk to the surviving device count —
and the server re-admits the result under a fresh flow id.

The degraded design is a first-class :class:`CompiledDesign`: partitioned,
depth-balanced, scheduled.  Nothing about it knows it is a recovery
artifact — which is the point.

The layer has a *cheaper* option too: :func:`plan_recovery` prefers
**restore-over-recompile** — when the victim was checkpointing
(sweep-barrier snapshots, :mod:`repro_torch.exec.snapshot`) and every
device of its placement survives (a transient kill: the process died, the
hardware did not), re-admitting the *same* design and restoring the latest
barrier costs (sweeps since the barrier) instead of a full recompile +
re-run.  A permanent device loss still recompiles onto the survivors.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

from ..compiler.artifact import CompiledDesign


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """What to do with a killed tenant (see :func:`plan_recovery`).

    ``action`` is ``"restore"`` (re-admit the same design + placement and
    load snapshot ``step``) or ``"recompile"`` (shrink to ``ndev``
    survivors and re-run the pass pipeline; ``ndev == 0`` means nothing
    survives — the caller must decline gracefully, there is no plan that
    works).
    """

    action: str
    step: Optional[int]
    ndev: int
    reason: str


def plan_recovery(device_map: Sequence[int],
                  dead_devices: Iterable[int], *,
                  checkpoint_dir: Optional[str] = None) -> RecoveryPlan:
    """Choose restore-over-recompile for a killed tenant.

    ``device_map`` is the victim's placement (fabric device ids);
    ``dead_devices`` the *permanently* lost devices (empty for a transient
    kill — the device restarts, only the work died).  Restore wins when a
    published snapshot exists and the snapshot's cluster still exists
    (no placement device is permanently dead); otherwise recompile onto
    the survivors.
    """
    dead = set(dead_devices)
    survivors = [d for d in device_map if d not in dead]
    if checkpoint_dir is not None and not (set(device_map) & dead):
        from ..exec.snapshot import latest_snapshot_step
        step = latest_snapshot_step(checkpoint_dir)
        if step is not None:
            return RecoveryPlan(
                action="restore", step=step, ndev=len(device_map),
                reason=f"snapshot step_{step} published and every placement "
                       "device survives — resume from the barrier")
    if not survivors:
        return RecoveryPlan(
            action="recompile", step=None, ndev=0,
            reason="no surviving devices — recovery must decline")
    return RecoveryPlan(
        action="recompile", step=None, ndev=len(survivors),
        reason=("no usable snapshot" if not (set(device_map) & dead)
                else f"placement lost {sorted(set(device_map) & dead)}")
        + f" — recompile onto {len(survivors)} survivors")


def shrink_cluster(cluster, ndev: int):
    """The same cluster with ``ndev`` devices on the same topology family.

    Ring/daisy-chain/bus shrink naturally; anything else (mesh, star,
    hypercube — shapes that don't gracefully lose one device) degrades to
    a daisy-chain of the survivors, the weakest layout that still routes.
    Node grouping is dropped once the survivors fit one node.
    """
    from ..core.topology import Bus, DaisyChain, Ring
    topo = cluster.topology
    if isinstance(topo, Ring) and ndev >= 3:
        new_topo = Ring(ndev)
    elif isinstance(topo, Bus):
        new_topo = Bus(ndev)
    else:
        new_topo = DaisyChain(ndev)
    dpn = cluster.devices_per_node
    if dpn is not None and ndev <= dpn:
        dpn = None
    return dataclasses.replace(cluster, topology=new_topo,
                               devices_per_node=dpn)


def recompile(design: CompiledDesign, ndev: int, *,
              time_limit: Optional[float] = None) -> CompiledDesign:
    """Re-run the full pass pipeline on the surviving device count.

    Pins and fabric from the original options are dropped: the pins named
    devices that may no longer exist, and the tenant's network is the
    *shared* fabric it is re-admitted onto, not a private one.
    """
    from ..compiler import compile as tapa_compile
    if ndev < 1:
        raise ValueError("need at least one surviving device")
    cluster = shrink_cluster(design.cluster, ndev)
    options = design.options.replace(pins=None, fabric=None)
    if time_limit is not None:
        options = options.replace(partition_time_limit=time_limit)
    return tapa_compile(design.graph, cluster, options)
