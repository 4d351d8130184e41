"""repro_torch.net — the contention-aware network fabric (paper §4.3 congestion
control, made executable).

A copy of the JAX package's ``net``: the fabric, the flit transport, the
congestion measurement and the feedback pass are plain Python over integer
counters, so the port runs them unchanged on the host beside the card.  A
channel's payload never rides the transport (the FIFO channel holds it);
the transport only decides the sweep at which it becomes visible, so the
fabric path computes the same bits as the ideal path.

Sits between the compiler and the executor:

* :mod:`~repro_torch.net.fabric` lowers every ``Topology`` to explicit directed
  links (per-link ``Protocol``) with deterministic shortest-path routes;
* :mod:`~repro_torch.net.transport` packetizes channel pushes into MTU flits and
  arbitrates links per sweep — fair bandwidth sharing + credit-based
  backpressure, so co-routed channels genuinely contend;
* :mod:`~repro_torch.net.congestion` tracks per-link utilization/queueing into a
  :class:`CongestionReport` (measured from a transport, or projected
  analytically from a partition);
* :mod:`~repro_torch.net.calibrate` feeds measurements back into the compiler:
  per-link Eq. 2 re-evaluation, calibrated pair costs, and the registered
  ``congestion_feedback`` pass that repartitions around hotspots;
* :mod:`~repro_torch.net.faults` models lossy links (seeded drop / corrupt /
  reorder, scripted down windows, link death) for the chaos
  layer — the transport's ARQ + route repair keeps results bit-identical
  under every fault the model can inject.

Quickstart (compile → execute through the fabric → congestion report)::

    from repro_torch.compiler import CompileOptions, compile
    from repro_torch.core import fpga_ring_cluster
    from repro_torch.net import cluster_fabric

    cluster = fpga_ring_cluster(4)
    design = compile(graph, cluster,
                     CompileOptions(balance_kind="LUT",
                                    fabric=cluster_fabric(cluster)))
    result = design.execute()          # tokens now move over fabric links
                                       # (device="cpu" without a card)
    result.report.congestion.summary() # per-link bytes / utilization

``python -m repro_torch.net.smoke`` runs one app on a 2×2 mesh through the
fabric and on the ideal path (on the card; ``--device cpu`` to test) and
writes the per-link utilization JSON.
"""
from .calibrate import (calibrated_pair_cost, congestion_feedback_pass,
                        lambda_crosscheck, route_comm_cost)
from .congestion import CongestionReport, LinkUsage, measure, project
from .fabric import Fabric, Link, SHARED, build_fabric, cluster_fabric
from .faults import FaultModel, LinkFaults, PartitionedFabricError
from .transport import FabricTransport, LinkCounters, NetConfig

__all__ = [
    "CongestionReport", "Fabric", "FabricTransport", "FaultModel", "Link",
    "LinkCounters", "LinkFaults", "LinkUsage", "NetConfig",
    "PartitionedFabricError", "SHARED", "build_fabric",
    "calibrated_pair_cost", "cluster_fabric", "congestion_feedback_pass",
    "lambda_crosscheck", "measure", "project", "route_comm_cost",
]
