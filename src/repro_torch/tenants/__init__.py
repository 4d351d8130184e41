"""repro_torch.tenants — multi-tenant SLO serving over one shared fabric.

N independent ``CompiledDesign``s admitted as tenants onto ONE physical
cluster, sharing one :class:`~repro_torch.net.transport.FabricTransport`
(weighted-fair flow arbitration, exact per-tenant byte accounting) and
optionally one :class:`~repro_torch.mem.banks.MemorySystem`, fronted by an
admission/SLO scheduler and driven by open-loop traffic.  Every tenant
computes on the server's one torch device (``cuda`` unless the caller
passes ``device="cpu"``).

    from repro_torch.tenants import SLO, Tenant, TenantServer, DeviceKill

    server = TenantServer(fabric, [
        Tenant("a", design_a, device_map=[0, 2], slo=SLO(1e-3, weight=2)),
        Tenant("b", design_b, device_map=[0, 1], slo=SLO(1e-3, weight=1)),
    ])
    out = server.run(faults=[DeviceKill(device=2, sweep=40)])
    out.conservation            # Σ per-tenant link bytes == totals, exact
    out.record("b").result      # bit-identical to b's solo run

Two fidelity levels, deliberately split:

* :mod:`~repro_torch.tenants.server` co-executes real designs flit by flit
  and *asserts* the substrate's properties (bit-identity with solo runs,
  exact conservation, fault drain without collateral damage);
* :mod:`~repro_torch.tenants.simulate` serves thousands of generated
  requests (:mod:`~repro_torch.tenants.traffic`) in virtual time over the
  fluid model of the substrate those assertions validated.

``python -m repro_torch.tenants.smoke`` drives it end to end: 2 tenants on
a shared 4-ring, one injected device kill, re-admission on survivors.
"""
from .recover import (RecoveryPlan, plan_recovery, recompile,
                      shrink_cluster)
from .server import (DeviceKill, FlowMemory, FlowTransport, ServeOutcome,
                     Tenant, TenantRecord, TenantServer, bit_identical)
from .simulate import (SimResult, TenantLoad, TenantStats, fair_share,
                       isolation_check, load_sweep, simulate)
from .slo import ADMIT, QUEUE, REJECT, SLO, AdmissionController
from .traffic import Request, TrafficConfig, generate, merge, offered_load

__all__ = [
    "ADMIT", "AdmissionController", "DeviceKill", "FlowMemory",
    "FlowTransport", "QUEUE", "REJECT", "Request", "SLO", "ServeOutcome",
    "RecoveryPlan", "SimResult", "Tenant", "TenantLoad", "TenantRecord",
    "TenantServer", "TenantStats", "bit_identical", "fair_share",
    "generate", "isolation_check", "load_sweep", "merge", "offered_load",
    "plan_recovery", "recompile", "shrink_cluster", "simulate",
]
