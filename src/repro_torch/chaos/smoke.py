"""Chaos smoke run: the reduced fault matrix on one app.

One drop-rate tier, one finite link outage, one permanent link death
(route repair), and one kill/restore cell, all on the stencil app over a
4-FPGA ring.  Every cell asserts bit-identity against the fault-free
baseline, full measured-vs-predicted agreement (including the
repair-aware goodput conservation), seeded replayability, and the
barrier-bounded restore cost.  Two **per-tenant** cells then co-run two
weighted tenants over one shared ring — a lossy fabric and a device kill
— asserting the cost ledger sums bit-exactly and the kill charges the
victim's lineage only.  Writes the fault-matrix JSON artifact::

    PYTHONPATH=src python -m repro_torch.chaos.smoke [--device cpu] \
        [--app stencil] [--full] [--out results/chaos_smoke_torch.json] \
        [--trace results/chaos_trace_torch.json]

``--full`` runs the complete :func:`repro_torch.chaos.default_matrix` over
all four paper apps (several minutes).  ``--trace`` re-runs the drop-tier
cell on the stencil 4-ring with a recording tracer, writes its Chrome
trace, and asserts the critical-path analysis attributes at least one
sweep to ARQ retransmits on the faulted link.

The apps run at their binders' default specs, on the CUDA card (the
hand-written kernels) unless ``--device cpu`` asks for the kernels' plain
versions.
"""
from __future__ import annotations

import argparse
import json
import os

from .scenario import ChaosScenario

#: The reduced matrix (one drop tier, both link-down shapes, one kill).
SMOKE_SCENARIOS = (
    ChaosScenario("drop-mid", drop=0.05, corrupt=0.02, reorder=0.03,
                  seed=5),
    ChaosScenario("down-window", down={5: ((0, 6),)}, seed=11),
    ChaosScenario("link-death", down={5: ((0, None),)}, fail_threshold=4,
                  seed=13),
    ChaosScenario("kill-restore", kill_sweep=6, barrier=4, seed=17),
)
#: The per-tenant cells: a lossy shared fabric (ledger sums bit-exactly,
#: both tenants charged) and a clean-link device kill (the victim's
#: lineage pays, the peer pays zero).
TENANT_SCENARIOS = (
    ChaosScenario("tenant-drop", drop=0.05, corrupt=0.02, seed=5),
    ChaosScenario("tenant-kill", kill_sweep=2, seed=17),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.chaos.smoke")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--app", default="stencil",
                    choices=["stencil", "pagerank", "knn", "cnn"])
    ap.add_argument("--full", action="store_true",
                    help="full matrix over all four apps")
    ap.add_argument("--out", default="results/chaos_smoke_torch.json")
    ap.add_argument("--trace", default=None,
                    help="write the traced drop-tier cell's Chrome trace")
    args = ap.parse_args(argv)

    from ..exec import resolve_device
    from .runner import run_matrix, run_scenario, run_tenant_cell
    from .scenario import default_matrix

    device = resolve_device(args.device)
    print(f"device: {device}")
    if args.full:
        apps = ("stencil", "cnn", "knn", "pagerank")
        scenarios = default_matrix()
    else:
        apps = (args.app,)
        scenarios = SMOKE_SCENARIOS
    matrix = run_matrix(apps, scenarios, verbose=True, device=device)
    assert matrix["ok"]

    tenant_cells = []
    for sc in TENANT_SCENARIOS:
        cell = run_tenant_cell(sc, device=device)
        tenant_cells.append(cell)
        print(f"  [tenants × {sc.name}] sweeps {cell['sweeps']} "
              f"(clean {cell['clean_sweeps']}), ledger exact")
    matrix["tenant_cells"] = tenant_cells
    assert all(c["ok"] for c in tenant_cells)

    if args.trace:
        # The observability acceptance cell: trace the drop-tier scenario
        # on the stencil 4-ring and prove the critical-path analysis pins
        # recovery sweeps on the ARQ traffic of the faulted link.
        from ..obs.critpath import analyze
        from ..obs.trace import Tracer, write_chrome_trace
        drop = SMOKE_SCENARIOS[0]
        tracer = Tracer()
        cell = run_scenario("stencil", drop, tracer=tracer, device=device)
        crit = analyze(tracer, sweeps=cell["sweeps"])
        faulted = {e[2] for e in tracer.iter_kind("retransmit")}
        assert faulted, "drop-tier cell produced no retransmits"
        assert any(crit.fault_link_sweeps.get(li, 0) >= 1
                   for li in faulted), \
            "no fault sweep attributed to the faulted links"
        assert sum(t.fault for t in crit.tasks) >= 1, \
            "critpath attributed no task sweep to ARQ recovery"
        doc = write_chrome_trace(tracer, args.trace)
        matrix["traced_cell"] = {
            "scenario": drop.name,
            "trace_events": len(doc["traceEvents"]),
            "fault_link_sweeps": {str(k): v for k, v in
                                  crit.fault_link_sweeps.items()},
            "fault_task_sweeps": sum(t.fault for t in crit.tasks),
        }
        print(f"wrote Chrome trace ({len(doc['traceEvents'])} events) "
              f"to {args.trace}; fault sweeps on faulted links "
              f"{matrix['traced_cell']['fault_link_sweeps']}")

    matrix["device"] = str(device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(matrix, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")
    print(f"CHAOS_SMOKE_OK cells={len(matrix['cells'])} "
          f"apps={len(matrix['apps'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
