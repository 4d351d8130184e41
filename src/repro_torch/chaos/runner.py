"""Chaos runner: execute a scenario matrix and *assert* the guarantees.

One cell = (app, scenario).  Each app compiles once per process
(:func:`compile_app`, memoized; the options are
:func:`repro_torch.obs.smoke.compile_app`'s) onto a 4-FPGA ring with the
full pass pipeline and a real fabric; the fault-free baseline run provides
the bit-identity reference and the sweep floor.  :func:`run_scenario`
then:

* runs the scenario's :class:`~repro_torch.net.faults.FaultModel` end to
  end — outputs must be **bit-identical** (bit patterns,
  :func:`~repro_torch.exec.bit_identical`) to the baseline, every
  measured-vs-predicted agreement identity (including the repair-aware
  goodput conservation) must hold, and a same-seed **replay** must land on
  the identical sweep count and retransmit tally;
* for kill cells, injects a :class:`~repro_torch.runtime.fault.FailureInjector`
  death mid-run with sweep-barrier checkpointing on, resumes via
  :func:`~repro_torch.exec.snapshot.resume_execution`, and bounds the restore
  cost: total sweeps ≤ baseline + barrier interval + drain slack (the
  acceptance criterion — a kill costs the sweeps since the barrier, not a
  re-run).

:func:`run_tenant_cell` adds the **per-tenant** chaos cells: two weighted
tenants co-run over one shared ring under the scenario's faults, and the
per-tenant cost ledger (:mod:`repro_torch.obs.attrib`) must sum bit-exactly to
the global counters — with kill cells charging the victim's lineage only.

Everything is deterministic — seeded rngs, no wall clock — so a failing
cell is replayable from its JSON record alone, and a cell's record is the
same on every device: the faults are drawn on the host.  Every run takes
``device=`` (``cuda`` unless the caller asks for the CPU; with no card and
no ``device=`` the runner raises).
"""
from __future__ import annotations

import tempfile
from typing import Any, Dict, Optional, Sequence, Tuple

from .scenario import ChaosScenario, default_matrix

#: Sweep slack allowed on top of the barrier interval for a restored run:
#: the network drain of the recalled segment plus ARQ backoff tails.
DRAIN_SLACK = 16

_COMPILED: Dict[Tuple[str, int], Tuple[Any, Any]] = {}


def compile_app(app: str, ndev: int = 4):
    """(graph, design) for ``app`` on an ``ndev``-FPGA ring with a real
    fabric — memoized per process (compilation dominates cell cost).  The
    compile is :func:`repro_torch.obs.smoke.compile_app`'s, so a caller that
    compiles through this function shares its designs with every cell."""
    key = (app, ndev)
    if key not in _COMPILED:
        from ..obs.smoke import compile_app as obs_compile_app
        _COMPILED[key] = obs_compile_app(app, ndev)
    return _COMPILED[key]


def _execute(graph, design, device, *, faults=None, injector=None,
             checkpoint_dir=None, checkpoint_every=None, tracer=None):
    from ..exec import bind_programs, execute
    return execute(design, bind_programs(graph, device=device),
                   device=device, faults=faults, injector=injector,
                   checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, tracer=tracer)


def _run_kill_cell(graph, design, scenario: ChaosScenario, baseline,
                   cell: Dict[str, Any], device) -> Any:
    """Kill mid-run, restore from the barrier, bound the extra sweeps."""
    from ..exec import bind_programs, resume_execution
    from ..runtime.fault import FailureInjector
    fm = scenario.fault_model()
    with tempfile.TemporaryDirectory() as d:
        injector = FailureInjector(fail_at_steps=[scenario.kill_sweep])
        try:
            _execute(graph, design, device, faults=fm, injector=injector,
                     checkpoint_dir=d, checkpoint_every=scenario.barrier)
            raise AssertionError(
                f"{scenario.name}: run finished before kill sweep "
                f"{scenario.kill_sweep} — scenario is miscalibrated")
        except FailureInjector.Injected:
            pass
        resumed = resume_execution(design, d,
                                   binding=bind_programs(graph,
                                                         device=device),
                                   device=device, faults=fm)
    cell["restore_sweeps"] = resumed.report.sweeps
    cell["restore_extra_sweeps"] = (resumed.report.sweeps
                                    - baseline.report.sweeps)
    # A faulted resume replays losses, so the barrier bound only binds the
    # clean-link cells; lossy kills still assert identity + agreement.
    if not scenario.lossy:
        assert cell["restore_extra_sweeps"] <= scenario.barrier \
            + DRAIN_SLACK, (
            f"{scenario.name}: restore cost {cell['restore_extra_sweeps']} "
            f"sweeps > barrier {scenario.barrier} + drain {DRAIN_SLACK}")
    return resumed


def run_scenario(app: str, scenario: ChaosScenario, *, ndev: int = 4,
                 baseline=None, tracer=None, device=None) -> Dict[str, Any]:
    """Run one matrix cell; raises AssertionError on any broken guarantee,
    returns the cell's JSON-ready record otherwise.  ``tracer`` records the
    faulted run (baseline and replay stay untraced — the bit-identity and
    determinism asserts double as the tracer-transparency check)."""
    from ..exec import resolve_device
    from ..tenants import bit_identical
    device = resolve_device(device)
    graph, design = compile_app(app, ndev)
    if baseline is None:
        baseline = _execute(graph, design, device)
    cell: Dict[str, Any] = {
        "app": app, "scenario": scenario.name, "seed": scenario.seed,
        "baseline_sweeps": baseline.report.sweeps,
    }
    fm = scenario.fault_model()
    if scenario.kill_sweep is not None:
        result = _run_kill_cell(graph, design, scenario, baseline, cell,
                                device)
    else:
        result = _execute(graph, design, device, faults=fm, tracer=tracer)
        # Determinism: the same seeded scenario replays to the same sweep
        # count and the same retransmit tally, bit for bit.
        if fm is not None:
            replay = _execute(graph, design, device, faults=fm)
            assert replay.report.sweeps == result.report.sweeps, \
                f"{scenario.name}: replay diverged in sweeps"
            assert (replay.report.net_retransmit_bytes_total
                    == result.report.net_retransmit_bytes_total), \
                f"{scenario.name}: replay diverged in retransmits"
            assert bit_identical(replay.outputs, result.outputs), \
                f"{scenario.name}: replay diverged in outputs"
    assert bit_identical(result.outputs, baseline.outputs), \
        f"{scenario.name}: outputs diverged from the fault-free baseline"
    agree = result.report.agreement()
    assert all(agree.values()), \
        f"{scenario.name}: agreement broken: {agree}"
    cell.update({
        "sweeps": result.report.sweeps,
        "overhead_sweeps": result.report.sweeps - baseline.report.sweeps,
        "retransmit_bytes": result.report.net_retransmit_bytes_total,
        "goodput_hop_bytes": result.report.net_goodput_hop_bytes,
        "bit_identical": True,
        "agreement": agree,
        "ok": True,
    })
    return cell


_TENANT_COMPILED: Dict[str, Tuple[Any, Any, Any]] = {}


def compile_tenants(app: str = "stencil"):
    """(specs, graphs, designs) for two independently compiled 2-device
    tenants of ``app`` (the tenant smoke's
    :func:`~repro_torch.tenants.smoke.compile_tenants`, seeds 0 and 7) —
    memoized per process like :func:`compile_app`."""
    if app not in _TENANT_COMPILED:
        from ..tenants.smoke import STENCIL_SEEDS
        from ..tenants.smoke import compile_tenants as smoke_compile
        _TENANT_COMPILED[app] = smoke_compile(app, STENCIL_SEEDS)
    return _TENANT_COMPILED[app]


def run_tenant_cell(scenario: ChaosScenario, *, app: str = "stencil",
                    ndev: int = 4, device=None) -> Dict[str, Any]:
    """One **per-tenant** chaos cell: two weighted tenants co-run over one
    shared ``ndev``-ring under the scenario's link faults (plus a
    :class:`~repro_torch.tenants.DeviceKill` of tenant ``a``'s second device
    when ``scenario.kill_sweep`` is set).  Asserts the attribution
    tentpole on the faulted co-run:

    * the per-tenant cost ledger sums **bit-exactly** to the global
      transport / memory / critical-path / registry totals;
    * on kill cells over clean links, the victim's lineage carries every
      cancelled byte and restore sweep while its peer is charged exactly
      zero fault cost (``assert_peers_uncharged``);
    * surviving tenants stay bit-identical to their clean co-run.
    """
    from ..core import fpga_ring_cluster
    from ..exec import resolve_device
    from ..net import cluster_fabric
    from ..net.transport import NetConfig
    from ..obs import (Tracer, analyze, assert_ledger_consistent,
                       assert_peers_uncharged, build_ledger,
                       substrate_metrics)
    from ..tenants import DeviceKill, TenantServer, bit_identical
    from ..tenants.smoke import make_tenants
    device = resolve_device(device)
    specs, graphs, designs = compile_tenants(app)

    clean = TenantServer(cluster_fabric(fpga_ring_cluster(ndev)),
                         make_tenants(designs, specs), device=device).run()
    tracer = Tracer()
    server = TenantServer(cluster_fabric(fpga_ring_cluster(ndev)),
                          make_tenants(designs, specs),
                          net_config=NetConfig(faults=scenario.fault_model()),
                          tracer=tracer, device=device)
    faults = [] if scenario.kill_sweep is None else \
        [DeviceKill(device=2, sweep=scenario.kill_sweep)]
    out = server.run(faults=faults)
    crit = analyze(tracer, sweeps=out.sweeps)
    ledger = build_ledger(server, crit=crit)
    assert_ledger_consistent(ledger, server, crit=crit,
                             registry=substrate_metrics(server))
    by = ledger.by_lineage()
    cell: Dict[str, Any] = {
        "app": app, "scenario": scenario.name, "seed": scenario.seed,
        "kind": "tenant", "sweeps": out.sweeps,
        "clean_sweeps": clean.sweeps,
        "ledger": ledger.to_json(),
    }
    if faults:
        assert out.record("a").status == "killed", \
            f"{scenario.name}: kill at sweep {scenario.kill_sweep} missed"
        assert by["a"]["cancelled_bytes"] > 0
        assert by["a"]["restore_sweeps"] > 0
        if not scenario.lossy:
            # Clean links: the only fault cost is the kill, and it lands
            # on the victim's lineage alone.
            assert_peers_uncharged(ledger, ["a"])
        survivors = ["b"]
    else:
        survivors = ["a", "b"]
    for n in survivors:
        assert out.record(n).status == "done", f"tenant {n} never finished"
        assert bit_identical(out.record(n).result.outputs,
                             clean.record(n).result.outputs), \
            f"{scenario.name}: tenant {n} diverged from the clean co-run"
    cell["ok"] = True
    return cell


def run_matrix(apps: Sequence[str] = ("stencil", "cnn", "knn", "pagerank"),
               scenarios: Optional[Sequence[ChaosScenario]] = None, *,
               ndev: int = 4, verbose: bool = False, device=None
               ) -> Dict[str, Any]:
    """The full fault matrix: every scenario over every app.

    Returns the matrix record (the JSON artifact).  Raises on the first
    broken guarantee — a chaos matrix that "mostly passes" is a failure.
    """
    from ..exec import resolve_device
    device = resolve_device(device)
    scenarios = tuple(scenarios if scenarios is not None
                      else default_matrix())
    cells = []
    for app in apps:
        graph, design = compile_app(app, ndev)
        baseline = _execute(graph, design, device)
        for sc in scenarios:
            cell = run_scenario(app, sc, ndev=ndev, baseline=baseline,
                                device=device)
            cells.append(cell)
            if verbose:
                print(f"  [{app} × {sc.name}] sweeps {cell['sweeps']} "
                      f"(+{cell['overhead_sweeps']}), retransmit "
                      f"{cell['retransmit_bytes']}B"
                      + (f", restore +{cell['restore_extra_sweeps']}"
                         if "restore_extra_sweeps" in cell else ""))
    return {
        "format": "chaos-matrix/v1",
        "ndev": ndev,
        "apps": list(apps),
        "scenarios": [sc.name for sc in scenarios],
        "cells": cells,
        "ok": all(c["ok"] for c in cells),
    }
