"""Multi-tenant serving smoke run: 2 tenants, 1 shared ring, 1 kill.

Two independently compiled stencil designs are admitted as tenants onto ONE
shared 4-device ring fabric (the paper's testbed shape) with weighted-fair
link arbitration, placed so their routes genuinely contend for a link:

* tenant ``a`` (weight 2) maps its 2 logical devices to fabric ``[0, 2]``
  (route 0→1→2 under deterministic BFS);
* tenant ``b`` (weight 1) maps to fabric ``[0, 1]`` (route 0→1) — both
  tenants cross link 0→1.

The run asserts end to end:

* **isolation** — each tenant's outputs are bit-identical (bit patterns,
  :func:`~repro_torch.exec.bit_identical`) to its solo run on the ideal
  path (sharing the substrate never touches payloads);
* **conservation** — Σ per-tenant link bytes == total link bytes, exact
  integers per link (checked inside ``TenantServer.conservation``);
* **fault drain** — a second serve kills fabric device 2 mid-flight:
  tenant ``a`` is torn down (its in-network flits cancelled, credits
  released), re-compiled onto its surviving device and re-admitted under a
  fresh flow id, and finishes there within the binding's ``atol`` of
  ``reference()``; tenant ``b`` is bit-identical to its solo run anyway;
* **weighted shares** — the fluid-model oversubscription check
  (:func:`repro_torch.tenants.isolation_check`) holds at the capacity
  measured from the co-run;
* **attribution** — the per-tenant cost ledger
  (:func:`repro_torch.obs.build_ledger`) sums bit-exactly to the global
  counters on both runs, the kill charges tenant ``a``'s lineage
  (cancelled bytes + restore sweeps) while its peer pays exactly zero,
  and an online :class:`repro_torch.obs.SLOMonitor` rides the serve loop;
* **shared banks** — the same co-run and kill with two ``axpy`` tenants
  over one shared :class:`~repro_torch.mem.banks.MemorySystem`: outputs
  bit-identical to the solo runs, per-tenant bank bytes conserved.

Writes the per-tenant latency/goodput JSON::

    PYTHONPATH=src python -m repro_torch.tenants.smoke [--device cpu] \
        [--kill-sweep 2] [--out results/serve_smoke_torch.json] \
        [--trace results/serve_trace_torch.json]

The tenants run at their binders' default specs, on the CUDA card (the
hand-written kernels) unless ``--device cpu`` asks for the kernels' plain
versions.  :func:`stencil_serves` and :func:`bank_serves` return the runs'
integer counters, so a caller can hold one device's run to another's.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

#: Each tenant compiles independently on a private 2-device ring with
#: these options; admission onto the shared 4-ring is purely a device map.
TENANT_OPTIONS = dict(balance_kind="LUT", balance_tol=0.8, exact_limit=1500,
                      floorplan_devices=(0,))
#: name -> (fabric placement, SLO weight): both routes cross link 0→1.
PLACEMENT = {"a": ([0, 2], 2.0), "b": ([0, 1], 1.0)}
STENCIL_SEEDS = {"a": 0, "b": 7}
AXPY_SEEDS = {"a": 0, "b": 1}
SHARED_DEVICES = 4


class ServeSmokeFailure(AssertionError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ServeSmokeFailure(what)


def compile_tenants(app: str, seeds: Dict[str, int],
                    graph_args: Sequence[int] = (2,),
                    spec: Optional[Dict[str, Any]] = None):
    """(specs, graphs, designs): one design of ``app`` per tenant, each
    compiled on its own ``fpga_ring_cluster(graph_args[0])``; ``spec`` is
    the binder spec every tenant shares, its seed the tenant's own."""
    from ..apps import APPS
    from ..compiler import CompileOptions, compile as tapa_compile
    from ..core import fpga_ring_cluster
    specs = {n: dict(spec or {}, seed=s) for n, s in seeds.items()}
    graphs = {n: APPS[app].build_graph(*graph_args) for n in specs}
    designs = {n: tapa_compile(graphs[n], fpga_ring_cluster(graph_args[0]),
                               CompileOptions(**TENANT_OPTIONS))
               for n in specs}
    return specs, graphs, designs


def make_tenants(designs, specs, **fields):
    """The two tenants at :data:`PLACEMENT`; ``fields`` maps a tenant name
    to extra :class:`~repro_torch.tenants.Tenant` fields (e.g. a
    ``checkpoint_dir``)."""
    from . import SLO, Tenant
    return [Tenant(n, designs[n], device_map=list(PLACEMENT[n][0]),
                   slo=SLO(1e-3, weight=PLACEMENT[n][1]), inputs=specs[n],
                   **fields.get(n, {}))
            for n in PLACEMENT]


def shared_fabric():
    from ..core import fpga_ring_cluster
    from ..net import cluster_fabric
    return cluster_fabric(fpga_ring_cluster(SHARED_DEVICES))


def solo_runs(graphs, designs, specs, device) -> Dict[str, Any]:
    """Each tenant alone on the ideal path: the bit-identity references."""
    from ..exec import bind_programs, execute
    return {n: execute(designs[n], bind_programs(graphs[n], specs[n],
                                                 device=device),
                       device=device, fabric=None, mem=None)
            for n in specs}


def serve_counters(server, out) -> Dict[str, Any]:
    """The integer record of one serve: what a second device's run of the
    same tenants must reproduce exactly."""
    recs = []
    for r in out.records:
        row = {"name": r.name, "flow": r.flow, "status": r.status,
               "device_map": list(r.tenant.device_map),
               "start_sweep": r.start_sweep, "end_sweep": r.end_sweep,
               "killed_at": r.killed_at, "recovered_as": r.recovered_as,
               "recovered_via": r.recovered_via}
        if r.result is not None:
            rep = r.result.report
            row["sweeps"] = rep.sweeps
            row["congestion_kind"] = rep.congestion.kind
            row["link_bytes"] = sum(int(l.bytes)
                                    for l in rep.congestion.links)
            if rep.mem_contention is not None:
                row["bank_bytes"] = sum(int(b.bytes)
                                        for b in rep.mem_contention.banks)
        recs.append(row)
    return {"sweeps": out.sweeps,
            "flow_bytes": [{str(f): int(b) for f, b in
                            sorted(c.flow_bytes.items())}
                           for c in server.transport.counters],
            "conservation": out.conservation,
            "records": recs}


def _launched(fn):
    """(fn(), kernel launches during it): counts zeroed just before, read
    just after (all zero on the CPU, which launches no kernel)."""
    from ..kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    res = fn()
    return res, launch_counts()


def _assert_ledger(server, out, tracer, victims=()):
    from ..obs import (analyze, assert_ledger_consistent,
                       assert_peers_uncharged, build_ledger,
                       substrate_metrics)
    crit = analyze(tracer, sweeps=out.sweeps) if tracer is not None \
        else None
    ledger = build_ledger(server, crit=crit)
    assert_ledger_consistent(ledger, server, crit=crit,
                             registry=substrate_metrics(server))
    if victims:
        assert_peers_uncharged(ledger, list(victims))
    return ledger


def _max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def stencil_serves(device, *, kill_sweep: int = 2,
                   trace_path: Optional[str] = None) -> Dict[str, Any]:
    """The clean co-run and the kill run of the two stencil tenants on
    ``device``; raises on any broken guarantee.  Returns the record:
    ``counters`` (integer, device-independent), ``launches`` and the rest
    of the smoke's JSON."""
    from ..exec import bind_programs, bit_identical
    from ..net.transport import NetConfig
    from ..obs import SLOMonitor, Tracer
    from ..obs.trace import write_chrome_trace
    from . import DeviceKill, TenantServer, isolation_check

    specs, graphs, designs = compile_tenants("stencil", STENCIL_SEEDS)
    solo = solo_runs(graphs, designs, specs, device)
    fabric = shared_fabric()
    net_config = NetConfig()

    # -- serve 1: clean co-run over the shared fabric ------------------------
    # Always traced: the cost ledger and the online SLO monitor both read
    # the trace (the Chrome export is only written when asked for).
    tracer = Tracer()
    monitor = SLOMonitor(window=32)
    server = TenantServer(fabric, make_tenants(designs, specs),
                          net_config=net_config, tracer=tracer,
                          device=device)
    out, launches = _launched(lambda: server.run(monitor=monitor))
    for n in specs:
        rec = out.record(n)
        _check(rec.status == "done", f"tenant {n}: {rec.status}")
        _check(bit_identical(rec.result.outputs, solo[n].outputs),
               f"tenant {n}: co-run outputs diverged from the solo run")
        agree = rec.result.report.agreement()
        _check(all(agree.values()), f"tenant {n} accounting: {agree}")
        _check(rec.result.report.congestion.kind.endswith(f"flow{rec.flow}"),
               f"tenant {n}: report not scoped to its flow")
    contended = [c for c in server.transport.counters
                 if len(c.flow_bytes) >= 2]
    _check(bool(contended), "placement bug: no link carried both tenants")
    conservation = out.conservation
    ledger = _assert_ledger(server, out, tracer)
    slo_summary = monitor.summary(out.sweeps)

    # -- serve 2: kill tenant a's device mid-flight, re-admit ----------------
    ftracer = Tracer()
    fserver = TenantServer(fabric, make_tenants(designs, specs),
                           net_config=net_config, tracer=ftracer,
                           device=device)
    fout, flaunches = _launched(lambda: fserver.run(
        faults=[DeviceKill(device=2, sweep=kill_sweep)]))
    killed = fout.record("a")
    _check(killed.status == "killed" and killed.killed_at == kill_sweep,
           f"tenant a: {killed.status} at {killed.killed_at}")
    _check(killed.recovered_as == "a+recovered", "tenant a not recovered")
    recovered = fout.record("a+recovered")
    _check(recovered.status == "done",
           f"recovered tenant never finished: {recovered.status}")
    peer = fout.record("b")
    _check(peer.status == "done"
           and bit_identical(peer.result.outputs, solo["b"].outputs),
           "fault drain perturbed the surviving tenant's outputs")
    # The recovered incarnation computes the same function on one device.
    binding_a = bind_programs(graphs["a"], specs["a"], device=device)
    err = _max_abs(recovered.result.outputs, binding_a.reference())
    _check(err <= binding_a.atol, f"recovered numerics diverged: {err}")
    fledger = _assert_ledger(fserver, fout, ftracer, victims=["a"])
    fby = fledger.by_lineage()
    _check(fby["a"]["cancelled_bytes"] > 0, "kill cancelled no bytes")
    _check(fby["a"]["restore_sweeps"] > 0, "kill charged no restore sweeps")

    # -- weighted-share isolation at the measured capacity -------------------
    sweep_time = net_config.sweep_time_s
    duration_s = out.sweeps * sweep_time
    capacity = conservation["total_link_bytes"] / duration_s
    iso = isolation_check(capacity)
    _check(iso["isolated"],
           f"victim held {iso['victim_share_frac']:.2f} of fair share")

    per_tenant = {}
    for rec in out.records:
        link_bytes = conservation["per_tenant_link_bytes"][rec.name]
        per_tenant[rec.name] = {
            "weight": rec.tenant.slo.weight,
            "latency_sweeps": rec.end_sweep - rec.start_sweep,
            "latency_s": out.latency_s(rec.name, sweep_time),
            "link_bytes": link_bytes,
            "goodput_Bps": link_bytes / duration_s,
        }
    doc = None
    if trace_path:
        doc = write_chrome_trace(tracer, trace_path)
    return {
        "counters": {"corun": serve_counters(server, out),
                     "kill": serve_counters(fserver, fout),
                     "ledger": ledger.to_json(),
                     "kill_ledger": fledger.to_json()},
        "launches": {"corun": launches, "kill": flaunches},
        "wall_time_s": {"corun": out.wall_time_s, "kill": fout.wall_time_s},
        "contended_links": len(contended),
        "tenants": per_tenant,
        "recovered_parity_err": err,
        "kill_charge": {"cancelled_bytes": fby["a"]["cancelled_bytes"],
                        "restore_sweeps": fby["a"]["restore_sweeps"]},
        "slo": slo_summary,
        "slo_alerts": len(monitor.alerts),
        "isolation": iso,
        "trace_events": None if doc is None else len(doc["traceEvents"]),
    }


def bank_serves(device, *, kill_sweep: int = 2) -> Dict[str, Any]:
    """The clean co-run and the kill run of two ``axpy`` tenants over one
    shared bank model (``MemConfig()``) on ``device``; raises on any broken
    guarantee.  Returns ``counters``, ``launches`` and wall times."""
    from ..exec import bind_programs, bit_identical
    from ..mem import MemConfig
    from . import DeviceKill, TenantServer

    specs, graphs, designs = compile_tenants("axpy", AXPY_SEEDS)
    solo = solo_runs(graphs, designs, specs, device)
    counters, launched, wall = {}, {}, {}
    for name, faults in (("corun", []),
                         ("kill", [DeviceKill(device=2, sweep=kill_sweep)])):
        server = TenantServer(shared_fabric(), make_tenants(designs, specs),
                              mem_config=MemConfig(), device=device)
        out, launches = _launched(lambda: server.run(faults=faults))
        cons = out.conservation
        for rec in out.records:
            if rec.status != "done":
                continue
            bank = sum(int(b.bytes)
                       for b in rec.result.report.mem_contention.banks)
            _check(bank == cons["per_tenant_bank_bytes"][rec.name],
                   f"{name}: tenant {rec.name} bank bytes {bank} != "
                   f"{cons['per_tenant_bank_bytes'][rec.name]}")
            agree = rec.result.report.agreement()
            _check(all(agree.values()), f"{name} {rec.name}: {agree}")
            if rec.recovered_via is None:
                _check(bit_identical(rec.result.outputs,
                                     solo[rec.name].outputs),
                       f"{name}: tenant {rec.name} diverged from solo")
            else:
                ref = bind_programs(graphs["a"], specs["a"],
                                    device=device).reference()
                _check(bit_identical(rec.result.outputs, ref),
                       f"{name}: recovered tenant differs from reference()")
        _check(cons["total_bank_bytes"]
               == sum(cons["per_tenant_bank_bytes"].values()),
               f"{name}: bank bytes not conserved per tenant")
        if faults:
            _check(out.record("a").status == "killed"
                   and out.record("a+recovered").status == "done",
                   "axpy kill: tenant a not killed and recovered")
        ledger = _assert_ledger(server, out, None,
                                victims=["a"] if faults else ())
        counters[name] = serve_counters(server, out)
        counters[f"{name}_ledger"] = ledger.to_json()
        launched[name] = launches
        wall[name] = out.wall_time_s
    return {"counters": counters, "launches": launched, "wall_time_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tenants.smoke")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--kill-sweep", type=int, default=2)
    ap.add_argument("--out", default="results/serve_smoke_torch.json")
    ap.add_argument("--trace", default=None,
                    help="write the co-run's Chrome trace JSON here")
    args = ap.parse_args(argv)

    from ..exec import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}")
    st = stencil_serves(device, kill_sweep=args.kill_sweep,
                        trace_path=args.trace)
    banks = bank_serves(device, kill_sweep=args.kill_sweep)
    corun, kill = st["counters"]["corun"], st["counters"]["kill"]
    print(f"co-run: {corun['sweeps']} sweeps, conservation exact, "
          f"{st['contended_links']} contended links, victim share "
          f"{st['isolation']['victim_share_frac']:.2f}")
    for n, row in st["tenants"].items():
        print(f"  tenant {n}: latency {row['latency_sweeps']} sweeps "
              f"({row['latency_s']:.2e} s), goodput "
              f"{row['goodput_Bps']:.3e} B/s")
    print(f"fault run: killed at sweep {args.kill_sweep}, recovered as "
          f"a+recovered in {kill['sweeps']} sweeps, parity "
          f"{st['recovered_parity_err']:.1e}")
    print(f"attrib: ledger exact on both runs; kill charged a lineage "
          f"{st['kill_charge']['cancelled_bytes']} cancelled bytes + "
          f"{st['kill_charge']['restore_sweeps']} restore sweeps, peer b "
          f"zero")
    print(f"slo: {st['slo_alerts']} alert(s) over the clean co-run")
    bc = banks["counters"]
    print(f"shared banks: axpy co-run {bc['corun']['sweeps']} sweeps, "
          f"bank bytes "
          f"{bc['corun']['conservation']['per_tenant_bank_bytes']}; kill "
          f"run {bc['kill']['sweeps']} sweeps")
    if args.trace:
        print(f"wrote Chrome trace ({st['trace_events']} events) to "
              f"{args.trace}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"format": "serve-smoke/v1", "device": str(device),
                   "fabric": shared_fabric().describe(),
                   "kill_sweep": args.kill_sweep,
                   "stencil": st, "banks": banks},
                  f, indent=2, default=float)
        f.write("\n")
    print(f"SERVE_SMOKE_OK: wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
