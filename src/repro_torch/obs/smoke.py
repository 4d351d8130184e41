"""Observability smoke run: trace, metrics, and critpath end to end.

For each paper app compiled onto a contended ``--ndev``-FPGA ring (real
fabric + congestion_feedback, so the network transport genuinely carries
the traffic), runs the design twice — once untraced (``NULL_TRACER``) and
once recording — and asserts the observability contract:

* **transparency** — the traced run gives the untraced run's outputs bit
  for bit (:func:`~repro_torch.exec.bit_identical`: bit patterns, so
  -0.0 differs from +0.0), with identical sweep counts and identical
  report counters (the tracer observes, never perturbs);
* **byte agreement** — summed trace-event bytes equal the per-link goodput
  and per-bank counters exactly (integers, no tolerance), and the
  ``MetricsRegistry`` view reconciles with every legacy report field;
* **attribution** — the critical-path decomposition of every app sums to
  the measured makespan exactly, and the predicted-vs-measured table
  prints the §5 schedule error as a number.

With ``--metrics`` it also writes an ``obs-metrics/v1`` document — one
``MetricsRegistry.to_json()`` per app — the candidate side of the
regression gate (``python -m repro_torch.obs.diff`` diffs it against the
committed ``results/obs_baseline.json``)::

    PYTHONPATH=src python -m repro_torch.obs.smoke [--ndev 4] \
        [--device cpu] [--out results/obs_smoke_torch.json] \
        [--trace results/obs_trace_torch.json] \
        [--metrics results/obs_metrics_torch.json]

The apps run at their binders' default specs.  They run on the CUDA card
(the hand-written kernels) unless ``--device cpu`` asks for the kernels'
plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

APPS_UNDER_TEST = ("stencil", "cnn", "knn", "pagerank")

#: The ndev-4 partitions ``results/obs_baseline.json`` was taken at, for
#: the two apps the port gates against that file.  The partition MILP has
#: tied optima, and HiGHS releases break the tie differently: scipy 1.17's
#: gives these, scipy 1.18's another assignment of the same comm cost for
#: pagerank (and for cnn and knn), and every counter of the baseline
#: follows the partition.  ``compile_app(app, 4, pins=BASELINE_PINS[app])``
#: reproduces the baseline's design whatever the host's solver.
BASELINE_PINS = {
    "stencil": {"stage0": 2, "stage1": 1, "stage2": 0, "stage3": 3},
    "pagerank": {"router": 2, "accum": 2,
                 **{f"pe{i}": d for i, d in enumerate(
                     (2, 1, 3, 3, 1, 2, 2, 0, 1, 2, 1, 2, 1, 2, 3, 1))}},
}


class ObsSmokeFailure(AssertionError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ObsSmokeFailure(what)


def compile_app(app: str, ndev: int, pins=None):
    """(graph, design): ``app`` on an ``ndev``-FPGA ring with the ring's
    fabric, so ``congestion_feedback`` runs.  ``pins`` (task → device)
    fixes the partition, as ``CompileOptions.pins``."""
    from ..apps import APPS
    from ..compiler import CompileOptions, compile as tapa_compile
    from ..core import fpga_ring_cluster
    from ..net import cluster_fabric
    cluster = fpga_ring_cluster(ndev)
    graph = APPS[app].build_graph(ndev)
    design = tapa_compile(graph, cluster, CompileOptions(
        balance_kind="LUT", balance_tol=0.8, exact_limit=1500,
        pins=pins, fabric=cluster_fabric(cluster),
        passes=("normalize_units", "partition", "congestion_feedback",
                "pipeline_interconnect", "schedule")))
    return graph, design


def counters(report) -> Dict[str, Any]:
    """Every measured counter the tracer must not perturb."""
    return {
        "sweeps": report.sweeps,
        "congestion_waits": dict(report.task_congestion_waits),
        "mem_waits": dict(report.task_mem_waits),
        "device_fired": dict(report.device_fired),
        "retransmit_bytes": report.net_retransmit_bytes_total,
        "link_bytes": ([int(l.bytes) for l in report.congestion.links]
                       if report.congestion is not None else []),
        "channel_bytes": [c.measured_bytes for c in report.channels],
    }


def check_app(app: str, graph, design, device) -> Dict[str, Any]:
    """Run ``design`` untraced, then traced, on ``device`` and assert the
    contract.  Returns both results, the tracer, the registry, the
    critical path and the makespan-table row."""
    from ..exec import bind_programs, bit_identical, execute
    from .critpath import analyze, makespan_row
    from .metrics import (assert_registry_consistent,
                          assert_trace_report_consistent, from_report)
    from .trace import Tracer

    base = execute(design, bind_programs(graph, device=device),
                   device=device)
    tracer = Tracer()
    res = execute(design, bind_programs(graph, device=device),
                  device=device, tracer=tracer)

    # Transparency: identical bits and identical counters.
    _check(bit_identical(base.outputs, res.outputs),
           f"{app}: tracer perturbed the outputs")
    _check(counters(base.report) == counters(res.report),
           f"{app}: tracer perturbed the report counters")
    _check(res.report.trace is tracer and base.report.trace is None,
           f"{app}: the report does not carry its trace")

    # Byte agreement: trace events == report counters, exactly.
    assert_trace_report_consistent(tracer, res.report)
    reg = from_report(res.report)
    assert_registry_consistent(reg, res.report)

    # Attribution: the critical task's buckets sum to the makespan.
    crit = analyze(tracer, sweeps=res.report.sweeps)
    dec = crit.decomposition()
    _check(sum(v for k, v in dec.items() if k not in ("task", "sweeps"))
           == res.report.sweeps,
           f"{app}: critical path {dec} does not sum to "
           f"{res.report.sweeps} sweeps")
    row = makespan_row(app, design, res.report, crit)
    return {"base": base, "result": res, "tracer": tracer, "registry": reg,
            "critpath": crit, "row": row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.smoke")
    ap.add_argument("--ndev", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--out", default="results/obs_smoke_torch.json")
    ap.add_argument("--trace", default=None,
                    help="write the stencil run's Chrome trace JSON here")
    ap.add_argument("--metrics", default=None,
                    help="write the per-app obs-metrics/v1 registry "
                         "document here (the diff-gate candidate)")
    args = ap.parse_args(argv)

    from ..exec.programs import resolve_device
    from .critpath import format_table
    from .diff import METRICS_FORMAT
    from .trace import write_chrome_trace

    device = resolve_device(args.device)
    rows = []
    app_records = {}
    app_registries = {}
    stencil_tracer = None
    for app in APPS_UNDER_TEST:
        graph, design = compile_app(app, args.ndev)
        run = check_app(app, graph, design, device)
        tracer, res, crit = run["tracer"], run["result"], run["critpath"]
        rows.append(run["row"])
        app_registries[app] = run["registry"]
        app_records[app] = {
            "events": len(tracer),
            "sweeps": res.report.sweeps,
            "critpath": crit.to_json(),
        }
        if app == "stencil":
            stencil_tracer = tracer
        print(f"[{app}] {len(tracer)} events over {res.report.sweeps} "
              f"sweeps; critical task {crit.critical().task}; "
              f"trace/report byte agreement exact")

    # The contended ring genuinely exercised the network path.
    _check(any(r["network"] + r["compute"] > 0 for r in rows),
           "no app spent a sweep computing or on the network")
    _check(sum(a["events"] for a in app_records.values()) > 0,
           "no trace events were recorded")

    print()
    print(format_table(rows))

    if args.trace:
        doc = write_chrome_trace(stencil_tracer, args.trace)
        print(f"wrote Chrome trace ({len(doc['traceEvents'])} events) "
              f"to {args.trace}")

    if args.metrics:
        os.makedirs(os.path.dirname(args.metrics) or ".", exist_ok=True)
        with open(args.metrics, "w") as f:
            json.dump({"format": METRICS_FORMAT, "ndev": args.ndev,
                       "apps": {a: r.to_json()
                                for a, r in app_registries.items()}},
                      f, indent=2, default=float)
            f.write("\n")
        print(f"wrote metrics document to {args.metrics}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"format": "obs-smoke/v1", "ndev": args.ndev,
                   "device": str(device), "rows": rows,
                   "apps": app_records},
                  f, indent=2, default=float)
        f.write("\n")
    print(f"OBS_SMOKE_OK: wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
