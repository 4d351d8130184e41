"""Network-fabric smoke run: one app on a 2×2 mesh cluster.

Compiles one app (stencil by default) onto a 2×2 mesh cluster with an
explicit fabric (so the ``congestion_feedback`` pass runs), executes it
twice — through the fabric and on the ideal transfer path — and checks:

* the outputs are **bit-identical** between the two paths, and match the
  binding's single-device ``reference()`` within its atol;
* the fabric accounting conserves bytes (every submitted byte delivered;
  per-link totals sum exactly to the hop-weighted cut-set traffic);
* every ``agreement()`` value is true.

Writes the per-link utilization JSON::

    PYTHONPATH=src python -m repro_torch.net.smoke [--app stencil] \
        [--rows 2 --cols 2] [--device cpu] [--out results/...json] \
        [--trace results/net_trace_torch.json]

The app runs at its binder's default spec.  It runs on the CUDA card (the
hand-written kernels) unless ``--device cpu`` asks for the kernels' plain
versions.  ``--trace`` records the fabric run (not the ideal one) with a
:class:`~repro_torch.obs.trace.Tracer` and writes its Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="stencil",
                    choices=["stencil", "pagerank", "knn", "cnn"])
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--cols", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--out", default="results/net_smoke_torch.json")
    ap.add_argument("--trace", default=None,
                    help="write the fabric run's Chrome trace JSON here")
    args = ap.parse_args(argv)

    import torch

    from ..apps import APPS
    from ..compiler import CompileOptions, compile as tapa_compile
    from ..core import ALVEO_U55C, Cluster, Mesh2D
    from ..exec import bind_programs, execute
    from ..exec.programs import resolve_device
    from ..obs.trace import Tracer, write_chrome_trace
    from . import cluster_fabric

    ndev = args.rows * args.cols
    device = resolve_device(args.device)
    cluster = Cluster(ALVEO_U55C, Mesh2D(args.rows, args.cols))
    fabric = cluster_fabric(cluster)
    graph = APPS[args.app].build_graph(ndev)
    design = tapa_compile(graph, cluster, CompileOptions(
        balance_kind="LUT", balance_tol=0.8, exact_limit=1500,
        fabric=fabric,
        passes=("normalize_units", "partition", "congestion_feedback",
                "pipeline_interconnect", "schedule")))
    binding = bind_programs(graph, device=device)
    tracer = Tracer() if args.trace else None
    result = execute(design, binding, device=device, tracer=tracer)
    ideal = execute(design, bind_programs(graph, device=device),
                    device=device, fabric=None)

    got, got_ideal = result.outputs, ideal.outputs
    expected = binding.reference()
    if isinstance(got, tuple):           # knn returns (dists, idx)
        got, got_ideal, expected = got[0], got_ideal[0], expected[0]
    if not torch.equal(got, got_ideal):
        raise AssertionError("fabric path numerics diverged from the ideal "
                             "path")
    err = float((got - expected).abs().max())
    if not err <= binding.atol:
        raise AssertionError(f"numerics diverged: {err} > {binding.atol}")
    report = result.report
    agree = report.agreement()
    if not all(agree.values()):
        raise AssertionError(f"accounting mismatch: {agree}")

    cong = report.congestion
    print(f"[{graph.name}] mesh {args.rows}x{args.cols} on {device}, "
          f"{len(fabric.links)} links, parity err {err:.2e}, "
          f"agreement {agree}")
    print(f"link bytes {report.net_link_bytes:.0f} == "
          f"hop-weighted {report.net_hop_weighted_bytes} "
          f"(max util {cong.max_utilization:.3f}, "
          f"sweeps {report.sweeps} vs ideal {ideal.report.sweeps})")

    if tracer is not None:
        doc = write_chrome_trace(tracer, args.trace)
        print(f"wrote Chrome trace ({len(doc['traceEvents'])} events) "
              f"to {args.trace}")

    out = args.out
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "app": args.app,
            "mesh": [args.rows, args.cols],
            "device": str(device),
            "parity_max_err": err,
            "atol": binding.atol,
            "bit_identical": True,
            "agreement": agree,
            "sweeps": report.sweeps,
            "ideal_sweeps": ideal.report.sweeps,
            "fabric": fabric.describe(),
            "congestion": cong.summary(),
            "feedback": dict(
                design.pass_record("congestion_feedback").detail),
        }, f, indent=2, default=float)
        f.write("\n")
    print(f"NET_SMOKE_OK: wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
