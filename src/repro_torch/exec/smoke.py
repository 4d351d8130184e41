"""Executor smoke run: one app on a 4-FPGA ring, end to end.

Compiles one app (stencil by default) onto an ``--ndev``-FPGA ring with
the executor smoke's options, executes it, and asserts numerics parity
against the binding's single-device ``reference()``, every measured-vs-
predicted ``agreement()`` value, and no starvation; writes the
``ExecutionReport`` summary as JSON::

    PYTHONPATH=src python -m repro_torch.exec.smoke [--app stencil] \
        [--ndev 4] [--device cpu] [--out results/exec_smoke_torch.json] \
        [--trace results/exec_trace_torch.json]

The app runs at its binder's default spec.  It runs on the CUDA card (the
hand-written kernels) unless ``--device cpu`` asks for the kernels' plain
versions.  ``--trace`` records the run with a
:class:`~repro_torch.obs.trace.Tracer` and writes its Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.exec.smoke")
    ap.add_argument("--app", default="stencil",
                    choices=["stencil", "pagerank", "knn", "cnn"])
    ap.add_argument("--ndev", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--out", default="results/exec_smoke_torch.json")
    ap.add_argument("--trace", default=None,
                    help="write the run's Chrome trace JSON here")
    args = ap.parse_args(argv)

    from ..apps import APPS
    from ..compiler import CompileOptions, compile as tapa_compile
    from ..core import fpga_ring_cluster
    from ..obs.trace import Tracer, write_chrome_trace
    from . import bind_programs, execute
    from .programs import resolve_device

    device = resolve_device(args.device)
    print(f"device: {device}")
    graph = APPS[args.app].build_graph(args.ndev)
    design = tapa_compile(graph, fpga_ring_cluster(args.ndev),
                          CompileOptions(balance_kind="LUT",
                                         balance_tol=0.8,
                                         floorplan_devices=(0,),
                                         exact_limit=1500))
    # One binding for both the run and the reference (same inputs).
    binding = bind_programs(graph, device=device)
    tracer = Tracer() if args.trace else None
    result = execute(design, binding, device=device, tracer=tracer)

    expected = binding.reference()
    got = result.outputs
    if isinstance(got, tuple):           # knn returns (dists, idx)
        got, expected = got[0], expected[0]
    err = float((got - expected).abs().max())
    agree = result.report.agreement()
    print(f"[{graph.name}] parity err {err:.2e} (atol {binding.atol}), "
          f"agreement {agree}, sweeps {result.report.sweeps}, "
          f"measured inter-device bytes "
          f"{result.report.measured_inter_bytes}")
    if not err <= binding.atol:
        raise AssertionError(f"numerics diverged: {err}")
    if not all(agree.values()):
        raise AssertionError(f"comm accounting mismatch: {agree}")
    if result.report.starvation_events:
        raise AssertionError(
            f"unexpected starvation: {result.report.starvation_events}")

    if tracer is not None:
        doc = write_chrome_trace(tracer, args.trace)
        print(f"wrote Chrome trace ({len(doc['traceEvents'])} events) "
              f"to {args.trace}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": str(device), "parity_max_err": err,
                   "atol": binding.atol,
                   "report": result.report.summary()},
                  f, indent=2, default=float)
        f.write("\n")
    print(f"EXEC_SMOKE_OK: wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
