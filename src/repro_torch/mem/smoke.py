"""HBM bank-model smoke run: one memory-bound app through the bank model.

Compiles one of the memory-bound apps (axpy by default) onto a ring
cluster with an explicit :class:`MemConfig` (so the ``memory_feedback``
pass runs), executes it twice — through the bank model and on the ideal
memory path — and checks:

* the outputs are **bit-identical** between the two paths AND to the
  binding's monolithic ``reference()`` (the apps' atol is 0.0 — exact);
* the bank accounting conserves bytes (every issued request consumed;
  Σ per-bank bytes == Σ memory-channel delivered bytes exactly);
* the measured per-bank utilizations are ≤ 1 (achieved, not offered).

Writes the per-bank utilization JSON::

    PYTHONPATH=src python -m repro_torch.mem.smoke [--app axpy] [--ndev 4] \
        [--device cpu] [--out results/...json] \
        [--trace results/mem_trace_torch.json]

The app runs at its binder's default spec (16 rows of 128 lanes).

It runs on the CUDA card (the hand-written kernels) unless ``--device cpu``
asks for the kernels' plain versions.  ``--trace`` records the
bank-modelled run (not the ideal one) with a
:class:`~repro_torch.obs.trace.Tracer` and writes its Chrome trace.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="axpy",
                    choices=["axpy", "dot", "gemv", "axpydot"])
    ap.add_argument("--ndev", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--out", default="results/mem_smoke_torch.json")
    ap.add_argument("--trace", default=None,
                    help="write the bank-modeled run's Chrome trace here")
    args = ap.parse_args(argv)

    import torch

    from ..apps import APPS
    from ..compiler import CompileOptions, compile as tapa_compile
    from ..core import fpga_ring_cluster
    from ..exec import bind_programs, execute
    from ..exec.programs import resolve_device
    from ..obs.trace import Tracer, write_chrome_trace
    from .banks import MemConfig

    app, ndev = args.app, args.ndev
    device = resolve_device(args.device)
    cluster = fpga_ring_cluster(ndev)
    # Small banks so the small shapes genuinely queue (several sweeps per
    # request) without slowing the run.
    config = MemConfig(banks_per_device=4, bank_bandwidth_Bps=2e9,
                       credits=4, burst_bytes=512)
    graph = APPS[app].build_graph(ndev)
    design = tapa_compile(graph, cluster, CompileOptions(
        balance_kind="LUT", balance_tol=0.8, exact_limit=1500,
        mem=config,
        passes=("normalize_units", "partition", "memory_feedback",
                "pipeline_interconnect", "schedule")))
    binding = bind_programs(graph, device=device)
    tracer = Tracer() if args.trace else None
    result = execute(design, binding, device=device, tracer=tracer)
    ideal = execute(design, bind_programs(graph, device=device),
                    device=device, mem=None)

    expected = binding.reference()
    if not torch.equal(result.outputs, ideal.outputs):
        raise AssertionError("bank-modeled numerics diverged from the ideal "
                             "path")
    if not torch.equal(result.outputs, expected):
        raise AssertionError("numerics diverged from the monolithic "
                             "reference (bit-tight contract)")
    report = result.report
    agree = report.agreement()
    if not all(agree.values()):
        raise AssertionError(f"accounting mismatch: {agree}")
    mem = report.mem_contention
    if mem is None or mem.max_utilization > 1.0 + 1e-12:
        raise AssertionError("measured bank utilization above 1")

    print(f"[{graph.name}] ring {ndev} on {device}, "
          f"{len(report.mem_channels)} memory channels, agreement {agree}")
    print(f"bank bytes {report.mem_bank_bytes:.0f} == "
          f"delivered {report.mem_delivered_bytes} "
          f"(max measured util {mem.max_utilization:.3f}, "
          f"mem waits {sum(report.task_mem_waits.values())}, "
          f"sweeps {report.sweeps} vs ideal {ideal.report.sweeps})")

    if tracer is not None:
        doc = write_chrome_trace(tracer, args.trace)
        print(f"wrote Chrome trace ({len(doc['traceEvents'])} events) "
              f"to {args.trace}")

    record = {
        "app": app,
        "ndev": ndev,
        "device": str(device),
        "agreement": agree,
        "bit_identical": True,
        "sweeps": report.sweeps,
        "ideal_sweeps": ideal.report.sweeps,
        "mem_waits": dict(report.task_mem_waits),
        "config": {"banks_per_device": config.banks_per_device,
                   "bank_bandwidth_Bps": config.bank_bandwidth_Bps,
                   "credits": config.credits,
                   "burst_bytes": config.burst_bytes},
        "bank_map": dict(design.bank_map or {}),
        "measured": mem.summary(),
        "projected": design.mem_contention.summary(),
        "feedback": dict(design.pass_record("memory_feedback").detail),
    }
    out = args.out
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2, default=float)
        f.write("\n")
    print(f"MEM_SMOKE_OK: wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
