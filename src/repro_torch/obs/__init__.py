"""`repro_torch.obs` — observability for the whole stack.

A copy of the JAX package's ``obs`` (framework-free: the standard library
only).  Six pieces, one thread-through:

* :mod:`repro_torch.obs.trace` — sweep-granular typed events from the
  executor, transport and memory layers, with a Chrome/Perfetto exporter
  (``to_chrome_trace``), a streaming JSONL writer (``write_jsonl`` —
  O(1) extra memory per event), and a zero-overhead disabled default
  (:data:`NULL_TRACER`);
* :mod:`repro_torch.obs.metrics` — the unified ``layer.object.metric``
  registry subsuming every scattered counter, with exact-consistency
  asserts against the legacy report fields (``report.metrics``);
* :mod:`repro_torch.obs.critpath` — post-hoc critical-path attribution
  decomposing the measured makespan into compute / network / memory /
  fault-recovery sweeps, and the predicted-vs-measured makespan table;
* :mod:`repro_torch.obs.attrib` — the exact per-tenant cost ledger (it
  folds a :class:`~repro_torch.tenants.TenantServer` run);
* :mod:`repro_torch.obs.slo` — online SLO monitoring inside a serve
  loop: windowed p50/p99 latency, goodput, and error-budget burn per
  tenant, with typed ``slo_alert`` events emitted into the same trace;
* :mod:`repro_torch.obs.diff` — run-to-run metric regression diffing
  against a committed baseline with per-metric tolerances
  (``python -m repro_torch.obs.diff``).

``python -m repro_torch.obs.smoke`` runs the four paper apps traced and
untraced through a contended ring and asserts the contract.

Quickstart::

    from repro_torch.obs import Tracer, analyze, write_chrome_trace
    tr = Tracer()
    result = execute(design, inputs=..., tracer=tr)
    crit = analyze(tr, sweeps=result.report.sweeps)
    print(crit.decomposition())            # exact sweep buckets
    write_chrome_trace(tr, "run.json")     # open in chrome://tracing
"""
from .attrib import (CostLedger, LedgerRow, assert_ledger_consistent,
                     assert_peers_uncharged, build_ledger, lineage_root,
                     substrate_metrics)
from .critpath import (CritPath, TaskAttribution, analyze, format_table,
                       makespan_row)
from .metrics import (MetricsRegistry, assert_registry_consistent,
                      assert_trace_report_consistent, from_report,
                      from_trace, tenant_metrics)
from .slo import SLOMonitor
from .trace import (EVENT_FIELDS, FAULT_KINDS, NULL_TRACER, NullTracer,
                    Tracer, coerce_tracer, read_jsonl, to_chrome_trace,
                    to_jsonl, validate_chrome_trace, write_chrome_trace,
                    write_jsonl)

# The diff names load on first use, so ``python -m repro_torch.obs.diff``
# runs a module the package has not imported yet.
_DIFF_NAMES = ("MetricDelta", "RegressionDiff", "diff_against_baseline",
               "diff_registries", "make_baseline")


def __getattr__(name):
    if name in _DIFF_NAMES:
        from . import diff
        return getattr(diff, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CostLedger", "LedgerRow", "assert_ledger_consistent",
    "assert_peers_uncharged", "build_ledger", "lineage_root",
    "substrate_metrics",
    "CritPath", "TaskAttribution", "analyze", "format_table",
    "makespan_row",
    "MetricDelta", "RegressionDiff", "diff_against_baseline",
    "diff_registries", "make_baseline",
    "MetricsRegistry", "assert_registry_consistent",
    "assert_trace_report_consistent", "from_report", "from_trace",
    "tenant_metrics",
    "SLOMonitor",
    "EVENT_FIELDS", "FAULT_KINDS", "NULL_TRACER", "NullTracer", "Tracer",
    "coerce_tracer", "read_jsonl", "to_chrome_trace", "to_jsonl",
    "validate_chrome_trace", "write_chrome_trace", "write_jsonl",
]
