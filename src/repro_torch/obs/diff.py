"""Run-to-run metric regression diffing — the drift gate over registries.

Two :class:`~repro_torch.obs.metrics.MetricsRegistry` snapshots (live objects
or their ``to_json()`` documents) are compared series-by-series: every
``(metric, labels)`` pair present in the baseline must appear in the
candidate within its **relative tolerance** — tolerance 0 (the default)
means integer/float equality, which is the right default here because
almost every metric this repo records is a deterministic integer
(conservation-checked byte and sweep counters).  Wall-clock gauges and
other nondeterministic series are *ignored* by name, not tolerated into
meaninglessness.

Tolerances travel **with the baseline file**, not the caller: a committed
``results/obs_baseline.json`` says which of its metrics may drift and by
how much, so the gate (``python -m repro_torch.obs.diff``) has no magic
numbers of its own and a PR that legitimately shifts a metric updates the
baseline (and its tolerance) in the same diff a reviewer sees.

Baseline document format (``obs-baseline/v1``)::

    {"format": "obs-baseline/v1",
     "default_rel_tol": 0.0,
     "tolerances": {"net.link.utilization": 0.05},   # per-metric rel tol
     "ignore": ["exec.device.busy_s"],               # nondeterministic
     "apps": {"stencil": { ...registry.to_json()... }, ...}}

A flat single-registry baseline (``"metrics"`` instead of ``"apps"``) is
accepted too.

The gate as a command (the JAX package's ``scripts/obs_diff.py``, without
``--update-baseline``: the committed baseline is the JAX package's, and
the port does not rewrite it)::

    PYTHONPATH=src python -m repro_torch.obs.diff \
        --baseline results/obs_baseline.json \
        --current results/obs_metrics_torch.json [--out report.json]

Exit 0 and ``OBS_DIFF_OK`` when every app of the baseline is within its
tolerances, 1 on drift, 2 when ``--current`` is not an
``obs-metrics/v1`` document or the baseline is not an ``obs-baseline/v1``
one.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

BASELINE_FORMAT = "obs-baseline/v1"
METRICS_FORMAT = "obs-metrics/v1"


def _doc(registry_or_doc: Any) -> Dict[str, Any]:
    """A registry's ``to_json()`` document, from either form."""
    if hasattr(registry_or_doc, "to_json"):
        return registry_or_doc.to_json()
    return dict(registry_or_doc)


def _flatten(doc: Mapping[str, Any]) -> Dict[Tuple[str, Tuple], Any]:
    """``(metric, sorted-label-items) → value`` over a registry doc."""
    out: Dict[Tuple[str, Tuple], Any] = {}
    for name, m in doc.items():
        for s in m.get("series", []):
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["value"]
    return out


@dataclasses.dataclass(frozen=True)
class MetricDelta:
    """One drifted / added / removed series."""

    metric: str
    labels: Dict[str, Any]
    base: Optional[float]          # None = series is new
    new: Optional[float]           # None = series disappeared
    rel_change: Optional[float]    # |new-base| / max(|base|, tiny)
    tol: float
    kind: str                      # "drift" | "added" | "removed"

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        lbl = ",".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
        where = f"{self.metric}{{{lbl}}}" if lbl else self.metric
        if self.kind == "added":
            return f"ADDED   {where} = {self.new}"
        if self.kind == "removed":
            return f"REMOVED {where} (was {self.base})"
        return (f"DRIFT   {where}: {self.base} -> {self.new} "
                f"(rel {self.rel_change:.3g} > tol {self.tol:.3g})")


@dataclasses.dataclass
class RegressionDiff:
    """The verdict of one baseline-vs-candidate comparison."""

    violations: List[MetricDelta]      # outside tolerance → gate fails
    added: List[MetricDelta]           # new series (informational)
    removed: List[MetricDelta]         # vanished series → gate fails
    compared: int                      # series checked within tolerance + out
    ignored: int                       # series skipped by the ignore list

    @property
    def ok(self) -> bool:
        return not self.violations and not self.removed

    def to_json(self) -> Dict[str, Any]:
        return {"format": "obs-diff/v1", "ok": self.ok,
                "compared": self.compared, "ignored": self.ignored,
                "violations": [d.to_json() for d in self.violations],
                "removed": [d.to_json() for d in self.removed],
                "added": [d.to_json() for d in self.added]}

    def format(self) -> str:
        lines = [f"compared {self.compared} series "
                 f"({self.ignored} ignored): "
                 + ("OK" if self.ok else "DRIFT DETECTED")]
        for d in self.violations + self.removed:
            lines.append("  " + d.describe())
        for d in self.added:
            lines.append("  " + d.describe())
        return "\n".join(lines)


def diff_registries(baseline: Any, candidate: Any, *,
                    tolerances: Optional[Mapping[str, float]] = None,
                    default_rel_tol: float = 0.0,
                    ignore: Sequence[str] = ()) -> RegressionDiff:
    """Compare two registries (or their ``to_json()`` docs).

    A baseline series drifts when ``|new - base| > tol × max(|base|,
    |new|)`` with ``tol`` the metric's entry in ``tolerances`` (falling
    back to ``default_rel_tol``; tol 0 = exact).  Metrics named in
    ``ignore`` are skipped entirely.  Series present only in the
    candidate are reported as added (informational — a grown repo adds
    metrics); series that vanished fail the gate.
    """
    tolerances = dict(tolerances or {})
    ignored_names = set(ignore)
    base = _flatten(_doc(baseline))
    new = _flatten(_doc(candidate))
    violations: List[MetricDelta] = []
    removed: List[MetricDelta] = []
    added: List[MetricDelta] = []
    compared = ignored = 0
    for key in sorted(base, key=repr):
        metric, litems = key
        if metric in ignored_names:
            ignored += 1
            continue
        tol = float(tolerances.get(metric, default_rel_tol))
        if key not in new:
            removed.append(MetricDelta(metric, dict(litems), base[key],
                                       None, None, tol, "removed"))
            continue
        compared += 1
        b, n = base[key], new[key]
        if isinstance(b, dict) or isinstance(n, dict):
            # Histogram series: compare their totals.
            b = b.get("total", 0) if isinstance(b, dict) else b
            n = n.get("total", 0) if isinstance(n, dict) else n
        scale = max(abs(float(b)), abs(float(n)))
        delta = abs(float(n) - float(b))
        if delta == 0:
            continue
        rel = delta / scale if scale else float("inf")
        if rel > tol:
            violations.append(MetricDelta(metric, dict(litems), b, n,
                                          rel, tol, "drift"))
    for key in sorted(set(new) - set(base), key=repr):
        metric, litems = key
        if metric in ignored_names:
            ignored += 1
            continue
        added.append(MetricDelta(metric, dict(litems), None, new[key],
                                 None, 0.0, "added"))
    return RegressionDiff(violations=violations, added=added,
                          removed=removed, compared=compared,
                          ignored=ignored)


def make_baseline(apps: Mapping[str, Any], *,
                  tolerances: Optional[Mapping[str, float]] = None,
                  ignore: Sequence[str] = (),
                  default_rel_tol: float = 0.0) -> Dict[str, Any]:
    """Build an ``obs-baseline/v1`` document from per-app registries."""
    return {"format": BASELINE_FORMAT,
            "default_rel_tol": float(default_rel_tol),
            "tolerances": dict(tolerances or {}),
            "ignore": list(ignore),
            "apps": {app: _doc(reg) for app, reg in apps.items()}}


def diff_against_baseline(baseline_doc: Mapping[str, Any],
                          candidate_apps: Mapping[str, Any]
                          ) -> Dict[str, RegressionDiff]:
    """Diff candidate per-app registries against a baseline document,
    with tolerances and ignores taken **from the baseline**.  Returns one
    :class:`RegressionDiff` per app; apps only in the baseline get a
    fully-'removed' diff (the smoke stopped covering them — gate fails)."""
    if baseline_doc.get("format") != BASELINE_FORMAT:
        raise ValueError(
            f"not an {BASELINE_FORMAT} document "
            f"(format={baseline_doc.get('format')!r})")
    tolerances = baseline_doc.get("tolerances", {})
    ignore = baseline_doc.get("ignore", [])
    default_tol = float(baseline_doc.get("default_rel_tol", 0.0))
    base_apps = baseline_doc.get("apps")
    if base_apps is None:
        base_apps = {"_": baseline_doc["metrics"]}
        candidate_apps = {"_": next(iter(candidate_apps.values()))} \
            if len(candidate_apps) == 1 else candidate_apps
    out: Dict[str, RegressionDiff] = {}
    for app, base_reg in base_apps.items():
        cand = candidate_apps.get(app, {})
        out[app] = diff_registries(base_reg, cand, tolerances=tolerances,
                                   default_rel_tol=default_tol,
                                   ignore=ignore)
    return out


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.diff")
    ap.add_argument("--baseline", default="results/obs_baseline.json")
    ap.add_argument("--current", default="results/obs_metrics_torch.json")
    ap.add_argument("--out", default=None,
                    help="write the obs-diff-report/v1 JSON here")
    args = ap.parse_args(argv)

    baseline = load_json(args.baseline)
    current = load_json(args.current)
    if current.get("format") != METRICS_FORMAT:
        print(f"error: {args.current} is not an {METRICS_FORMAT} "
              f"document (format={current.get('format')!r})",
              file=sys.stderr)
        return 2
    apps = current["apps"]
    try:
        diffs = diff_against_baseline(baseline, apps)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    ok = all(d.ok for d in diffs.values())
    for app in sorted(diffs):
        print(f"[{app}] {diffs[app].format()}")
    extra = sorted(set(apps) - set(baseline.get("apps", {})))
    if extra:
        print(f"note: apps not in baseline (not gated): {extra}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"format": "obs-diff-report/v1", "ok": ok,
                       "apps": {a: d.to_json() for a, d in diffs.items()}},
                      f, indent=2)
            f.write("\n")
        print(f"wrote diff report to {args.out}")

    print("OBS_DIFF_OK" if ok
          else "OBS_DIFF_DRIFT: metrics moved outside baseline tolerances")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
