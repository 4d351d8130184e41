"""repro_torch.chaos — deterministic fault injection across the whole stack.

Seeded link faults (drop / corrupt / reorder / scripted outages,
:mod:`repro_torch.net.faults`), reliable delivery with ARQ and route
repair (:mod:`repro_torch.net.transport`), sweep-barrier checkpoint/restore
(:mod:`repro_torch.exec.snapshot`), and restore-over-recompile tenant
recovery (:mod:`repro_torch.tenants.recover`) are each exercised by a
**scenario matrix** this package owns:

    from repro_torch.chaos import ChaosScenario, default_matrix, run_matrix

    results = run_matrix(apps=("stencil", "cnn", "knn", "pagerank"))
    assert all(cell["ok"] for cell in results["cells"])

Every cell asserts the acceptance criteria, not just "it ran":

* outputs **bit-identical** to the fault-free baseline (payloads never
  touch the flit clock, so loss costs sweeps, never bits);
* the measured-vs-predicted agreement identities all hold, including the
  repair-aware goodput conservation ``Σ link goodput == Σ channel bytes ×
  route hops`` (exact integers);
* replaying a seeded scenario reproduces it exactly;
* a mid-run kill resumes from the last sweep barrier within
  (barrier interval + drain) extra sweeps.

The faults are drawn on the host from the scenario's seed, so a cell's
record is the same on the card as on the CPU.  ``python -m
repro_torch.chaos.smoke`` is the entry point (reduced matrix, one app,
JSON artifact).
"""
from .runner import compile_app, run_matrix, run_scenario
from .scenario import ChaosScenario, default_matrix

__all__ = [
    "ChaosScenario", "compile_app", "default_matrix", "run_matrix",
    "run_scenario",
]
