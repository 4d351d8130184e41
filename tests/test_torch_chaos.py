"""PyTorch port, chaos slice: ``repro_torch.chaos`` held against the JAX
package's ``repro.chaos``.

* the scenario DSL: ``fault_model()`` and ``default_matrix()`` equal to
  the JAX package's, and the cases of ``tests/test_chaos.py``;
* ``run_scenario`` on stencil (a drop tier, a finite outage, a link death
  and a kill/restore), the port on ``device="cpu"`` and the JAX package on
  its CPU backend: each record equal to the JAX record field by field
  (sweeps, overhead, retransmit and goodput bytes, restore sweeps,
  agreement);
* ``run_tenant_cell`` for ``tenant-drop`` and ``tenant-kill``: the record,
  its cost ledger included, equal to the JAX one;
* the chaos smoke with ``--device cpu``, and no silent CPU without it.

The faults are drawn on the host from each scenario's seed, and both
packages compile the same graphs with the same options on the same host,
so the records are the same integers.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.chaos as jc
import repro_torch.chaos as tc
from repro.chaos.runner import run_tenant_cell as jax_tenant_cell
from repro_torch.chaos import smoke
from repro_torch.chaos.runner import run_tenant_cell

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _fault_model_fields(fm):
    return (fm.seed, fm.fail_threshold, dataclasses.astuple(fm.default),
            {k: dataclasses.astuple(v) for k, v in fm.links.items()})


def test_scenario_fault_model_mapping():
    for pkg in (tc, jc):
        assert pkg.ChaosScenario("clean").fault_model() is None
    port, ref = (pkg.ChaosScenario("x", drop=0.1, down={5: ((0, 6),)},
                                   fail_threshold=4, seed=9).fault_model()
                 for pkg in (tc, jc))
    assert port.seed == 9 and port.fail_threshold == 4
    assert port.for_link(5).down == ((0, 6),)
    assert port.for_link(0).drop == 0.1 and port.for_link(0).down == ()
    assert _fault_model_fields(port) == _fault_model_fields(ref)


def test_default_matrix_shape():
    port, ref = tc.default_matrix(), jc.default_matrix()
    names = [sc.name for sc in port]
    assert len([sc for sc in port if sc.lossy and not sc.down]) >= 3
    assert len([sc for sc in port if sc.down]) >= 2
    assert any(sc.kill_sweep is not None for sc in port)
    assert len(set(names)) == len(names)
    assert [dataclasses.astuple(sc) for sc in port] \
        == [dataclasses.astuple(sc) for sc in ref]
    assert [dataclasses.astuple(sc) for sc in smoke.SMOKE_SCENARIOS] == [
        dataclasses.astuple(sc) for sc in port
        if sc.name in ("drop-mid", "down-window", "link-death",
                       "kill-restore")]


@pytest.fixture(scope="module")
def baselines():
    from repro.exec import bind_programs as jax_bind
    from repro.exec import execute as jax_execute
    from repro_torch.exec import bind_programs, execute
    graph, design = tc.compile_app("stencil", 4)
    jgraph, jdesign = jc.compile_app("stencil", 4)
    assert design.partition.assignment == jdesign.partition.assignment
    return (execute(design, bind_programs(graph, device=CPU), device=CPU),
            jax_execute(jdesign, jax_bind(jgraph)))


@pytest.mark.parametrize("scenario", smoke.SMOKE_SCENARIOS,
                         ids=lambda sc: sc.name)
def test_run_scenario_matches_jax(baselines, scenario):
    port = tc.run_scenario("stencil", scenario, baseline=baselines[0],
                           device=CPU)
    ref = jc.run_scenario("stencil", scenario, baseline=baselines[1])
    assert port["ok"] and port["bit_identical"]
    assert port["overhead_sweeps"] >= 0
    if scenario.lossy:
        assert port["retransmit_bytes"] > 0
    if scenario.kill_sweep is not None:
        assert port["restore_extra_sweeps"] <= scenario.barrier + 16
    assert port == ref


@pytest.mark.parametrize("scenario", smoke.TENANT_SCENARIOS,
                         ids=lambda sc: sc.name)
def test_run_tenant_cell_matches_jax(scenario):
    port = run_tenant_cell(scenario, device=CPU)
    ref = jax_tenant_cell(scenario)
    assert port["ok"] and port["kind"] == "tenant"
    by = port["ledger"]["by_lineage"]
    if scenario.kill_sweep is not None:
        assert by["a"]["cancelled_bytes"] > 0
        assert by["a"]["restore_sweeps"] > 0
    else:
        assert by["a"]["retransmit_bytes"] > 0
    assert port == ref


def test_runner_and_smoke_need_a_card_or_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_scenario("stencil", smoke.SMOKE_SCENARIOS[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_tenant_cell(smoke.TENANT_SCENARIOS[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_matrix(("stencil",), smoke.SMOKE_SCENARIOS[:1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.main(["--out", os.devnull])


def test_chaos_smoke_runs_on_cpu(tmp_path):
    out = tmp_path / "chaos.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.chaos.smoke", "--device", "cpu",
         "--out", str(out), "--trace", str(tmp_path / "t.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "CHAOS_SMOKE_OK cells=4 apps=1" in res.stdout
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["device"] == "cpu"
    assert [c["scenario"] for c in doc["cells"]] == [
        sc.name for sc in smoke.SMOKE_SCENARIOS]
    assert [c["sweeps"] for c in doc["tenant_cells"]] == [13, 7]
    assert doc["traced_cell"]["fault_task_sweeps"] >= 1
