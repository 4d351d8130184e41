"""PyTorch port, observability slice: ``repro_torch.obs`` (a copy of the
JAX package's ``obs``) held against the JAX package.

* the tracer's mechanics and the registry's basics, as ``tests/test_obs.py``
  asserts them for the JAX package;
* for each paper app at ndev 4 on the ring's fabric (``congestion_feedback``
  compiled in), the two packages partition alike, and the port's traced
  run has the JAX traced run's event count for every kind, its per-link
  goodput and per-bank bytes, its ``report.metrics`` (every series but
  the wall-clock ``exec.device.busy_s``) and its critical-path
  attribution; the port's traced run gives its untraced run's bits and
  counters; the Chrome trace is valid and the JSONL stream round-trips;
* for stencil and pagerank compiled as the obs smoke compiles them, on
  the partition the baseline was taken at (``BASELINE_PINS``: the
  partition MILP has tied optima that solver releases break differently,
  and the pins tie the JAX package's optimum), the port's metrics pass
  the committed ``results/obs_baseline.json`` (cnn and knn drift from
  that file for the JAX package itself, so they are held to the JAX run
  above instead);
* the cost ledger, the substrate registry and the SLO monitor, each
  package reading a hand-made tenant server over its own lossy
  transport, bank model and tracer;
* the memory path, traced, against the JAX run of the same binding;
* ``python -m repro_torch.obs.diff`` exit codes and the obs smoke.

The port runs on the CPU (``device="cpu"``), the JAX package on its CPU
backend with its kernels in interpret mode.
"""
import collections
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.compiler import CompileOptions as JaxOptions
from repro.compiler import compile as jax_compile
from repro.core import ResourceProfile as JaxResourceProfile
from repro.core import Task as JaxTask
from repro.core import TaskGraph as JaxTaskGraph
from repro.core import fpga_ring_cluster as jax_ring
from repro.exec import ProgramBinding as JaxProgramBinding
from repro.exec import execute as jax_execute
from repro.mem import MemConfig as JaxMemConfig
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import (ResourceProfile, Task, TaskGraph,
                              fpga_ring_cluster)
from repro_torch.exec import ProgramBinding, bit_identical, execute
from repro_torch.mem import MemConfig
from repro_torch.obs import (EVENT_FIELDS, NULL_TRACER, MetricsRegistry,
                             Tracer, analyze, assert_registry_consistent,
                             assert_trace_report_consistent, coerce_tracer,
                             from_report, read_jsonl, to_chrome_trace,
                             validate_chrome_trace, write_jsonl)
from repro_torch.obs import smoke as obs_smoke
from repro_torch.obs.diff import diff_against_baseline, load_json

from _torch_parity import fabric_designs

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = ROOT / "results" / "obs_baseline.json"
APPS = ("stencil", "cnn", "knn", "pagerank")


# ---------------------------------------------------------------------------
# Tracer mechanics (tests/test_obs.py's, on the port).
# ---------------------------------------------------------------------------

def test_null_tracer_is_the_disabled_default():
    assert NULL_TRACER.enabled is False
    assert coerce_tracer(None) is NULL_TRACER
    t = Tracer()
    assert coerce_tracer(t) is t
    NULL_TRACER.task_fire(0, "t", 0, 0.0, 0)
    NULL_TRACER.flit_hop(0, 0, 64, 0, 0)
    NULL_TRACER.bank_burst(0, 0, 0, 64, 0, 0)
    assert len(NULL_TRACER) == 0
    assert NULL_TRACER.link_goodput_bytes() == {}
    assert NULL_TRACER.bank_bytes() == {}
    # The executor, channels, transport and bank model hold this object.
    from repro_torch.exec import channels, executor
    from repro_torch.mem import banks
    from repro_torch.net import transport
    for mod in (channels, executor, banks, transport):
        assert mod.coerce_tracer is coerce_tracer


def test_typed_emits_match_their_schemas():
    t = Tracer()
    t.task_fire(3, "stage0", 1, 0.5, 0)
    t.task_wait(4, "stage1", 0, "net", 0)
    t.channel_push(5, 0, "a", "b", 128, 0)
    t.flit_hop(6, 2, 64, 0, 9)
    t.bank_burst(7, 5, 0, 512, 0, 1)
    assert len(t) == 5
    for e in t.events:
        assert len(e) == 2 + len(EVENT_FIELDS[e[0]]), e
    d = t.as_dicts()
    assert d[0]["kind"] == "task_fire" and d[0]["task"] == "stage0"
    assert t.count("task_fire") == 1
    assert [e[2] for e in t.iter_kind("flit_hop")] == [2]
    # The schemas are the JAX package's, kind for kind.
    assert EVENT_FIELDS == jobs.EVENT_FIELDS
    assert tobs.FAULT_KINDS == jobs.FAULT_KINDS


def test_metrics_registry_basics():
    reg = MetricsRegistry()
    reg.counter_add("x.y", 2, a="1")
    reg.counter_add("x.y", 3, a="1")
    reg.counter_add("x.y", 5, a="2")
    reg.gauge_set("g", 0.5)
    reg.observe("h", 1.0)
    reg.observe("h", 3.0)
    assert reg.value("x.y", 0, a="1") == 5
    assert reg.total("x.y") == 10
    assert reg.kind("g") == "gauge"
    h = reg.value("h", None)
    assert h["count"] == 2 and h["min"] == 1.0 and h["max"] == 3.0
    j = reg.to_json()
    assert j["x.y"]["type"] == "counter"


# ---------------------------------------------------------------------------
# The four apps on the 4-ring fabric, against the JAX package.
# ---------------------------------------------------------------------------

_RUNS = {}


def _runs(app):
    """(port design, JAX design, port untraced, port traced, JAX traced),
    each package's tracer on its traced result's report."""
    if app not in _RUNS:
        port, ref = fabric_designs(app, 4)
        base = execute(port, device="cpu")
        traced = execute(port, device="cpu", tracer=Tracer())
        want = jax_execute(ref, tracer=jobs.Tracer())
        _RUNS[app] = (port, ref, base, traced, want)
    return _RUNS[app]


def _kinds(tracer):
    return collections.Counter(e[0] for e in tracer.events)


def _without_busy(reg):
    doc = reg.to_json()
    assert "exec.device.busy_s" in doc
    del doc["exec.device.busy_s"]
    return doc


@pytest.mark.parametrize("app", APPS)
def test_partition_equals_jax(app):
    port, ref = fabric_designs(app, 4)
    assert port.partition.assignment == ref.partition.assignment
    assert (dict(port.pass_record("congestion_feedback").detail)
            == dict(ref.pass_record("congestion_feedback").detail))


@pytest.mark.parametrize("app", APPS)
def test_traced_run_is_transparent(app):
    _, _, base, traced, _ = _runs(app)
    assert bit_identical(base.outputs, traced.outputs)
    assert obs_smoke.counters(base.report) == obs_smoke.counters(
        traced.report)
    assert base.report.trace is None
    assert isinstance(traced.report.trace, Tracer)
    assert_trace_report_consistent(traced.report.trace, traced.report)
    assert_registry_consistent(from_report(traced.report), traced.report)


@pytest.mark.parametrize("app", APPS)
def test_trace_events_and_bytes_equal_jax(app):
    _, _, _, traced, want = _runs(app)
    got_tr, want_tr = traced.report.trace, want.report.trace
    assert len(got_tr) > 0
    assert _kinds(got_tr) == _kinds(want_tr)
    assert got_tr.link_goodput_bytes() == want_tr.link_goodput_bytes()
    assert got_tr.bank_bytes() == want_tr.bank_bytes()
    assert got_tr.link_goodput_bytes() == {
        l.index: int(l.bytes) for l in traced.report.congestion.links
        if l.bytes}


@pytest.mark.parametrize("app", APPS)
def test_report_metrics_equal_jax(app):
    _, _, _, traced, want = _runs(app)
    reg = traced.report.metrics
    assert reg is traced.report.metrics                   # cached
    assert isinstance(reg, MetricsRegistry)
    assert _without_busy(reg) == _without_busy(want.report.metrics)
    assert_registry_consistent(reg, traced.report)


@pytest.mark.parametrize("app", APPS)
def test_critical_path_equals_jax(app):
    _, _, _, traced, want = _runs(app)
    got = analyze(traced.report.trace, sweeps=traced.report.sweeps)
    ref = jobs.analyze(want.report.trace, sweeps=want.report.sweeps)
    assert got.to_json() == ref.to_json()
    dec = got.decomposition()
    assert sum(v for k, v in dec.items()
               if k not in ("task", "sweeps")) == traced.report.sweeps


@pytest.mark.parametrize("app", APPS)
def test_chrome_trace_and_jsonl_round_trip(app, tmp_path):
    _, _, _, traced, want = _runs(app)
    tracer = traced.report.trace
    doc = to_chrome_trace(tracer)
    validate_chrome_trace(doc)
    assert doc["otherData"]["format"] == "repro-obs/v1"
    ref = jobs.to_chrome_trace(want.report.trace)
    assert len(doc["traceEvents"]) == len(ref["traceEvents"])
    path = tmp_path / "trace.jsonl"
    write_jsonl(tracer, str(path))
    back = read_jsonl(str(path))
    assert back.events == [tuple(e) for e in tracer.events]


def test_design_summary_obs_block_equals_jax():
    port, ref = fabric_designs("stencil", 4)
    assert port.summary()["obs"] == ref.summary()["obs"]


# ---------------------------------------------------------------------------
# The committed baseline: stencil and pagerank, as the obs smoke compiles.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["stencil", "pagerank"])
def test_metrics_pass_the_committed_baseline(app):
    """On the baseline's partition pinned, as the card's smoke runs it:
    the partition MILP has tied optima, and which one the solver returns
    depends on the scipy release, while every counter of the baseline
    follows the partition."""
    graph, design = obs_smoke.compile_app(app, 4,
                                          pins=obs_smoke.BASELINE_PINS[app])
    assert design.partition.assignment == obs_smoke.BASELINE_PINS[app]
    run = obs_smoke.check_app(app, graph, design, torch.device("cpu"))
    baseline = load_json(str(BASELINE))
    doc = dict(baseline, apps={app: baseline["apps"][app]})
    diffs = diff_against_baseline(doc, {app: run["registry"]})
    assert diffs[app].ok, diffs[app].format()


@pytest.mark.parametrize("app", ["stencil", "pagerank"])
def test_baseline_pins_tie_the_jax_packages_partition(app):
    """The pins are an optimum of the problem the JAX package's compile
    with the obs smoke's options (its chaos harness's ``compile_app``)
    solves: the same comm cost, whichever tied optimum this host's solver
    returns.  And the port's compile with those options returns the JAX
    package's partition, since both call the same solver."""
    from repro.chaos.runner import compile_app as jax_compile_app
    _, ref = jax_compile_app(app, 4)
    _, port = obs_smoke.compile_app(app, 4)
    assert port.partition.assignment == ref.partition.assignment
    _, pinned = obs_smoke.compile_app(app, 4,
                                      pins=obs_smoke.BASELINE_PINS[app])
    assert pinned.partition.comm_cost == ref.partition.comm_cost


# ---------------------------------------------------------------------------
# The cost ledger and the SLO monitor.  Both read a finished tenant server;
# here each package reads a hand-made one over its own lossy transport,
# bank model and tracer (tests/test_torch_tenants.py holds them over a
# real ``TenantServer``).
# ---------------------------------------------------------------------------

def _hand_made_server(core, net, faults, mem, obs):
    """Three tenant incarnations: ``a`` (flow 1) runs to the end, ``b``
    (flow 2) is killed with messages in flight, and ``b+recovered``
    (flow 3) is its restore.  Each crosses a lossy daisy chain and reads
    HBM banks; the tracer carries their channel pushes and pops."""
    slo = lambda t, w: types.SimpleNamespace(  # noqa: E731
        target_latency_s=t, deadline_factor=2.0, weight=w)
    rec = lambda name, flow, status, via, start, end, s: \
        types.SimpleNamespace(  # noqa: E731
            name=name, flow=flow, status=status, recovered_via=via,
            start_sweep=start, end_sweep=end,
            tenant=types.SimpleNamespace(slo=s))
    records = [rec("a", 1, "done", None, 0, 40, slo(4e-6, 2.0)),
               rec("b", 2, "killed", None, 0, 6, slo(8e-6, 1.0)),
               rec("b+recovered", 3, "done", "restore", 6, 30,
                   slo(8e-6, 1.0))]
    fm = faults.FaultModel(seed=3, default=faults.LinkFaults(
        drop=0.10, corrupt=0.05), fail_threshold=None)
    cfg = net.NetConfig(mtu_bytes=32, link_credits=4, sweep_time_s=1e-6)
    tp = net.FabricTransport(net.build_fabric(core.DaisyChain(3)), cfg,
                             faults=fm)
    ms = mem.MemorySystem(3, mem.MemConfig())
    for i in range(6):
        tp.submit(i, 0, 2, 96 + 32 * i, 0, flow=1)
        tp.submit(6 + i, 2, 0, 64 + 16 * i, 0, flow=2)
        ms.submit(i, i % 3, i, 1024 * (i + 1), 0, flow=1 + i % 2)
    for sweep in range(6):
        tp.step(sweep)
        ms.step(sweep)
    tp.cancel_flow(2)
    for i in range(4):
        tp.submit(12 + i, 1, 2, 80, 6, flow=3)
        ms.submit(12 + i, 1, i, 700, 6, flow=3)
    tp.drain(6)
    ms.drain(6)
    tracer = obs.Tracer()
    for sweep in range(40):
        for flow, ch, lag in ((1, 0, 3 + sweep % 5), (3, 1, 9)):
            tracer.channel_push(sweep, ch, "src", "dst", 64 + sweep, flow)
            if sweep >= lag:
                tracer.channel_pop(sweep, ch, "src", "dst", flow)
    return types.SimpleNamespace(records=records, transport=tp, memsys=ms,
                                 tracer=tracer, net_config=cfg)


def _servers():
    import repro.core as jcore
    import repro.mem as jmem
    import repro.net as jnet
    import repro.net.faults as jfaults
    import repro_torch.core as tcore
    import repro_torch.mem as tmem
    import repro_torch.net as tnet
    import repro_torch.net.faults as tfaults
    return (_hand_made_server(tcore, tnet, tfaults, tmem, tobs),
            _hand_made_server(jcore, jnet, jfaults, jmem, jobs))


def test_cost_ledger_equals_jax():
    port_server, jax_server = _servers()
    port = tobs.build_ledger(port_server)
    ref = jobs.build_ledger(jax_server)
    assert port.to_json() == ref.to_json()
    totals = port.totals()
    assert totals["retransmit_bytes"] > 0 and totals["cancelled_bytes"] > 0
    assert port.by_lineage()["b"]["restore_sweeps"] == 24
    port_reg = tobs.substrate_metrics(port_server)
    assert port_reg.to_json() == \
        jobs.substrate_metrics(jax_server).to_json()
    assert port.to_registry().to_json() == ref.to_registry().to_json()
    tobs.assert_ledger_consistent(port, port_server, registry=port_reg)


def test_slo_monitor_equals_jax():
    """The monitor watches the incarnations while they run: ``b`` until
    its kill at sweep 6, ``b+recovered`` from 6 to 30, ``a`` throughout."""
    port_server, jax_server = _servers()
    monitors = []
    for server, obs in ((port_server, tobs), (jax_server, jobs)):
        events = list(server.tracer.events)
        server.tracer.events.clear()
        final = {r.name: r.status for r in server.records}
        a, b, reborn = server.records
        server.records = [a, b]
        for r in server.records:
            r.status = "running"
        mon = obs.SLOMonitor(window=8, cooldown=4)
        raised = []
        for sweep in range(40):
            if sweep == 6:
                b.status = final["b"]
                reborn.status = "running"
                server.records.append(reborn)
            if sweep == 30:
                reborn.status = final["b+recovered"]
            server.tracer.events.extend(e for e in events if e[1] == sweep)
            raised.append(mon.observe(server, sweep))
        monitors.append((mon, raised))
    (port, port_raised), (ref, ref_raised) = monitors
    assert port_raised == ref_raised
    assert port.summary(40) == ref.summary(40)
    assert port.burn_rates(40) == ref.burn_rates(40)
    metrics = {a["metric"] for a in port.alerts}
    assert metrics == {"p99_latency_s", "burn_rate"}
    assert port_server.tracer.count("slo_alert") == len(port.alerts)


# ---------------------------------------------------------------------------
# The memory path (tests/test_obs.py's readers graph, in both packages).
# ---------------------------------------------------------------------------

def _readers_graph(task, profile, graph_cls):
    g = graph_cls("obs-readers")
    for i in range(2):
        g.add_task(task(f"r{i}", profile({"LUT": 1000.0}),
                        hbm_bytes=128.0, meta={"hbm_bank": 0}))
    g.add_task(task("sink", profile({"LUT": 1000.0})))
    for i in range(2):
        g.add_channel(f"r{i}", "sink", 32, bytes_per_step=4.0)
    return g


def _readers_tokens(iters=3, elems=32):
    return {n: [np.full((elems,), float(10 * i + t), np.float32)
                for t in range(iters)]
            for i, n in enumerate(("r0", "r1"))}


def _port_readers_binding(g, iters=3):
    toks = {n: [torch.from_numpy(a) for a in v]
            for n, v in _readers_tokens(iters).items()}
    return ProgramBinding(
        graph=g, iterations=iters,
        programs={"r0": lambda i: i["x"], "r1": lambda i: i["x"],
                  "sink": lambda i: i["r0"] + i["r1"]},
        mem_reads={"r0": {"x": toks["r0"]}, "r1": {"x": toks["r1"]}},
        finalize=lambda s: torch.stack(s["sink"]),
        reference=lambda: torch.stack([toks["r0"][t] + toks["r1"][t]
                                       for t in range(iters)]),
        atol=0.0)


def _jax_readers_binding(g, iters=3):
    import jax.numpy as jnp
    toks = {n: [jnp.asarray(a) for a in v]
            for n, v in _readers_tokens(iters).items()}
    return JaxProgramBinding(
        graph=g, iterations=iters,
        programs={"r0": lambda i: i["x"], "r1": lambda i: i["x"],
                  "sink": lambda i: i["r0"] + i["r1"]},
        mem_reads={"r0": {"x": toks["r0"]}, "r1": {"x": toks["r1"]}},
        finalize=lambda s: jnp.stack(s["sink"]),
        atol=0.0)


_MEM = dict(banks_per_device=2, bank_bandwidth_Bps=64e6, credits=2,
            burst_bytes=64)                 # a hot bank: genuine waits
_MEM_PASSES = ("normalize_units", "partition", "pipeline_interconnect",
               "schedule")


def test_mem_path_traced_identity_and_byte_agreement():
    g = _readers_graph(Task, ResourceProfile, TaskGraph)
    design = compile(g, fpga_ring_cluster(1), CompileOptions(
        balance_kind="LUT", balance_tol=2.0, mem=MemConfig(**_MEM),
        passes=_MEM_PASSES))
    base = execute(design, _port_readers_binding(g), device="cpu")
    tracer = Tracer()
    res = execute(design, _port_readers_binding(g), device="cpu",
                  tracer=tracer)
    assert bit_identical(base.outputs, res.outputs)
    assert obs_smoke.counters(base.report) == obs_smoke.counters(res.report)
    assert tracer.count("bank_burst") > 0
    assert tracer.count("mem_issue") > 0
    assert sum(res.report.task_mem_waits.values()) > 0
    assert_trace_report_consistent(tracer, res.report)
    assert_registry_consistent(from_report(res.report), res.report)
    validate_chrome_trace(to_chrome_trace(tracer))
    crit = analyze(tracer, sweeps=res.report.sweeps)
    waits = {t.task: t.memory for t in crit.tasks}
    assert waits["r0"] + waits["r1"] \
        == sum(res.report.task_mem_waits.values())

    # The JAX package's run of the same graph and tokens.
    jg = _readers_graph(JaxTask, JaxResourceProfile, JaxTaskGraph)
    jdesign = jax_compile(jg, jax_ring(1), JaxOptions(
        balance_kind="LUT", balance_tol=2.0, mem=JaxMemConfig(**_MEM),
        passes=_MEM_PASSES))
    jtracer = jobs.Tracer()
    want = jax_execute(jdesign, _jax_readers_binding(jg), tracer=jtracer)
    assert np.array_equal(res.outputs.numpy(), np.asarray(want.outputs))
    assert _kinds(tracer) == _kinds(jtracer)
    assert tracer.bank_bytes() == jtracer.bank_bytes()
    assert _without_busy(res.report.metrics) == _without_busy(
        want.report.metrics)
    assert crit.to_json() == jobs.analyze(
        jtracer, sweeps=want.report.sweeps).to_json()


# ---------------------------------------------------------------------------
# The diff command and the obs smoke.
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _diff(tmp_path, current, *extra):
    path = tmp_path / "current.json"
    path.write_text(json.dumps(current))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.diff", "--baseline",
         str(BASELINE), "--current", str(path), *extra],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_diff_command_exit_codes(tmp_path):
    baseline = load_json(str(BASELINE))
    same = {"format": "obs-metrics/v1", "ndev": 4,
            "apps": baseline["apps"]}
    out = _diff(tmp_path, same, "--out", str(tmp_path / "report.json"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "OBS_DIFF_OK"
    assert "RuntimeWarning" not in out.stderr
    assert json.loads((tmp_path / "report.json").read_text())["ok"]
    moved = json.loads(json.dumps(same))
    series = moved["apps"]["stencil"]["exec.device.fired"]["series"]
    series[0]["value"] += 1
    out = _diff(tmp_path, moved)
    assert out.returncode == 1
    assert "OBS_DIFF_DRIFT" in out.stdout and "DRIFT   exec.device.fired" \
        in out.stdout
    out = _diff(tmp_path, {"format": "something-else"})
    assert out.returncode == 2 and "obs-metrics/v1" in out.stderr


def test_obs_smoke_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.smoke", "--device", "cpu",
         "--out", str(tmp_path / "obs.json"),
         "--trace", str(tmp_path / "trace.json"),
         "--metrics", str(tmp_path / "metrics.json")],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OBS_SMOKE_OK")
    rec = json.loads((tmp_path / "obs.json").read_text())
    assert set(rec["apps"]) == set(APPS) and rec["device"] == "cpu"
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert metrics["format"] == "obs-metrics/v1"
    validate_chrome_trace(json.loads((tmp_path / "trace.json").read_text()))
