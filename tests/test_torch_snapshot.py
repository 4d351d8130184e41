"""PyTorch port, snapshot slice: sweep-barrier checkpoint/restore
(``repro_torch.exec.snapshot``), the executor's ``injector=`` /
``checkpoint_dir=`` / ``checkpoint_every=`` hooks, ``bit_identical``, and
the exec smoke.

The cases are ``tests/test_chaos.py``'s snapshot cases, run on the port
(``device="cpu"``) and, where the JAX package has the same run, against
it: kill and restore is bit for bit (compared as bit patterns), costs at
most the sweeps since the barrier plus a drain, and takes the JAX run's
sweeps; publish is atomic; a mismatched design is refused; a
``checkpoint_every`` without a directory raises.  A bf16 token — a dtype
numpy lacks — survives a snapshot bit for bit.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro.chaos.runner import compile_app as jax_compile_app
from repro.exec import bind_programs as jax_bind_programs
from repro.exec import execute as jax_execute
from repro.exec import resume_execution as jax_resume_execution
from repro.exec import snapshot_steps as jax_snapshot_steps
from repro.runtime.fault import FailureInjector as JaxFailureInjector
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import (ResourceProfile, Task, TaskGraph,
                              fpga_ring_cluster)
from repro_torch.exec import (ExecutionState, ProgramBinding, RoutedOutput,
                              bind_programs, bit_identical, execute,
                              latest_snapshot_step, load_snapshot,
                              restore_state, resume_execution,
                              save_snapshot, snapshot_steps)
from repro_torch.mem import MemConfig
from repro_torch.obs import Tracer
from repro_torch.obs.smoke import compile_app, counters
from repro_torch.runtime import FailureInjector, run_with_restarts

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# (kill sweep, checkpoint_every) per app: at least one barrier comes
# before the kill (stencil runs 9 sweeps on the ring, pagerank 40).
KILLS = {"stencil": (5, 3), "pagerank": (23, 7)}


@pytest.fixture(scope="module")
def runs():
    """app → (graph, design, uninterrupted result), compiled as the JAX
    chaos harness compiles (the ring's fabric, congestion_feedback)."""
    out = {}
    for app in KILLS:
        graph, design = compile_app(app, 4)
        out[app] = (graph, design,
                    execute(design, bind_programs(graph, device=CPU),
                            device=CPU))
    return out


def _kill_and_resume(graph, design, d, kill, every):
    with pytest.raises(FailureInjector.Injected):
        execute(design, bind_programs(graph, device=CPU), device=CPU,
                injector=FailureInjector(fail_at_steps=[kill]),
                checkpoint_dir=d, checkpoint_every=every)
    steps = snapshot_steps(d)
    resumed = resume_execution(design, d,
                               binding=bind_programs(graph, device=CPU),
                               device=CPU)
    return steps, resumed


@pytest.mark.parametrize("app", sorted(KILLS))
def test_snapshot_kill_restore_is_bit_identical(runs, app):
    graph, design, baseline = runs[app]
    kill, every = KILLS[app]
    with tempfile.TemporaryDirectory() as d:
        steps, resumed = _kill_and_resume(graph, design, d, kill, every)
    assert steps and steps[-1] < kill          # barriers predate the kill
    assert bit_identical(resumed.outputs, baseline.outputs)
    assert all(resumed.report.agreement().values())
    assert resumed.report.agreement()["link_conservation"]
    # Cumulative books: the whole logical run's tokens and Eq. 2 bytes.
    assert ([(c.tokens, c.measured_bytes) for c in resumed.report.channels]
            == [(c.tokens, c.measured_bytes)
                for c in baseline.report.channels])
    assert resumed.report.device_fired == baseline.report.device_fired
    # The kill cost sweeps-since-barrier, not a re-run.
    assert resumed.report.sweeps - baseline.report.sweeps <= every + 16


@pytest.mark.parametrize("app", sorted(KILLS))
def test_kill_restore_takes_the_jax_runs_sweeps(runs, app):
    graph, design, _ = runs[app]
    kill, every = KILLS[app]
    jgraph, jdesign = jax_compile_app(app, 4)
    assert design.partition.assignment == jdesign.partition.assignment
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as jd:
        steps, resumed = _kill_and_resume(graph, design, d, kill, every)
        with pytest.raises(JaxFailureInjector.Injected):
            jax_execute(jdesign, jax_bind_programs(jgraph),
                        injector=JaxFailureInjector(fail_at_steps=[kill]),
                        checkpoint_dir=jd, checkpoint_every=every)
        assert steps == jax_snapshot_steps(jd)
        want = jax_resume_execution(jdesign, jd,
                                    binding=jax_bind_programs(jgraph))
    rep, jrep = resumed.report, want.report
    assert rep.sweeps == jrep.sweeps
    assert rep.agreement() == jrep.agreement()
    assert rep.summary()["net"] == jrep.summary()["net"]
    assert rep.device_fired == jrep.device_fired
    assert rep.task_congestion_waits == jrep.task_congestion_waits


def test_snapshot_publish_is_atomic_and_tmp_ignored(runs):
    graph, design, _ = runs["stencil"]
    state = ExecutionState(design, bind_programs(graph, device=CPU),
                           device=CPU)
    with tempfile.TemporaryDirectory() as d:
        path = save_snapshot(state, 0, d)
        assert os.path.isdir(path) and not path.endswith(".tmp")
        # Crashed-writer leftovers are never listed as restorable.
        os.makedirs(os.path.join(d, "step_9.tmp"))
        assert snapshot_steps(d) == [0]
        assert latest_snapshot_step(d) == 0
        # Re-saving the same barrier keeps the published dir (deterministic
        # content): no error, same path.
        assert save_snapshot(state, 0, d) == path
        # A stale .tmp of the barrier being written is replaced.
        os.makedirs(os.path.join(d, "step_1.tmp", "junk"))
        assert save_snapshot(state, 1, d).endswith("step_1")
        assert snapshot_steps(d) == [0, 1]
        assert not os.path.exists(os.path.join(d, "step_1.tmp"))
        assert load_snapshot(d, 1)["format"] == "exec-snapshot/v1"


def test_restore_rejects_mismatched_design(runs):
    graph, design, _ = runs["stencil"]
    state = ExecutionState(design, bind_programs(graph, device=CPU),
                           device=CPU)
    with tempfile.TemporaryDirectory() as d:
        save_snapshot(state, 2, d)
        payload = load_snapshot(d, 2)
        fresh = ExecutionState(design, bind_programs(graph, device=CPU),
                               device=CPU)
        with pytest.raises(ValueError, match="graph"):
            restore_state(fresh, dict(payload, graph="not-this-graph"))
        with pytest.raises(ValueError, match="iterations"):
            restore_state(fresh, dict(payload, iterations=-1))
        with pytest.raises(FileNotFoundError):
            resume_execution(design, os.path.join(d, "nope"))


def test_checkpoint_every_requires_directory(runs):
    graph, design, _ = runs["stencil"]
    with pytest.raises(ValueError, match="checkpoint_dir"):
        execute(design, bind_programs(graph, device=CPU), device=CPU,
                checkpoint_every=4)


def test_barrier_events_mark_each_snapshot(runs):
    graph, design, baseline = runs["stencil"]
    tracer = Tracer()
    with tempfile.TemporaryDirectory() as d:
        res = execute(design, bind_programs(graph, device=CPU), device=CPU,
                      checkpoint_dir=d, checkpoint_every=2, tracer=tracer)
        steps = snapshot_steps(d)
    assert bit_identical(res.outputs, baseline.outputs)
    assert counters(res.report) == counters(baseline.report)
    assert steps == [s for s in range(1, res.report.sweeps, 2)]
    assert [(e[1], e[2]) for e in tracer.iter_kind("barrier")] == [
        (s, f"step_{s}") for s in steps]


def test_run_with_restarts_resumes_from_the_last_barrier(runs):
    graph, design, baseline = runs["stencil"]
    injector = FailureInjector(fail_at_steps=[5])
    results = []

    def attempt(n):
        if n == 0:
            res = execute(design, bind_programs(graph, device=CPU),
                          device=CPU, injector=injector,
                          checkpoint_dir=d, checkpoint_every=3)
        else:
            res = resume_execution(design, d, injector=injector,
                                   binding=bind_programs(graph, device=CPU),
                                   device=CPU)
        results.append(res)
        return res.report.sweeps

    with tempfile.TemporaryDirectory() as d:
        sweeps = run_with_restarts(attempt, max_restarts=1)
    assert injector.fired == {5} and len(results) == 1
    assert sweeps == results[0].report.sweeps >= baseline.report.sweeps
    assert bit_identical(results[0].outputs, baseline.outputs)


# ---------------------------------------------------------------------------
# bf16 tokens through a snapshot.
# ---------------------------------------------------------------------------

def _readers_graph():
    g = TaskGraph("snap-readers")
    for i in range(2):
        g.add_task(Task(f"r{i}", ResourceProfile({"LUT": 1000.0}),
                        hbm_bytes=128.0, meta={"hbm_bank": 0}))
    g.add_task(Task("sink", ResourceProfile({"LUT": 1000.0})))
    for i in range(2):
        g.add_channel(f"r{i}", "sink", 32, bytes_per_step=4.0)
    return g


# bf16 bit patterns: +0, -0, a NaN with a payload, +inf, the smallest
# subnormal, the largest finite value, 1 + one ulp.
SPECIAL_BF16 = [0x0000, 0x8000, 0x7FC1, 0x7F80, 0x0001, 0x7F7F, 0x3F81]


def _bf16_tokens(iters, elems=32):
    rng = np.random.default_rng(0)
    toks = {}
    for name in ("r0", "r1"):
        bits = rng.integers(0, 1 << 16, size=(iters, elems),
                            dtype=np.uint16).astype(np.int16)
        bits[:, :len(SPECIAL_BF16)] = np.array(
            SPECIAL_BF16, np.uint16).astype(np.int16)
        toks[name] = [torch.from_numpy(b.copy()).view(torch.bfloat16)
                      for b in bits]
    return toks


def _bf16_binding(g, iters=3):
    toks = _bf16_tokens(iters)
    return ProgramBinding(
        graph=g, iterations=iters,
        programs={"r0": lambda i: i["x"],
                  "r1": lambda i: {"x": i["x"], "neg": -i["x"]},
                  "sink": lambda i: RoutedOutput(
                      {"a": i["r0"], "b": i["r1"]["neg"]})},
        mem_reads={"r0": {"x": toks["r0"]}, "r1": {"x": toks["r1"]}},
        finalize=lambda s: s["sink"], atol=0.0), toks


def _bits(t):
    return t.contiguous().view(torch.int16)


def test_bf16_tokens_survive_a_snapshot_bit_for_bit():
    g = _readers_graph()
    design = compile(g, fpga_ring_cluster(1), CompileOptions(
        balance_kind="LUT", balance_tol=2.0,
        mem=MemConfig(banks_per_device=2, bank_bandwidth_Bps=64e6,
                      credits=2, burst_bytes=64),
        passes=("normalize_units", "partition", "pipeline_interconnect",
                "schedule")))
    binding, toks = _bf16_binding(g)
    baseline = execute(design, binding, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FailureInjector.Injected):
            execute(design, _bf16_binding(g)[0], device=CPU,
                    injector=FailureInjector([baseline.report.sweeps - 2]),
                    checkpoint_dir=d, checkpoint_every=1)
        steps = snapshot_steps(d)
        # The queued tokens on disk: bf16, bit for bit the binding's.
        sent = {name: [_bits(t).tolist() for t in ts]
                for name, ts in toks.items()}
        queued = 0
        for step in steps:
            payload = load_snapshot(d, step)
            for snap in payload["channels"]:
                for vis, token, nbytes in snap["entries"]:
                    if isinstance(token, torch.Tensor):      # r0 -> sink
                        leaves, name = [token], "r0"
                    else:                                    # r1 -> sink
                        leaves, name = [token["x"], token["neg"]], "r1"
                    for leaf in leaves:
                        assert leaf.dtype == torch.bfloat16
                        assert leaf.device.type == "cpu"
                    assert _bits(leaves[0]).tolist() in sent[name]
                    queued += 1
            # Sink outputs are RoutedOutputs (descended by hand).
            for out in payload["sink_outputs"]["sink"]:
                assert isinstance(out, RoutedOutput)
                assert out["a"].dtype == torch.bfloat16
        assert queued > 0
        # A direct round trip of the last barrier restores every token.
        state = ExecutionState(design, _bf16_binding(g)[0], device=CPU)
        restore_state(state, load_snapshot(d, steps[-1]))
        restored = [e.token for fc in state.channels for e in fc._q]
        assert restored
        resumed = resume_execution(design, d, binding=_bf16_binding(g)[0],
                                   device=CPU)
    assert bit_identical(resumed.outputs, baseline.outputs)
    assert len(resumed.outputs) == 3
    for t, out in enumerate(resumed.outputs):
        assert torch.equal(_bits(out["a"]), _bits(toks["r0"][t]))
        assert torch.equal(_bits(out["b"]), _bits(-toks["r1"][t]))
    assert all(resumed.report.agreement().values())


def test_bit_identical_compares_bit_patterns():
    a = torch.tensor([0.0, float("nan"), 1.0])
    assert bit_identical(a, a.clone())
    assert not bit_identical(a, torch.tensor([-0.0, float("nan"), 1.0]))
    assert torch.equal(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert not bit_identical(a, a.double())
    assert not bit_identical(a, a[:2])
    h = torch.from_numpy(np.array([0x7FC1, 0x8000], np.uint16).view(np.int16))
    assert bit_identical(h.view(torch.bfloat16),
                         h.clone().view(torch.bfloat16))
    assert not bit_identical(h.view(torch.bfloat16),
                             (h + 1).view(torch.bfloat16))
    assert bit_identical((a, RoutedOutput(x=[a, 3])),
                         (a.clone(), RoutedOutput(x=[a.clone(), 3])))
    assert not bit_identical({"x": a}, {"y": a})
    assert not bit_identical((a,), (a, a))
    assert not bit_identical(a, a.numpy())
    assert bit_identical(np.float32(-0.0), np.float32(-0.0))
    assert not bit_identical(np.float32(-0.0), np.float32(0.0))


def test_exec_smoke_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.exec.smoke", "--device", "cpu",
         "--out", str(tmp_path / "exec.json"),
         "--trace", str(tmp_path / "trace.json")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1].startswith("EXEC_SMOKE_OK")
    rec = json.loads((tmp_path / "exec.json").read_text())
    assert rec["device"] == "cpu" and rec["parity_max_err"] <= rec["atol"]
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
