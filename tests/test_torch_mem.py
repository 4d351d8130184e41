"""PyTorch port, HBM bank model: ``repro_torch.mem`` against ``repro.mem``.

Each case of ``tests/test_mem.py``'s bank-model section runs once through
each package on the same inputs (the port's executor on ``device="cpu"``).
A case asserts the JAX test's own properties on whichever package runs it
and returns its counters, bank maps or pass details; the two packages must
return equal values.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compiler as jax_compiler
import repro.core as jax_core
import repro.exec as jax_exec
import repro.mem as jax_mem
import repro_torch.compiler as torch_compiler
import repro_torch.core as torch_core
import repro_torch.exec as torch_exec
import repro_torch.mem as torch_mem
from repro.apps import APPS as JAX_APPS
from repro.net.transport import NetConfig
from repro_torch.apps import APPS as TORCH_APPS

JAX = types.SimpleNamespace(
    name="jax", mem=jax_mem, core=jax_core, compiler=jax_compiler,
    apps=JAX_APPS, Binding=jax_exec.ProgramBinding,
    execute=jax_exec.execute,
    full=lambda n, v: jnp.full((n,), v, jnp.float32), stack=jnp.stack,
    equal=lambda a, b: bool(jnp.all(a == b)))
PORT = types.SimpleNamespace(
    name="torch", mem=torch_mem, core=torch_core, compiler=torch_compiler,
    apps=TORCH_APPS, Binding=torch_exec.ProgramBinding,
    execute=lambda *a, **kw: torch_exec.execute(*a, device="cpu", **kw),
    full=lambda n, v: torch.full((n,), float(v), dtype=torch.float32),
    stack=torch.stack, equal=torch.equal)


def _counters(ms):
    return [(c.bytes, c.bursts, c.busy_sweeps, c.saturated_sweeps,
             c.peak_queue_bursts, c.requests) for c in ms.counters]


def _drain(ms, channels=None, start=0):
    sweep = start
    while ms.active:
        for rid, ci in ms.step(sweep):
            if channels is not None:
                channels[ci].on_complete(rid, sweep)
        sweep += 1
        assert sweep < 10_000, "memory system failed to make progress"
    return sweep


# -- bank mechanics ----------------------------------------------------------

def case_burst_math(p):
    cfg = p.mem.MemConfig(burst_bytes=512)
    slow = p.mem.MemConfig(bank_bandwidth_Bps=1.0, burst_bytes=512)
    got = ([cfg.bursts_for(n) for n in (1, 512, 513, 4096, 0)],
           slow.budget_bursts(), cfg.budget_bursts(), cfg.sweep_time_s,
           cfg.device_bandwidth_Bps())
    assert got[0][:3] == [1, 1, 2] and got[1] == 1
    return got


def case_conservation(p):
    cfg = p.mem.MemConfig(banks_per_device=2, bank_bandwidth_Bps=64e6,
                          credits=4, burst_bytes=64)
    ms = p.mem.MemorySystem(2, cfg)
    sizes = [(0, 0, 0, 1234), (1, 0, 1, 999), (2, 1, 0, 100), (3, 1, 1, 65)]
    for ch, dev, bank, n in sizes:
        ms.submit(ch, dev, bank, n, 0)
    sweeps = _drain(ms)
    assert ms.total_served_bytes == ms.total_requested_bytes == \
        sum(n for *_, n in sizes)
    assert sum(c.bytes for c in ms.counters) == ms.total_served_bytes
    assert sum(c.bursts for c in ms.counters) == \
        sum(cfg.bursts_for(n) for *_, n in sizes)
    utils = [ms.utilization(b) for b in range(4)]
    assert max(utils) <= 1.0
    return sweeps, _counters(ms), utils


def case_fair_sharing(p):
    cfg = p.mem.MemConfig(banks_per_device=1, bank_bandwidth_Bps=64e6,
                          credits=8, burst_bytes=64)
    solo = p.mem.MemorySystem(1, cfg)
    solo.submit(0, 0, 0, 8 * 64, 0)
    solo_sweeps = _drain(solo)
    both = p.mem.MemorySystem(1, cfg)
    both.submit(0, 0, 0, 8 * 64, 0)
    both.submit(1, 0, 0, 8 * 64, 0)
    done, sweep = [], 0
    while both.active:
        done.extend(both.step(sweep))
        sweep += 1
    assert sweep >= 2 * solo_sweeps - 1
    assert both.counters[0].saturated_sweeps > 0
    assert {ci for _, ci in done} == {0, 1}
    return solo_sweeps, sweep, done, _counters(both)


# -- async memory channels ---------------------------------------------------

def _stats(ch):
    s = ch.stats
    return (s.issued, s.consumed, s.requested_bytes, s.delivered_bytes,
            s.blocked_issues, s.max_outstanding, s.response_waits)


def case_ideal_channel(p):
    toks = [p.full(16, i) for i in range(4)]
    ch = p.mem.AsyncMemChannel(0, "t", "x", toks, 4, device=0, bank=0,
                               memsys=None)
    out = []
    for sweep in range(4):
        ch.pump(sweep)
        assert ch.response_ready(sweep)
        out.append(ch.consume(sweep))
    assert ch.total_bursts() == 0
    assert all(p.equal(g, w) for g, w in zip(out, toks))
    return _stats(ch)


def case_credits(p):
    cfg = p.mem.MemConfig(banks_per_device=1, bank_bandwidth_Bps=64e6,
                          credits=2, burst_bytes=64)
    ms = p.mem.MemorySystem(1, cfg)
    toks = [p.full(16, i) for i in range(6)]
    ch = p.mem.AsyncMemChannel(0, "t", "x", toks, 6, device=0, bank=0,
                               memsys=ms)
    out, sweep = [], 0
    while ch.stats.consumed < ch.count:
        ch.pump(sweep)
        assert ch.outstanding <= cfg.credits
        if ch.response_ready(sweep):
            out.append(ch.consume(sweep))
        for rid, _ in ms.step(sweep):
            ch.on_complete(rid, sweep)
        sweep += 1
        assert sweep < 1000
    assert ch.stats.blocked_issues > 0 and ch.stats.response_waits > 0
    assert ch.stats.max_outstanding == cfg.credits
    assert all(p.equal(g, w) for g, w in zip(out, toks))
    return sweep, _stats(ch), ch.total_bursts(), _counters(ms)


def case_short_token_list(p):
    with pytest.raises(ValueError, match="2 tokens < 3 firings") as e:
        p.mem.AsyncMemChannel(0, "t", "x", [p.full(16, 0)] * 2, 3, device=0,
                              bank=0)
    return str(e.value)


# -- bank maps ---------------------------------------------------------------

def _readers_graph(p, loads, pins=None):
    g = p.core.TaskGraph("readers")
    for i, b in enumerate(loads):
        meta = ({"hbm_bank": pins[i]} if pins and pins[i] is not None
                else {})
        g.add_task(p.core.Task(f"r{i}", p.core.ResourceProfile(
            {"LUT": 1000.0}), hbm_bytes=b, meta=meta))
    g.add_task(p.core.Task("sink", p.core.ResourceProfile({"LUT": 1000.0})))
    for i in range(len(loads)):
        g.add_channel(f"r{i}", "sink", 32, bytes_per_step=4.0)
    return g


def _usage(report):
    return (report.kind, report.sweeps, report.total_bytes,
            [(b.name, b.bytes, b.utilization, b.bursts, b.busy_sweeps,
              b.saturated_sweeps, b.peak_queue_bursts, b.requests, b.tasks)
             for b in report.banks])


def case_default_bank_map(p):
    cfg = p.mem.MemConfig(banks_per_device=2)
    g = _readers_graph(p, [100, 100, 100], pins=[5, None, None])
    m = p.mem.default_bank_map(g, {n: 0 for n in g.tasks}, cfg)
    assert m == {"r0": 1, "r1": 0, "r2": 1}
    return m


def case_lpt_rebalance(p):
    cfg = p.mem.MemConfig(banks_per_device=2, bank_bandwidth_Bps=1e9)
    g = _readers_graph(p, [800.0, 500.0, 400.0], pins=[0, 0, 0])
    asg = {n: 0 for n in g.tasks}
    pinned = p.mem.project(g, asg, cfg)
    m = p.mem.rebalance_bank_map(g, asg, cfg)
    spread = p.mem.project(g, asg, cfg, bank_map=m)
    assert m["r0"] != m["r1"]
    assert spread.max_utilization < pinned.max_utilization
    assert spread.bank(0, m["r0"]).bytes == 800.0
    return m, _usage(pinned), _usage(spread)


# -- measured vs projected, through each package's executor -----------------

def _two_reader_binding(p, g, iters=3, elems=32):
    toks = {n: [p.full(elems, 10 * i + t) for t in range(iters)]
            for i, n in enumerate(("r0", "r1"))}
    return p.Binding(
        graph=g, iterations=iters,
        programs={"r0": lambda i: i["x"], "r1": lambda i: i["x"],
                  "sink": lambda i: i["r0"] + i["r1"]},
        mem_reads={"r0": {"x": toks["r0"]}, "r1": {"x": toks["r1"]}},
        finalize=lambda s: p.stack(s["sink"]),
        reference=lambda: p.stack([toks["r0"][t] + toks["r1"][t]
                                   for t in range(iters)]),
        atol=0.0)


def _compile_readers(p, g, config, feedback=True):
    passes = ["normalize_units", "partition"]
    if feedback:
        passes.append("memory_feedback")
    passes += ["pipeline_interconnect", "schedule"]
    return p.compiler.compile(g, p.core.fpga_ring_cluster(1),
                              p.compiler.CompileOptions(
                                  balance_kind="LUT", balance_tol=2.0,
                                  mem=config, passes=tuple(passes)))


def _run_summary(rep):
    return (rep.sweeps, rep.agreement(), dict(rep.task_mem_waits),
            [(c.task, c.stream, c.device, c.bank, c.issued, c.consumed,
              c.requested_bytes, c.delivered_bytes, c.blocked_issues,
              c.max_outstanding, c.response_waits)
             for c in rep.mem_channels], _usage(rep.mem_contention))


def case_uncontended(p):
    cfg = p.mem.MemConfig(banks_per_device=2, bank_bandwidth_Bps=256e6,
                          credits=2, burst_bytes=64)
    g = _readers_graph(p, [128.0, 128.0])
    design = _compile_readers(p, g, cfg)
    rep = p.execute(design, _two_reader_binding(p, g)).report
    assert all(rep.agreement().values())
    measured, projected = rep.mem_contention, design.mem_contention
    for task in ("r0", "r1"):
        b = design.bank_map[task]
        assert measured.bank(0, b).bytes == \
            projected.bank(0, b).bytes * rep.iterations
        assert measured.bank(0, b).saturated_sweeps == 0
    assert projected.max_utilization == pytest.approx(0.5)
    assert not measured.hotspots(0.75) and not projected.hotspots(0.75)
    return _run_summary(rep), _usage(projected), design.bank_map


def case_hot_bank(p):
    cfg = p.mem.MemConfig(banks_per_device=2, bank_bandwidth_Bps=64e6,
                          credits=2, burst_bytes=64)
    g = _readers_graph(p, [128.0, 128.0], pins=[0, 0])
    design = _compile_readers(p, g, cfg, feedback=False)
    binding = _two_reader_binding(p, g)
    result = p.execute(design, binding)
    rep = result.report
    assert p.equal(result.outputs, binding.reference())
    assert all(rep.agreement().values())
    projected = p.mem.project(g, {n: 0 for n in g.tasks}, cfg)
    measured = rep.mem_contention
    assert projected.bank(0, 0).utilization == pytest.approx(4.0)
    assert measured.max_utilization <= 1.0 + 1e-12
    assert measured.bank(0, 0).saturated_sweeps > 0
    assert measured.bank(0, 1).bytes == 0
    assert sum(rep.task_mem_waits.values()) > 0
    assert measured.total_bytes == projected.total_bytes * rep.iterations
    return _run_summary(rep), _usage(projected)


# -- the memory_feedback pass ------------------------------------------------

def _detail(design):
    d = dict(design.pass_record("memory_feedback").detail)
    return d, design.partition.assignment, design.partition.stats.method


def case_feedback_remaps(p):
    cfg = p.mem.MemConfig(banks_per_device=2, bank_bandwidth_Bps=1e9)
    per = 0.8 * cfg.bank_bandwidth_Bps * cfg.sweep_time_s
    design = _compile_readers(p, _readers_graph(p, [per, per], pins=[0, 0]),
                              cfg)
    d, *_ = _detail(design)
    assert d["remapped"] and not d["repartitioned"]
    assert d["max_utilization_before"] == pytest.approx(1.6)
    assert d["max_utilization_after"] == pytest.approx(0.8)
    return _detail(design), design.bank_map


def case_membound_repartition(p):
    cfg = p.mem.MemConfig(banks_per_device=1, bank_bandwidth_Bps=1e9)
    per = 0.9 * cfg.bank_bandwidth_Bps * cfg.sweep_time_s
    g = p.core.TaskGraph("membound")
    for n in ("h0", "h1"):
        g.add_task(p.core.Task(n, p.core.ResourceProfile({"LUT": 1000.0}),
                               hbm_bytes=per))
    g.add_task(p.core.Task("sink", p.core.ResourceProfile({"LUT": 1000.0})))
    g.add_channel("h0", "h1", 512, bytes_per_step=4096.0)
    g.add_channel("h1", "sink", 32, bytes_per_step=4.0)
    design = p.compiler.compile(g, p.core.fpga_ring_cluster(2),
                                p.compiler.CompileOptions(
                                    balance_kind="LUT", balance_tol=2.0,
                                    mem=cfg, passes=("normalize_units",
                                                     "partition",
                                                     "memory_feedback")))
    d, a, method = _detail(design)
    assert d["repartitioned"] and method.endswith("-membound")
    assert a["h0"] != a["h1"]
    assert d["max_utilization_after"] == pytest.approx(0.9)
    assert d["comm_cost_after"] >= d["comm_cost_before"]
    return d, a, method, design.partition.comm_cost


def case_membound_gives_up(p):
    cfg = p.mem.MemConfig(banks_per_device=1, bank_bandwidth_Bps=1e9)
    per = 3.0 * cfg.bank_bandwidth_Bps * cfg.sweep_time_s
    design = p.compiler.compile(
        _readers_graph(p, [per]), p.core.fpga_ring_cluster(2),
        p.compiler.CompileOptions(balance_kind="LUT", balance_tol=2.0,
                                  mem=cfg, passes=("normalize_units",
                                                   "partition",
                                                   "memory_feedback")))
    d, a, method = _detail(design)
    assert not d["repartitioned"] and not method.endswith("-membound")
    assert d["max_utilization_after"] == pytest.approx(3.0)
    return d, a, method


def case_pass_order(p):
    cfg = p.mem.MemConfig(banks_per_device=4, bank_bandwidth_Bps=2e9,
                          credits=4, burst_bytes=512)
    design = p.compiler.compile(
        p.apps["axpy"].build_graph(2), p.core.fpga_ring_cluster(2),
        p.compiler.CompileOptions(balance_kind="LUT", balance_tol=0.8,
                                  exact_limit=1500, floorplan_devices=None,
                                  mem=cfg))
    names = [r.name for r in design.pass_records]
    assert names.index("memory_feedback") > names.index("partition")
    assert design.summary()["mem"]["banks_per_device"] == 4
    return (names, design.bank_map, design.summary()["mem"],
            _detail(design))


CASES = {f.__name__[len("case_"):]: f for f in (
    case_burst_math, case_conservation, case_fair_sharing,
    case_ideal_channel, case_credits, case_short_token_list,
    case_default_bank_map, case_lpt_rebalance, case_uncontended,
    case_hot_bank, case_feedback_remaps, case_membound_repartition,
    case_membound_gives_up, case_pass_order)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bank_model_matches_jax(case):
    assert CASES[case](PORT) == CASES[case](JAX)


def test_sweep_time_base_matches_the_transport():
    assert torch_mem.SWEEP_TIME_S == NetConfig().sweep_time_s
    assert torch_mem.MemConfig().sweep_time_s == \
        jax_mem.MemConfig().sweep_time_s


def _tokens(n):
    return [torch.full((16,), float(i)) for i in range(n)]


@pytest.mark.parametrize("reads,match", [
    ({"r0": {"x": _tokens(1)}, "r1": {"x": _tokens(1)},
      "ghost": {"x": _tokens(1)}}, "unknown task"),
    ({"r0": {"x": _tokens(1)}, "r1": {"x": _tokens(1)},
      "sink": {"r0": _tokens(1)}}, "shadow"),
    ({"r0": {"x": _tokens(1)}, "r1": {"x": []}}, "0 tokens < 1"),
])
def test_mem_reads_binding_validation(reads, match):
    g = _readers_graph(PORT, [64.0, 64.0])
    good = _two_reader_binding(PORT, g)
    good.validate()
    with pytest.raises(ValueError, match=match):
        torch_exec.ProgramBinding(graph=g, iterations=1,
                                  programs=dict(good.programs),
                                  mem_reads=reads).validate()


def test_numpy_tokens_count_their_bytes():
    ch = torch_mem.AsyncMemChannel(0, "t", "x", [np.zeros(10, np.float64)],
                                   1, device=0, bank=0)
    ch.pump(0)
    assert ch.stats.requested_bytes == 80
