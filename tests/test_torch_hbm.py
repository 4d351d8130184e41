"""PyTorch port, HBM slice: the memory-bound BLAS ops and the four HBM apps
(axpy, dot, gemv, axpydot), each against the JAX package on the same numpy
inputs.

Tolerances, and why:

* axpy within 1 ulp of the JAX op (both round ``a·x + y`` once; in
  practice the bits are equal);
* a sum (a dot partial, a gemv row) within ``SUM_REL`` of the sum of the
  absolute terms: the two packages add the same fp32 products in different
  orders, and the worst-case error of either order over these lengths is
  below 1e-6 of Σ|terms|;
* inside the port, decomposed against monolithic and the bank path
  against the ideal path are exact (``atol=0.0``), as are every counter of
  the run against the JAX run's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.apps import APPS as JAX_APPS
from repro.compiler import CompileOptions as JaxOptions
from repro.compiler import compile as jax_compile
from repro.core import fpga_ring_cluster as jax_ring
from repro.exec import bind_programs as jax_bind
from repro.exec import execute as jax_execute
from repro.mem import MemConfig as JaxMemConfig
from repro_torch.apps import APPS
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import fpga_ring_cluster
from repro_torch.exec import bind_programs, execute
from repro_torch.kernels import (axpy_op, axpydot_op, dot_op,
                                 dot_partials_op, fold_partials, gemv_op,
                                 launch_counts)
from repro_torch.kernels.hbm_blas.ref import (axpy_ref, dot_partials_ref,
                                              gemv_ref)
from repro_torch.mem import MemConfig
from repro_torch.mem import smoke as mem_smoke

SUM_REL = 1e-6
HBM_APPS = ["axpy", "dot", "gemv", "axpydot"]
PASSES = ("normalize_units", "partition", "memory_feedback",
          "pipeline_interconnect", "schedule")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _t(a):
    return torch.from_numpy(a)


def _within_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return bool(np.all(np.abs(got.astype(np.float64) - want)
                       <= np.spacing(np.abs(want))))


def _sum_err(got, want, abs_terms):
    """Max |got − want| over Σ|terms|, elementwise."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    scale = np.maximum(np.asarray(abs_terms, np.float64).reshape(-1), 1e-30)
    return float(np.max(np.abs(got - want) / scale))


SHAPES = [(16, 128, 4), (64, 128, 16), (256, 128, 256), (48, 96, 12),
          (37, 53, 37), (100, 7, 25), (3, 1, 1)]


@pytest.mark.parametrize("R,C,br", SHAPES)
def test_axpy_matches_jax(R, C, br):
    x, y = _rand(0, R, C), _rand(1, R, C)
    want = jk.axpy_op(1.5, jnp.asarray(x), jnp.asarray(y), block_rows=br)
    got = axpy_op(1.5, _t(x), _t(y), block_rows=br)
    assert got.dtype == torch.float32 and got.shape == (R, C)
    assert _within_ulp(got.numpy(), want)
    # One rounding: float32(1.5·x + y) taken in float64.
    np.testing.assert_array_equal(
        got.numpy(), (1.5 * x.astype(np.float64) + y).astype(np.float32))


@pytest.mark.parametrize("R,C,br", SHAPES)
def test_dot_partials_matches_jax(R, C, br):
    x, y = _rand(2, R, C), _rand(3, R, C)
    want = jk.dot_partials_op(jnp.asarray(x), jnp.asarray(y), block_rows=br)
    got = dot_partials_op(_t(x), _t(y), block_rows=br)
    nblk = R // min(br, R)
    assert got.shape == (nblk, 1) == tuple(np.shape(want))
    terms = np.abs(x * y).reshape(nblk, -1).sum(1)
    assert _sum_err(got.numpy(), want, terms) <= SUM_REL
    dwant = jk.dot_op(jnp.asarray(x), jnp.asarray(y), block_rows=br)
    assert _sum_err(dot_op(_t(x), _t(y), block_rows=br).numpy(), dwant,
                    terms.sum()) <= SUM_REL


# gemv's edges: M = 1, M below the SM count, M odd, N = 65536, N % 4 != 0.
GEMV_EDGES = [(1, 8192, 1), (100, 2048, 25), (37, 1000, 37), (8, 65536, 4),
              (48, 4099, 16)]


@pytest.mark.parametrize("R,C,br", SHAPES + GEMV_EDGES)
def test_gemv_matches_jax(R, C, br):
    A, x = _rand(4, R, C), _rand(5, 1, C)
    want = jk.gemv_op(jnp.asarray(A), jnp.asarray(x), block_rows=br)
    got = gemv_op(_t(A), _t(x), block_rows=br)
    assert got.shape == (R, 1) == tuple(np.shape(want))
    assert _sum_err(got.numpy(), want, np.abs(A * x).sum(1)) <= SUM_REL


@pytest.mark.parametrize("R,C,br", SHAPES)
def test_axpydot_matches_jax(R, C, br):
    x, y, w = _rand(6, R, C), _rand(7, R, C), _rand(8, R, C)
    want = jk.axpydot_op(1.5, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(w), block_rows=br)
    got = axpydot_op(1.5, _t(x), _t(y), _t(w), block_rows=br)
    z = (1.5 * x.astype(np.float64) + y).astype(np.float32)
    assert _sum_err(got.numpy(), want, np.abs(z * w).sum()) <= SUM_REL


@pytest.mark.parametrize("op", ["axpy", "dot_partials", "gemv"])
def test_block_equals_shard_bit_for_bit(op):
    """The whole-array op with ``block_rows = br`` gives each block the bits
    the op gives that block alone — the contract the apps' ``atol=0.0``
    rests on."""
    R, C, br = 96, 40, 24
    x, y = _t(_rand(9, R, C)), _t(_rand(10, R, C))
    vec = _t(_rand(11, 1, C))
    calls = {"axpy": lambda a, b: axpy_op(0.75, a, b, block_rows=br),
             "dot_partials": lambda a, b: dot_partials_op(a, b,
                                                          block_rows=br),
             "gemv": lambda a, b: gemv_op(a, vec, block_rows=br)}
    whole = calls[op](x, y)
    shards = torch.cat([calls[op](x[i:i + br], y[i:i + br])
                        for i in range(0, R, br)])
    assert torch.equal(whole, shards)


def test_fold_partials_matches_jax_bit_for_bit():
    parts = _rand(12, 9, 1) * np.float32(1e3)
    want = jk.fold_partials(jnp.asarray(parts))
    got = fold_partials(_t(parts))
    assert got.dtype == torch.float32
    assert got.item() == float(want)
    listed = fold_partials([_t(parts)[i, 0] for i in range(9)])
    assert torch.equal(listed, got)


@pytest.mark.parametrize("call", [
    lambda: axpy_ref(1.0, torch.zeros(6, 4), torch.zeros(6, 4), 4),
    lambda: dot_partials_ref(torch.zeros(6, 4), torch.zeros(6, 4), 4),
    lambda: gemv_ref(torch.zeros(6, 4), torch.zeros(1, 4), 4),
    lambda: axpy_op(1.0, torch.zeros(0, 4), torch.zeros(0, 4)),
])
def test_ops_refuse_ragged_row_blocks(call):
    with pytest.raises(ValueError, match="multiple of block_rows"):
        call()


# -- the four HBM apps: compile → execute through the bank model -------------

MEM_CFG = dict(banks_per_device=4, bank_bandwidth_Bps=2e9, credits=4,
               burst_bytes=512)


def _options(mem_cls, opts_cls):
    return opts_cls(balance_kind="LUT", balance_tol=0.8, exact_limit=1500,
                    floorplan_devices=None, mem=mem_cls(**MEM_CFG),
                    passes=PASSES)


def _designs(app, ndev):
    port = compile(APPS[app].build_graph(ndev), fpga_ring_cluster(ndev),
                   _options(MemConfig, CompileOptions))
    ref = jax_compile(JAX_APPS[app].build_graph(ndev), jax_ring(ndev),
                      _options(JaxMemConfig, JaxOptions))
    return port, ref


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("app", HBM_APPS)
def test_compile_matches_jax(app, ndev):
    port, ref = _designs(app, ndev)
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost
    assert port.bank_map == ref.bank_map
    assert (port.pass_record("memory_feedback").detail
            == ref.pass_record("memory_feedback").detail)
    assert port.mem_contention.summary() == ref.mem_contention.summary()
    assert ([c.depth for c in port.graph.channels]
            == [c.depth for c in ref.graph.channels])


def _jax_single(app, arrays, br):
    a = jnp.asarray
    if app == "axpy":
        return np.stack([jk.axpy_op(1.5, a(x), a(y), block_rows=br)
                         for x, y in zip(arrays["x"], arrays["y"])])
    if app == "dot":
        return np.stack([jk.dot_op(a(x), a(y), block_rows=br)
                         for x, y in zip(arrays["x"], arrays["y"])])
    if app == "gemv":
        return np.stack([jk.gemv_op(a(A), a(x), block_rows=br)
                         for A, x in zip(arrays["A"], arrays["x"])])
    return np.stack([jk.axpydot_op(1.5, a(x), a(y), a(w), block_rows=br)
                     for x, y, w in zip(arrays["x"], arrays["y"],
                                        arrays["w"])])


def _abs_terms(app, arrays):
    if app == "dot":
        return np.abs(arrays["x"] * arrays["y"]).sum((1, 2))
    if app == "gemv":
        return np.abs(arrays["A"] * arrays["x"]).sum(2)
    z = (1.5 * arrays["x"].astype(np.float64) + arrays["y"]).astype(
        np.float32)
    return np.abs(z * arrays["w"]).sum((1, 2))


def _counters(rep):
    return (rep.sweeps, dict(rep.task_mem_waits), rep.agreement(),
            [(b.name, b.bytes, b.bursts, b.busy_sweeps, b.saturated_sweeps,
              b.peak_queue_bursts, b.requests)
             for b in rep.mem_contention.banks],
            [(c.task, c.stream, c.device, c.bank, c.issued, c.consumed,
              c.delivered_bytes, c.blocked_issues, c.max_outstanding,
              c.response_waits) for c in rep.mem_channels],
            [(c.src, c.dst, c.inter_device, c.tokens, c.measured_bytes)
             for c in rep.channels])


@pytest.mark.parametrize("app", HBM_APPS)
def test_execute_through_banks_matches_jax(app):
    port, ref = _designs(app, 2)
    before = launch_counts()
    binding = bind_programs(port.graph, device="cpu")
    banked = execute(port, binding, device="cpu")
    ideal = execute(port, bind_programs(port.graph, device="cpu"),
                    device="cpu", mem=None)
    assert launch_counts() == before                  # no kernel on the CPU
    expected = binding.reference()
    assert torch.equal(banked.outputs, ideal.outputs)
    assert torch.equal(banked.outputs, expected)

    rep = banked.report
    agree = rep.agreement()
    assert all(agree.values())
    assert agree["mem_delivery_match"] and agree["bank_conservation"]
    assert int(rep.mem_bank_bytes) == rep.mem_delivered_bytes > 0
    assert rep.mem_contention.max_utilization <= 1.0 + 1e-12
    assert rep.sweeps > ideal.report.sweeps
    assert sum(rep.task_mem_waits.values()) > 0
    assert sum(ideal.report.task_mem_waits.values()) == 0
    assert ideal.report.mem_contention is None
    assert rep.mem_model_s > 0.0 == ideal.report.mem_model_s

    want = jax_execute(ref, jax_bind(ref.graph))
    assert _counters(rep) == _counters(want.report)
    want_ideal = jax_execute(ref, jax_bind(ref.graph), mem=None)
    assert ideal.report.sweeps == want_ideal.report.sweeps

    arrays = APPS[app].make_inputs(port.graph)
    br = 16 // (2 * 2)
    single = _jax_single(app, arrays, br)
    got = banked.outputs.numpy()
    assert got.shape == single.shape
    if app == "axpy":
        assert _within_ulp(got, single)
    else:
        assert _sum_err(got, single, _abs_terms(app, arrays)) <= SUM_REL


@pytest.mark.parametrize("app", HBM_APPS)
def test_make_inputs_are_seeded_numpy(app):
    graph = APPS[app].build_graph(2)
    spec = {"rows": 8, "lanes": 4, "streams": 2, "seed": 5}
    one = APPS[app].make_inputs(graph, spec)
    two = APPS[app].make_inputs(graph, spec)
    other = APPS[app].make_inputs(graph, dict(spec, seed=6))
    for name, arr in one.items():
        assert arr.dtype == np.float32 and arr.shape[:2] in ((2, 8), (2, 1))
        np.testing.assert_array_equal(arr, two[name])
        assert not np.array_equal(arr, other[name])


def test_rows_must_split_into_shards():
    with pytest.raises(ValueError, match="multiple of the 4 shards"):
        bind_programs(APPS["axpy"].build_graph(2), {"rows": 10},
                      device="cpu")


@pytest.mark.parametrize("app", ["axpydot", "gemv"])
def test_mem_smoke_on_cpu(app, tmp_path):
    out = tmp_path / "mem_smoke.json"
    assert mem_smoke.main(["--app", app, "--ndev", "2", "--device", "cpu",
                           "--out", str(out)]) == 0
    import json
    rec = json.loads(out.read_text())
    assert rec["bit_identical"] and all(rec["agreement"].values())
    assert rec["device"] == "cpu" and rec["sweeps"] > rec["ideal_sweeps"]
    assert rec["measured"]["max_utilization"] <= 1.0
    assert rec["feedback"]["bank_map"] == rec["bank_map"]
