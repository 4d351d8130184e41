"""PyTorch port, PageRank slice: the fixed-order segment sum, ``run_numeric``,
the latency models, the compiler copy and the whole compile → execute path,
each against the JAX package on the same graph (both draw it from
``np.random.default_rng(seed)`` in the same order).

Tolerances, and why: the JAX package adds each node's contributions with a
scatter-add, the port with ``torch.segment_reduce`` over the edges sorted
by target, and the executor groups the sums by PE.  The two orders agree
within ``ATOL`` = 1e-5 (the binder's own) and within ``REL`` = 1e-5 of the
largest rank; in practice about 1e-9.  Inside the port the bits are fixed:
two runs are equal bit for bit.
Counters (sweeps, firings, measured bytes) are equal to the JAX run's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import pagerank as jax_pagerank
from repro.exec import execute as jax_execute
from repro_torch.apps import APPS, pagerank

from _torch_parity import channel_bytes, designs, max_abs

ATOL = 1e-5
REL = 1e-5


def _close(got, want) -> None:
    want = np.asarray(want, np.float64)
    err = max_abs(got, want)
    assert err <= ATOL and err <= REL * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("n,e,seed", [(64, 200, 0), (100, 7, 3),
                                      (257, 4096, 9), (5, 1000, 2)])
def test_segment_sum_adds_each_target(n, e, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, e)
    vals = rng.standard_normal(e).astype(np.float32)
    order, targets, lengths = pagerank.segments(torch.from_numpy(keys))
    assert torch.equal(torch.from_numpy(keys)[order],
                       torch.from_numpy(np.sort(keys, kind="stable")))
    got = pagerank.segment_sum(torch.from_numpy(vals)[order], targets,
                               lengths, n)
    want, terms = np.zeros(n), np.zeros(n)
    np.add.at(want, keys, vals.astype(np.float64))
    np.add.at(terms, keys, np.abs(vals.astype(np.float64)))
    assert got.dtype == torch.float32 and got.shape == (n,)
    # An fp32 sum of m terms: within m · 2^-24 of Σ|terms| (m <= 1000).
    err = np.abs(got.numpy() - want)
    assert np.all(err <= 1000 * 2.0 ** -24 * terms)
    empty = np.setdiff1d(np.arange(n), keys)
    assert not got.numpy()[empty].any()
    # The order is the contract (the card adds the same way): each target's
    # values in edge order, added first to last in fp32.
    seq = np.zeros(n, np.float32)
    for k in np.argsort(keys, kind="stable"):
        seq[keys[k]] = np.float32(seq[keys[k]] + vals[k])
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  seq.view(np.int32))
    deg = pagerank.out_degree(torch.from_numpy(keys), n).numpy()
    np.testing.assert_array_equal(
        deg, np.maximum(np.bincount(keys, minlength=n), 1).astype(np.float32))


def test_draws_are_the_jax_packages():
    src, dst = pagerank.draw_edges(300, 5000, 7, "cpu")
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(src.numpy(), rng.integers(0, 300, 5000))
    np.testing.assert_array_equal(dst.numpy(), rng.integers(0, 300, 5000))


@pytest.mark.parametrize("kw", [
    {}, dict(n_nodes=256, n_edges=2048, iters=8, seed=3),
    dict(n_nodes=1000, n_edges=20000, iters=20, seed=1, damping=0.5),
    dict(n_nodes=50, n_edges=30, iters=4),       # many nodes without edges
])
def test_run_numeric_matches_jax(kw):
    want = jax_pagerank.run_numeric(**kw)
    got = pagerank.run_numeric(**kw, device="cpu")
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    _close(got.numpy(), want)
    assert torch.equal(got, pagerank.run_numeric(**kw, device="cpu"))


def test_models_match_jax():
    assert pagerank.DATASETS == jax_pagerank.DATASETS
    assert pagerank.speedup_table() == jax_pagerank.speedup_table()
    for ndev in (1, 2, 3, 4, 8):
        assert pagerank.design(ndev) == jax_pagerank.design(ndev)
        for freq in pagerank.FREQS.values():
            for ds in pagerank.DATASETS:
                assert (pagerank.modeled_latency(ndev, freq, ds)
                        == jax_pagerank.modeled_latency(ndev, freq, ds))
    for ds in pagerank.DATASETS:
        assert (pagerank.eight_fpga_latency(ds)
                == jax_pagerank.eight_fpga_latency(ds))
    g, jg = pagerank.build_graph(4), jax_pagerank.build_graph(4)
    assert g.name == jg.name and list(g.tasks) == list(jg.tasks)
    assert ([(c.src, c.dst, c.width_bits, c.bytes_per_step, c.meta)
             for c in g.channels]
            == [(c.src, c.dst, c.width_bits, c.bytes_per_step, c.meta)
                for c in jg.channels])
    assert list(APPS)[:4] == ["stencil", "pagerank", "knn", "cnn"]


@pytest.mark.parametrize("ndev", [2, 4])
def test_compile_matches_jax(ndev):
    port, ref = designs("pagerank", ndev)
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost
    assert ([c.depth for c in port.graph.channels]
            == [c.depth for c in ref.graph.channels])


@pytest.mark.parametrize("ndev", [2, 4])
def test_execute_matches_jax(ndev):
    spec = {"n_nodes": 300, "n_edges": 3000, "iters": 6, "seed": 4}
    port, ref = designs("pagerank", ndev)
    got = port.execute(spec, device="cpu")
    want = jax_execute(ref, inputs=spec)
    _close(got.outputs.numpy(), want.outputs)
    _close(got.outputs.numpy(), jax_pagerank.run_numeric(
        n_nodes=300, n_edges=3000, iters=6, seed=4))
    rep, jrep = got.report, want.report
    assert rep.sweeps == jrep.sweeps
    assert rep.device_fired == jrep.device_fired
    assert rep.measured_inter_bytes == jrep.measured_inter_bytes > 0
    assert channel_bytes(rep) == channel_bytes(jrep)
    assert rep.agreement() == jrep.agreement()
    assert all(rep.agreement().values())
    assert not rep.starvation_events


def test_two_cpu_runs_give_the_same_bits():
    port, _ = designs("pagerank", 4)
    spec = {"n_nodes": 500, "n_edges": 8000, "iters": 5, "seed": 2}
    a = port.execute(spec, device="cpu").outputs
    b = port.execute(spec, device="cpu").outputs
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    binding = pagerank.bind_programs(port.graph, spec, device="cpu")
    ref = binding.reference()
    assert torch.equal(ref, pagerank.run_numeric(
        n_nodes=500, n_edges=8000, iters=5, seed=2, device="cpu"))
    assert float((a - ref).abs().max()) <= binding.atol == 1e-5


def test_more_pes_than_edges():
    """A shard may be empty (fewer edges than PEs): its PE sends zeros."""
    port, ref = designs("pagerank", 4)
    spec = {"n_nodes": 40, "n_edges": 9, "iters": 3, "seed": 1}
    got = port.execute(spec, device="cpu")
    _close(got.outputs.numpy(), jax_execute(ref, inputs=spec).outputs)


def test_binder_defaults_match_jax():
    port, ref = designs("pagerank", 2)
    b = pagerank.bind_programs(port.graph, device="cpu")
    jb = jax_pagerank.bind_programs(ref.graph)
    assert b.iterations == jb.iterations == 8 and b.atol == jb.atol
    assert sorted(b.programs) == sorted(jb.programs)
    assert sorted(b.prime) == sorted(jb.prime)
    for i in b.prime:
        np.testing.assert_array_equal(b.prime[i].numpy(),
                                      np.asarray(jb.prime[i]))
    _close(b.reference().numpy(), jnp.asarray(jb.reference()))
