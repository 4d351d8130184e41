"""PyTorch port, KNN slice: the fused KNN module, the merge of per-shard
candidates, the compiler copy and the whole compile → execute path, each
against the JAX package on the same numpy inputs.  Distances agree within
1e-4; indices are equal and int32 (the data leave no near-ties at these
seeds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.apps.knn import _merge_topk as jax_merge_topk
from repro.exec import execute as jax_execute
from repro_torch.apps import knn
from repro_torch.kernels import knn_op
from repro_torch.kernels.knn.kernel import partial_bytes, split_ranges
from repro_torch.kernels.knn.ref import knn_ref

from _torch_parity import channel_bytes, designs, max_abs

TOL = 1e-4


@pytest.mark.parametrize("Q,N,D,k", [
    (32, 500, 8, 5), (64, 1000, 16, 10), (16, 2048, 2, 10),
    (33, 999, 32, 10),                        # ragged
    (8, 300, 128, 12), (4, 200, 16, 40),      # the kernel's general path
])
def test_knn_matches_jax(Q, N, D, k):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((Q, D), dtype=np.float32)
    x = rng.standard_normal((N, D), dtype=np.float32)
    wd, wi = jk.knn_op(jnp.asarray(q), jnp.asarray(x), k=k, block_q=32,
                       block_n=256)
    for fn in (knn_op, knn_ref):
        gd, gi = fn(torch.from_numpy(q), torch.from_numpy(x), k)
        assert gd.dtype == torch.float32 and gi.dtype == torch.int32
        assert gd.shape == gi.shape == (Q, k)
        assert max_abs(gd.numpy(), wd) <= TOL
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_knn_ties_go_to_the_lower_index():
    x = np.zeros((6, 2), np.float32)
    x[[1, 4]] = 1.0                           # two equidistant pairs
    q = np.zeros((1, 2), np.float32)
    d, i = knn_op(torch.from_numpy(q), torch.from_numpy(x), 5)
    np.testing.assert_array_equal(i.numpy(), [[0, 2, 3, 5, 1]])
    _, wi = jk.knn_op(jnp.asarray(q), jnp.asarray(x), k=5, block_q=1,
                      block_n=8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(5)
    parts = []
    for s in range(3):
        d = np.sort(rng.integers(0, 6, (4, 5)).astype(np.float32), axis=1)
        gi = (rng.permutation(40)[:20].reshape(4, 5) + 100 * s
              ).astype(np.int32)
        parts.append((d, gi))
    wd, wi = jax_merge_topk([(jnp.asarray(d), jnp.asarray(i))
                             for d, i in parts], 7)
    gd, gi = knn._merge_topk([(torch.from_numpy(d), torch.from_numpy(i))
                              for d, i in parts], 7)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# tile 256 is the kernel's range granule (``repro_knn_tile()``).
@pytest.mark.parametrize("n,q,sms,tile", [
    (55_556, 128, 132, 256), (4_000_000, 128, 132, 256),
    (100, 300, 132, 256), (55_556, 128, 132, 1024),
    (4_000_000, 128, 132, 1024), (100, 300, 132, 1024), (1, 1, 132, 256),
    (256, 33, 132, 256), (257, 128, 132, 256), (40_007, 64, 132, 256),
    (10**7, 1, 132, 256), (5000, 4096, 8, 256),
])
def test_split_ranges_cover_every_point(n, q, sms, tile):
    """Every point falls in exactly one range, the ranges are whole tiles,
    and the partial lists stay below the data's bytes at D 16 and k 10
    (the main path's shard, 55,556 x 16: 3.56 MB; the 4 M points)."""
    per_block, nblk = split_ranges(n, q, sms, tile)
    assert per_block % tile == 0
    assert per_block * (nblk - 1) < n <= per_block * nblk
    counts = np.bincount(np.arange(n) // per_block)
    assert len(counts) == nblk and (counts > 0).all() and counts.sum() == n
    if n >= 55_556:
        assert partial_bytes(n, q, 10, sms, tile) < n * 16 * 4
    assert partial_bytes(n, q, 10, sms, tile) == nblk * q * 10 * 8


@pytest.mark.parametrize("ndev", [2, 4])
def test_compile_matches_jax(ndev):
    port, ref = designs("knn", ndev)
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost
    assert (port.pipeline_report.added_latency
            == ref.pipeline_report.added_latency)
    assert ([c.depth for c in port.graph.channels]
            == [c.depth for c in ref.graph.channels])


@pytest.mark.parametrize("ndev", [2, 4])
def test_execute_matches_jax(ndev):
    spec = {"n": 1024, "dim": 8, "q": 8, "k": 10, "streams": 2, "seed": 11}
    port, ref = designs("knn", ndev)
    got = port.execute(spec, device="cpu")
    want = jax_execute(ref, inputs=spec)

    arrays = knn.make_inputs(port.graph, spec)
    single = [jk.knn_op(jnp.asarray(qs), jnp.asarray(arrays["data"]), k=10,
                        block_q=8, block_n=512) for qs in arrays["queries"]]
    gd, gi = got.outputs
    assert gi.dtype == torch.int32
    assert max_abs(gd.numpy(), np.stack([s[0] for s in single])) <= TOL
    np.testing.assert_array_equal(gi.numpy(),
                                  np.stack([s[1] for s in single]))

    assert got.report.sweeps == want.report.sweeps
    assert channel_bytes(got.report) == channel_bytes(want.report)
    assert got.report.agreement() == want.report.agreement()
    assert all(got.report.agreement().values())
    assert not got.report.starvation_events
