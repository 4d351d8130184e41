"""The port's GPipe schedule over the pod axis (``launch/pipeline.py``)
on 8 gloo ranks of the CPU, a (2, 2, 2) ('pod', 'data', 'model') mesh,
against the sequential stages ``tanh(x @ w[i])`` computed by JAX in
this process, on the shapes of ``tests/test_pipeline_pp.py``: 2 stages,
D = 16, a batch of 8, with M ∈ {1, 2, 4} microbatches, each within 1e-5
on every rank; an M that does not divide the batch raises.  The 8 ranks
run once, in a subprocess with a timeout of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_ranks

STAGES, D, B = 2, 16, 8
MICROBATCHES = (1, 2, 4)


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    rng = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(rng, (STAGES, D, D)) * 0.3)
    x = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1), (B, D)))
    ref = jnp.asarray(x)
    for i in range(STAGES):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    out = run_ranks("pipeline", 8, tmp_path_factory.mktemp("gpipe"), {
        "mesh": (2, 2, 2), "w": torch.from_numpy(w.copy()),
        "x": torch.from_numpy(x.copy()), "microbatches": MICROBATCHES, "bad": 3})
    return out, np.asarray(ref)


@pytest.mark.parametrize("M", MICROBATCHES)
def test_gpipe_matches_sequential(pipeline_run, M):
    out, ref = pipeline_run
    got = out[M].numpy()
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) < 1e-5


def test_gpipe_refuses_a_batch_that_microbatches_do_not_divide(pipeline_run):
    out, _ = pipeline_run
    assert out["bad"] is not None and "microbatches" in out["bad"]
