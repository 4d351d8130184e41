"""``compressed_psum`` (int8 all-reduce) on 4 gloo ranks of the CPU
against ``jax.vmap(compressed_psum, axis_name=...)`` over the same four
rows, bit for bit, on every rank: fp32 rows of a gradient's scale,
rows of different scales (the shared scale is the largest), rows with
exact halves of the scale (round half to even) and an all-zero row.
The 4 ranks run once, in a subprocess with a timeout of its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import compressed_psum as j_compressed_psum

from _torch_parity import run_ranks

WORLD = 4


def _inputs():
    rng = np.random.default_rng(0)
    halves = np.tile((np.arange(-6, 7) + 0.5) / 127.0, (WORLD, 1))
    halves[0, 0] = 1.0                      # the scale: 1/127
    zero = rng.standard_normal((WORLD, 64))
    zero[2] = 0.0
    return {"gradient": rng.standard_normal((WORLD, 4096)) * 1e-3,
            "scales": rng.standard_normal((WORLD, 256))
            * np.array([1e-4, 1.0, 30.0, 2e-2])[:, None],
            "halves": halves, "zero_row": zero}


@pytest.fixture(scope="module")
def psum_run(tmp_path_factory):
    cases = {k: v.astype(np.float32) for k, v in _inputs().items()}
    out = run_ranks("psum", WORLD, tmp_path_factory.mktemp("psum"),
                    {"inputs": [torch.from_numpy(v) for v in
                                cases.values()]})
    return dict(zip(cases, out)), cases


@pytest.mark.parametrize("case", list(_inputs()))
def test_compressed_psum_matches_jax_bit_for_bit(psum_run, case):
    out, cases = psum_run
    want = np.asarray(jax.vmap(lambda r: j_compressed_psum(r, "i"),
                               axis_name="i")(jnp.asarray(cases[case])))
    got = out[case].numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
