"""PyTorch port, stencil slice: the dilate kernel module, the compiler copy
and the whole compile → execute path, each against the JAX package on the
same numpy inputs.  Dilation uses only max, so every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.exec import execute as jax_execute
from repro.kernels.stencil_dilate.ref import (
    dilate_iters_ref as jax_dilate_iters)
from repro_torch.apps import stencil
from repro_torch.kernels import dilate_op
from repro_torch.kernels.stencil_dilate.ref import dilate_iters_ref

from _torch_parity import channel_bytes, designs


@pytest.mark.parametrize("h,w,iters,br", [
    (256, 128, 1, 64), (256, 128, 3, 128), (128, 256, 2, 128),
    (512, 128, 1, 256),
    (37, 53, 2, 37),                          # ragged
])
def test_dilate_matches_jax(h, w, iters, br):
    img = np.random.default_rng(0).standard_normal((h, w), dtype=np.float32)
    got = dilate_op(torch.from_numpy(img), iters=iters, block_rows=br)
    want = jk.dilate_op(jnp.asarray(img), iters=iters, block_rows=br)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        dilate_iters_ref(torch.from_numpy(img), iters).numpy(),
        np.asarray(jax_dilate_iters(jnp.asarray(img), iters)))


def test_dilate_op_leaves_input_and_zero_iters():
    img = torch.from_numpy(
        np.random.default_rng(1).standard_normal((16, 16), dtype=np.float32))
    before = img.clone()
    dilate_op(img, iters=2)
    assert torch.equal(img, before)
    assert torch.equal(dilate_op(img, iters=0), img)
    with pytest.raises(ValueError):
        dilate_op(img, iters=-1)


@pytest.mark.parametrize("ndev", [2, 4])
def test_compile_matches_jax(ndev):
    port, ref = designs("stencil", ndev)
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost
    assert (port.pipeline_report.added_latency
            == ref.pipeline_report.added_latency)
    assert ([c.depth for c in port.graph.channels]
            == [c.depth for c in ref.graph.channels])


@pytest.mark.parametrize("ndev", [2, 4])
def test_execute_matches_jax(ndev):
    spec = {"h": 48, "w": 40, "stage_iters": 2, "streams": 3, "seed": 5}
    port, ref = designs("stencil", ndev)
    got = port.execute(spec, device="cpu")
    want = jax_execute(ref, inputs=spec)

    imgs = stencil.make_inputs(port.graph, spec)["imgs"]
    single = np.stack([np.asarray(jk.dilate_op(
        jnp.asarray(img), iters=2 * ndev, block_rows=min(128, 48)))
        for img in imgs])
    np.testing.assert_array_equal(got.outputs.numpy(), single)

    assert got.report.sweeps == want.report.sweeps
    assert channel_bytes(got.report) == channel_bytes(want.report)
    assert got.report.agreement() == want.report.agreement()
    assert all(got.report.agreement().values())
    assert not got.report.starvation_events


def test_make_inputs_is_seeded():
    g = stencil.build_graph(2)
    a = stencil.make_inputs(g, {"h": 8, "w": 8, "streams": 2, "seed": 3})
    b = stencil.make_inputs(g, {"h": 8, "w": 8, "streams": 2, "seed": 3})
    np.testing.assert_array_equal(a["imgs"], b["imgs"])
    assert a["imgs"].shape == (2, 8, 8) and a["imgs"].dtype == np.float32
