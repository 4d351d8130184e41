"""PyTorch port, stencil slice: the dilate kernel module, the compiler copy
and the whole compile → execute path, each against the JAX package on the
same numpy inputs.  Dilation uses only JAX's maximum, so every comparison
is exact, and those on images with NaN, signed zeros and infinities
compare bits (NaN where both are NaN)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.apps import stencil as jax_stencil
from repro.exec import execute as jax_execute
from repro.kernels.stencil_dilate.ref import (
    dilate_iters_ref as jax_dilate_iters)
from repro_torch.apps import stencil
from repro_torch.kernels import dilate_op
from repro_torch.kernels.stencil_dilate.images import (KINDS, SPECIALS,
                                                       dilate_image)
from repro_torch.kernels.stencil_dilate.ref import (bit_mismatches,
                                                    dilate_iters_ref,
                                                    jax_maximum)

from _torch_parity import channel_bytes, designs


def _from_jax(x) -> torch.Tensor:
    """A JAX array as a CPU tensor of its own (JAX's buffer is read-only)."""
    return torch.tensor(np.asarray(x))


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


def test_jax_maximum_is_jnp_maximum_bit_for_bit():
    a, b = (x.ravel() for x in np.meshgrid(SPECIALS, SPECIALS))
    want = _from_jax(jnp.maximum(jnp.asarray(a), jnp.asarray(b)))
    got = jax_maximum(torch.from_numpy(a), torch.from_numpy(b))
    assert bit_mismatches(got, want) == 0
    got = got.numpy()
    # -0.0 below +0.0 in either order, whatever the CPU's tie rule.
    assert not np.signbit(got[(a == 0) & (b == 0)
                              & (np.signbit(a) != np.signbit(b))]).any()


def test_bit_mismatches_counts_signs_and_nans():
    want = torch.tensor([0.0, -0.0, float("nan"), 1.0, float("nan")])
    got = torch.tensor([-0.0, -0.0, float("nan"), float("nan"), 2.0])
    assert bit_mismatches(got, want) == 3
    assert bit_mismatches(want, want) == 0
    with pytest.raises(ValueError):
        bit_mismatches(got[:2], want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w,iters,br", [
    (16, 8, 1, 8), (37, 53, 2, 37), (64, 48, 3, 32),
])
def test_dilate_matches_jax_bit_for_bit(kind, h, w, iters, br):
    img = dilate_image(kind, h, w, seed=h + w)
    want_ref = _from_jax(jax_dilate_iters(jnp.asarray(img), iters))
    want_kernel = _from_jax(jk.dilate_op(jnp.asarray(img), iters=iters,
                                         block_rows=br))
    assert bit_mismatches(want_kernel, want_ref) == 0
    t = torch.from_numpy(img)
    assert bit_mismatches(dilate_iters_ref(t, iters), want_ref) == 0
    assert bit_mismatches(dilate_op(t, iters=iters, block_rows=br),
                          want_kernel) == 0


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


def test_execute_bit_for_bit_with_special_values(monkeypatch):
    """The stencil app's CPU ``execute()`` on images with NaN, signed zeros
    and infinities against the JAX package's ``execute`` on the same
    images: NaN where both are NaN, every other bit equal."""
    ndev, h, w = 2, 40, 37
    spec = {"h": h, "w": w, "stage_iters": 2, "streams": 3, "seed": 5}
    imgs = np.stack([dilate_image(kind, h, w, seed=s) for s, kind in
                     enumerate(("specials", "zero_checkerboard",
                                "zeros_and_negatives"))])
    monkeypatch.setattr(stencil, "make_inputs",
                        lambda graph, spec=None: {"imgs": imgs.copy()})
    port, ref = designs("stencil", ndev)
    got = port.execute(spec, device="cpu")

    binding = jax_stencil.bind_programs(ref.graph, spec)
    binding = dataclasses.replace(binding, source_inputs={
        task: [jnp.asarray(img) for img in imgs]
        for task in binding.source_inputs})
    want = jax_execute(ref, binding)
    assert bit_mismatches(got.outputs, _from_jax(want.outputs)) == 0
    assert np.isnan(got.outputs[0].numpy()).any()
    assert (got.outputs[1].numpy() == 0).all()       # the zero checkerboard
    assert got.report.agreement() == want.report.agreement()


def test_make_inputs_is_seeded():
    g = stencil.build_graph(2)
    a = stencil.make_inputs(g, {"h": 8, "w": 8, "streams": 2, "seed": 3})
    b = stencil.make_inputs(g, {"h": 8, "w": 8, "streams": 2, "seed": 3})
    np.testing.assert_array_equal(a["imgs"], b["imgs"])
    assert a["imgs"].shape == (2, 8, 8) and a["imgs"].dtype == np.float32
