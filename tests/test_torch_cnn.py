"""PyTorch port, CNN slice: the systolic matmul / im2col conv module, the
compiler copy and the whole compile → execute path, each against the JAX
package on the same numpy inputs.  Products reorder their fp32 sums, so
values agree within 2e-4 of the output's scale (the CNN binding's atol)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.exec import execute as jax_execute
from repro_torch.apps import cnn
from repro_torch.kernels import conv_op, matmul_op
from repro_torch.kernels.systolic_matmul.ref import (conv_im2col_ref,
                                                     matmul_ref)

from _torch_parity import channel_bytes, designs, scaled_err

TOL = 2e-4


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (256, 256, 256, 128, 128, 128),
    (300, 200, 150, 128, 128, 64),            # ragged
    (64, 512, 64, 64, 64, 256),
    (1024, 576, 4, 256, 256, 256),            # the CNN column's skinny product
])
def test_matmul_matches_jax(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((M, K), dtype=np.float32)
    b = rng.standard_normal((K, N), dtype=np.float32)
    want = np.asarray(jk.matmul_op(jnp.asarray(a), jnp.asarray(b),
                                   bm=bm, bn=bn, bk=bk))
    got = matmul_op(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert scaled_err(got.numpy(), want) <= TOL
    assert scaled_err(matmul_ref(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy(), want) <= TOL


@pytest.mark.parametrize("h,w,cin,cout", [(16, 16, 32, 64), (7, 9, 5, 3)])
def test_conv_matches_jax(h, w, cin, cout):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((h, w, cin), dtype=np.float32)
    wt = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.1
    want = np.asarray(jk.conv_op(jnp.asarray(x), jnp.asarray(wt)))
    got = conv_op(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.shape == (h, w, cout)
    assert scaled_err(got.numpy(), want) <= TOL
    assert scaled_err(conv_im2col_ref(torch.from_numpy(x),
                                      torch.from_numpy(wt)).numpy(),
                      want) <= TOL


@pytest.mark.parametrize("ndev", [2, 4])
def test_compile_matches_jax(ndev):
    port, ref = designs("cnn", ndev)
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost
    assert (port.pipeline_report.added_latency
            == ref.pipeline_report.added_latency)
    assert ([c.depth for c in port.graph.channels]
            == [c.depth for c in ref.graph.channels])


@pytest.mark.parametrize("ndev", [2, 4])
def test_execute_matches_jax(ndev):
    spec = {"h": 8, "w": 8, "cin": 8, "cout_per_col": 2, "streams": 2,
            "seed": 7}
    port, ref = designs("cnn", ndev)
    got = port.execute(spec, device="cpu")
    want = jax_execute(ref, inputs=spec)

    arrays = cnn.make_inputs(port.graph, spec)
    single = np.stack([np.asarray(jk.conv_op(jnp.asarray(x),
                                             jnp.asarray(arrays["wgt"])))
                       for x in arrays["xs"]])
    assert got.outputs.shape == single.shape
    assert scaled_err(got.outputs.numpy(), single) <= TOL

    assert got.report.sweeps == want.report.sweeps
    assert channel_bytes(got.report) == channel_bytes(want.report)
    assert got.report.agreement() == want.report.agreement()
    assert all(got.report.agreement().values())
    assert not got.report.starvation_events
