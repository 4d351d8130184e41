"""PyTorch port on the card: each hand-written CUDA kernel against its plain
version, the launch counters, and a small compile → execute on ``cuda``.

Every test here carries the ``gpu`` marker and skips without a CUDA card
(decided in the fixture, never at import).  On a machine with one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import APPS
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import fpga_ring_cluster
from repro_torch.kernels import (conv_op, dilate_op, knn_op, launch_counts,
                                 matmul_op, reset_launch_counts)
from repro_torch.kernels.knn.ref import knn_ref
from repro_torch.kernels.stencil_dilate.ref import dilate_iters_ref
from repro_torch.kernels.systolic_matmul.ref import (conv_im2col_ref,
                                                     matmul_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dev)


@pytest.mark.parametrize("h,w,iters,br", [
    (256, 128, 1, 64), (256, 128, 3, 128), (37, 53, 2, 16), (1, 1, 2, 256),
    (4096, 64, 4, 256),
])
def test_dilate_kernel_is_exact(cuda, h, w, iters, br):
    img = _randn(cuda, h, w)
    got = dilate_op(img, iters=iters, block_rows=br)
    assert torch.equal(got, dilate_iters_ref(img, iters))


@pytest.mark.parametrize("M,K,N", [
    (1024, 576, 4), (1024, 576, 80), (300, 200, 150), (1, 1, 1),
    (65, 17, 129),
])
def test_matmul_kernel(cuda, M, K, N):
    a, b = _randn(cuda, M, K, seed=1), _randn(cuda, K, N, seed=2)
    want = matmul_ref(a, b)
    got = matmul_op(a, b)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-4 * scale


def test_conv_kernel(cuda):
    x, w = _randn(cuda, 32, 32, 64, seed=3), _randn(cuda, 3, 3, 64, 8) * 0.05
    assert float((conv_op(x, w) - conv_im2col_ref(x, w)).abs().max()) <= 2e-4


@pytest.mark.parametrize("Q,N,D,k", [
    (128, 55_556, 16, 10), (33, 999, 32, 10), (200, 5000, 8, 20),
    (1, 10, 64, 10), (130, 300, 3, 1),
    # the general path: D > 64 or k > 32
    (130, 20_000, 128, 10), (64, 5000, 16, 64), (33, 3000, 100, 40),
    (5, 100, 65, 33), (3, 40, 1, 40),
])
def test_knn_kernel(cuda, Q, N, D, k):
    q, x = _randn(cuda, Q, D, seed=4), _randn(cuda, N, D, seed=5)
    gd, gi = knn_op(q, x, k)
    rd, ri = knn_ref(q, x, k)
    assert gi.dtype == torch.int32
    assert float((gd - rd).abs().max()) <= 1e-4
    assert torch.equal(gi, ri)


def test_knn_kernel_ties_go_to_the_lower_index(cuda):
    x = torch.zeros(1000, 4, device=cuda)
    x[::3] = 1.0
    q = torch.zeros(2, 4, device=cuda)
    _, gi = knn_op(q, x, 12)
    _, ri = knn_ref(q, x, 12)
    assert torch.equal(gi, ri)


def test_launch_counters(cuda):
    reset_launch_counts()
    img = _randn(cuda, 64, 64)
    dilate_op(img, iters=3)
    matmul_op(_randn(cuda, 8, 8), _randn(cuda, 8, 8))
    knn_op(_randn(cuda, 4, 4), _randn(cuda, 40, 4), 3)
    assert launch_counts() == {"dilate": 3, "matmul": 1, "knn": 1}


@pytest.mark.parametrize("app", ["stencil", "cnn", "knn"])
def test_execute_on_cuda(cuda, app):
    graph = APPS[app].build_graph(2)
    design = compile(graph, fpga_ring_cluster(2),
                     CompileOptions(balance_kind="LUT", balance_tol=0.8,
                                    floorplan_devices=()))
    on_gpu = design.execute(fabric=None)
    on_cpu = design.execute(fabric=None, device="cpu")
    got, want = on_gpu.outputs, on_cpu.outputs
    if isinstance(got, tuple):
        assert torch.equal(got[1].cpu(), want[1])
        got, want = got[0], want[0]
    assert float((got.cpu() - want).abs().max()) <= 2e-4
    assert on_gpu.report.sweeps == on_cpu.report.sweeps
    assert on_gpu.report.agreement() == on_cpu.report.agreement()
