"""PyTorch port on the card: each hand-written CUDA kernel against its plain
version (the BLAS kernels also whole array against shards, bit for bit),
the launch counters, a small compile → execute on ``cuda`` (the HBM apps
through the bank model and the ideal path), PageRank at 2^20 edges (its
fixed-order segment sums: the same bits on every run and through the
fabric), the LM serving side's prefill (flash attention kernel, MLA's
head dims on the tensor cores in bf16 and the CUDA cores in fp32) against
its cached decode, and training: the flash op's gradient (kernel forward,
``backward.py``) at each tensor-core instance, RG-LRU's scan under
autograd, and a train step on the card against the CPU's (the recurrent
archs too).

Every test here carries the ``gpu`` marker and skips without a CUDA card
(decided in the fixture, never at import).  On a machine with one:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.apps import APPS
from repro_torch.apps import knn as knn_app
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import fpga_ring_cluster
from repro_torch.exec import bind_programs, execute
from repro_torch.kernels import (axpy_op, build, conv_op, dilate_op, dot_op,
                                 dot_partials_op, flash_attention_op,
                                 gemv_op, knn_op,
                                 launch_counts, matmul_op,
                                 reset_launch_counts)
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.hbm_blas.kernel import gemv_vector_loads
from repro_torch.kernels.hbm_blas.ref import (axpy_ref, dot_partials_ref,
                                              gemv_ref)
from repro_torch.kernels.knn.kernel import split_ranges
from repro_torch.kernels.knn.ref import knn_ref
from repro_torch.kernels.stencil_dilate.images import KINDS, dilate_image
from repro_torch.kernels.stencil_dilate.kernel import dilate
from repro_torch.kernels.stencil_dilate.ref import (bit_mismatches,
                                                    dilate_iters_ref,
                                                    dilate_ref)
from repro_torch.kernels.systolic_matmul.kernel import route as matmul_route
from repro_torch.kernels.systolic_matmul.ref import (conv_im2col_ref,
                                                     matmul_ref)
from repro_torch.mem import MemConfig
from repro_torch.net import cluster_fabric

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
    assert bit_mismatches(got, dilate_iters_ref(img, iters)) == 0


# The dilate kernel against its plain version, bit for bit (NaN where both
# are NaN): the main path's shape and tile height; widths that are not a
# multiple of 4 (the 4-byte path) and ragged heights; 1 x 1; every tile
# height the wrapper takes at its edges; each on every image kind.
DILATE_SHAPES = [
    (4096, 4096, 128), (37, 53, 37), (130, 1031, 16), (5, 6, 1), (1, 1, 128),
    (300, 260, 1), (300, 260, 16), (300, 260, 37), (300, 260, 128),
    (300, 260, 256), (300, 260, 1024), (1030, 516, 1024), (64, 4096, 37),
]


@pytest.mark.parametrize("kind", ["normal", *KINDS])
@pytest.mark.parametrize("h,w,br", DILATE_SHAPES)
def test_dilate_kernel_bits(cuda, h, w, br, kind):
    if kind == "normal":
        img = _randn(cuda, h, w, seed=h + w)
    else:
        img = torch.from_numpy(dilate_image(kind, h, w, seed=h + w)).to(cuda)
    got = dilate_op(img, iters=1, block_rows=br)
    assert bit_mismatches(got, dilate_ref(img)) == 0
    got2 = dilate_op(img, iters=2, block_rows=br)
    assert bit_mismatches(got2, dilate_iters_ref(img, 2)) == 0


@pytest.mark.parametrize("kind", ["specials", "zero_checkerboard"])
@pytest.mark.parametrize("h,w", [(37, 53), (64, 96), (33, 128)])
def test_dilate_kernel_bits_on_unaligned_views(cuda, h, w, kind):
    """Images that are ``unbind(0)`` views of one [2, h, w] tensor, as the
    stencil app hands them over (the second is 16-byte aligned only when
    h * w % 4 == 0), and views one float past an aligned start, in and
    out: the 4-byte path must give the same bits."""
    imgs = torch.from_numpy(np.stack([
        dilate_image(kind, h, w, seed=s) for s in range(2)])).to(cuda)
    for img in imgs.unbind(0):
        assert bit_mismatches(dilate_op(img, iters=2, block_rows=16),
                              dilate_iters_ref(img, 2)) == 0
    src = torch.empty(h * w + 1, device=cuda)[1:].view(h, w)
    src.copy_(imgs[0])
    dst = torch.empty(h * w + 1, device=cuda)[1:].view(h, w)
    dilate(src, dst, block_rows=37)
    assert bit_mismatches(dst, dilate_ref(imgs[0])) == 0
    aligned_dst = torch.empty_like(imgs[0])
    dilate(imgs[0], aligned_dst, block_rows=37)
    assert bit_mismatches(aligned_dst, dst) == 0


@pytest.mark.parametrize("M,K,N", [
    (1024, 576, 4), (1024, 576, 80), (300, 200, 150), (1, 1, 1),
    (65, 17, 129),
    # The narrow kernel (N <= 16): N = 1, 4, 16; ragged M; K % 4 != 0
    # (scalar loads of A).
    (1024, 576, 1), (1024, 576, 16), (1001, 576, 4), (1024, 575, 4),
    (37, 1001, 3),
    # The tiled kernel (N > 16): CNN's run_numeric default and a VGG-16
    # conv3 layer (the rows' products), just past the narrow route,
    # K % 4 != 0 at the CNN's size, and a deep K split.
    (1024, 576, 64), (3136, 2304, 256), (1024, 576, 17), (1024, 575, 64),
    (64, 4096, 64),
])
def test_matmul_kernel(cuda, M, K, N):
    a, b = _randn(cuda, M, K, seed=1), _randn(cuda, K, N, seed=2)
    want = matmul_ref(a, b)
    got = matmul_op(a, b)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-4 * scale
    assert matmul_route(M, K, N) == ("narrow" if N <= 16 else "tiled")
    assert torch.equal(got, matmul_op(a, b))       # deterministic


def test_conv_kernel(cuda):
    x, w = _randn(cuda, 32, 32, 64, seed=3), _randn(cuda, 3, 3, 64, 8) * 0.05
    assert float((conv_op(x, w) - conv_im2col_ref(x, w)).abs().max()) <= 2e-4


@pytest.mark.parametrize("Q,N,D,k,row0", [
    (128, 55_556, 16, 10, 0), (33, 999, 32, 10, 0), (200, 5000, 8, 20, 0),
    (1, 10, 64, 10, 0), (130, 300, 3, 1, 0),
    # the range geometry's edges: N not a multiple of the 256-point range
    # granule nor of a tile; Q = 1; Q not a multiple of the 32 queries of
    # a block; k = N at the list's full length; a shard view with D = 3 at
    # a row offset (rows 12 bytes apart: 4-byte copies)
    (64, 40_007, 16, 10, 0), (1, 5000, 16, 10, 0), (100, 3000, 16, 10, 0),
    (7, 16, 16, 16, 0), (45, 32, 32, 32, 0), (50, 4099, 3, 10, 1),
    # the general path: D > 64 or k > 32
    (130, 20_000, 128, 10, 0), (64, 5000, 16, 64, 0), (33, 3000, 100, 40, 0),
    (5, 100, 65, 33, 0), (3, 40, 1, 40, 0),
])
def test_knn_kernel(cuda, Q, N, D, k, row0):
    q = _randn(cuda, Q, D, seed=4)
    x = _randn(cuda, N + row0, D, seed=5)[row0:]
    gd, gi = knn_op(q, x, k)
    rd, ri = knn_ref(q, x, k)
    assert gi.dtype == torch.int32
    assert float((gd - rd).abs().max()) <= 1e-4
    assert torch.equal(gi, ri)


@pytest.mark.parametrize("data", ["random", "integer_ties"])
def test_knn_shards_merge_to_the_whole(cuda, data):
    """The op on S contiguous views, each view's offset added, merged by
    the app's ``_merge_topk``, equals one call on the whole array bit for
    bit: a pair's distance does not depend on the range split.  The
    integer-valued data put exact ties everywhere, and copies of the rows
    at every range and shard boundary make equal points cross blocks."""
    N, D, Q, k, S = 60_000, 16, 128, 10, 7
    rng = np.random.default_rng(17)
    if data == "random":
        xn = rng.standard_normal((N, D), dtype=np.float32)
        qn = rng.standard_normal((Q, D), dtype=np.float32)
    else:
        xn = rng.integers(-2, 3, (N, D)).astype(np.float32)
        qn = rng.integers(-2, 3, (Q, D)).astype(np.float32)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        tile = build.library().repro_knn_tile()
        per_block, _ = split_ranges(N, Q, sms, tile)
        cuts = list(range(per_block, N, per_block)) + [
            int(c) for c in np.linspace(0, N, S + 1)[1:-1]]
        for c in cuts:
            xn[c - 2:c + 2] = xn[c]
    x, q = torch.from_numpy(xn).to(cuda), torch.from_numpy(qn).to(cuda)
    wd, wi = knn_op(q, x, k)
    bounds = np.linspace(0, N, S + 1).astype(int)
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        d, i = knn_op(q, x[lo:hi], k)
        parts.append((d, i + int(lo)))
    md, mi = knn_app._merge_topk(parts, k)
    assert torch.equal(md, wd) and torch.equal(mi, wi)
    rd, ri = knn_ref(q, x, k)
    assert float((wd - rd).abs().max()) <= 1e-4
    if data == "integer_ties":
        assert torch.equal(wd, rd) and torch.equal(wi, ri)


def test_knn_kernel_ties_go_to_the_lower_index(cuda):
    x = torch.zeros(1000, 4, device=cuda)
    x[::3] = 1.0
    q = torch.zeros(2, 4, device=cuda)
    _, gi = knn_op(q, x, 12)
    _, ri = knn_ref(q, x, 12)
    assert torch.equal(gi, ri)


# The BLAS shapes: ragged ones (n % 4 != 0; n = 3 and 14, under one axpy
# thread's 16 elements), a shard of the main path ([65536, 128], gemv
# [1024, 8192]) and the whole main-path array with block_rows = br.
BLAS_SHAPES = [(16, 128, 4), (37, 53, 37), (100, 7, 25), (3, 1, 1),
               (2, 7, 1), (65, 4099, 13), (65536, 128, 65536),
               (524288, 128, 65536)]
SUM_REL = 1e-6     # gemv, of Σ|terms|: two fp32 summation orders


def _dot_tol(n):
    """dot_partials' limit, of Σ|terms|, for blocks of ``n`` random-sign
    products: fp32 rounding of such a sum grows like sqrt(n log n) while
    Σ|terms| grows like n, so 64 ulps of that scale (6.5e-9 at a
    main-path block of 8.4 M terms, where one dropped term is 1.2e-7)."""
    return 64 * 2.0 ** -24 * math.sqrt(math.log2(n) + 1) / math.sqrt(n)


def _sum_err(got, want, terms):
    return float(((got - want).abs() / terms.clamp_min(1e-30)).max())


@pytest.mark.parametrize("R,C,br", BLAS_SHAPES)
def test_axpy_kernel_is_exact(cuda, R, C, br):
    x, y = _randn(cuda, R, C, seed=6), _randn(cuda, R, C, seed=7)
    assert torch.equal(axpy_op(1.5, x, y, block_rows=br),
                       axpy_ref(1.5, x, y, block_rows=br))


@pytest.mark.parametrize("R,C,br", BLAS_SHAPES)
def test_dot_partials_kernel(cuda, R, C, br):
    x, y = _randn(cuda, R, C, seed=8), _randn(cuda, R, C, seed=9)
    got = dot_partials_op(x, y, block_rows=br)
    want = dot_partials_ref(x, y, block_rows=br)
    terms = (x * y).abs().reshape(R // br, -1).sum(1, keepdim=True)
    assert got.shape == want.shape
    assert _sum_err(got, want, terms) <= _dot_tol(br * C)


# gemv's edges beside the BLAS shapes: the main path; M = 1; M below the
# SM count; M odd; N = 65536, several batches of loads a thread.
GEMV_SHAPES = BLAS_SHAPES[:-2] + [(8192, 8192, 1024), (1, 8192, 1),
                                  (100, 8192, 25), (37, 1000, 37),
                                  (64, 65536, 16)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("R,C,br", GEMV_SHAPES)
def test_gemv_kernel(cuda, R, C, br, offset):
    """Within SUM_REL of the plain version, the whole array equal to its
    shards bit for bit; ``offset = 1`` puts A 4 bytes past an aligned
    start (the scalar path), bit for bit equal to its aligned copy."""
    A = _randn(cuda, R * C + offset, seed=10)[offset:].view(R, C)
    x = _randn(cuda, 1, C, seed=11)
    assert gemv_vector_loads(A, x) == (offset == 0 and C % 4 == 0)
    got = gemv_op(A, x, block_rows=br)
    want = gemv_ref(A, x, block_rows=br)
    assert got.shape == want.shape == (R, 1)
    assert _sum_err(got, want, (A * x).abs().sum(1, keepdim=True)) \
        <= SUM_REL
    assert torch.equal(got, torch.cat([gemv_op(A[i:i + br], x, block_rows=br)
                                       for i in range(0, R, br)]))
    if offset:
        assert torch.equal(got, gemv_op(A.clone(), x, block_rows=br))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("op", ["axpy", "dot_partials", "gemv"])
@pytest.mark.parametrize("R,C,br", [(96, 40, 24), (48, 4099, 16),
                                    (6, 7, 2), (524288, 128, 65536)])
def test_blas_whole_array_equals_shards(cuda, op, R, C, br, offset):
    """Bit for bit: the op over the whole array with block_rows = br and
    the op over each [br, C] shard, views and copies alike; ``offset = 1``
    puts x 4 bytes past an aligned start (scalar loads).  axpy is also
    exact against its plain version there."""
    x = _randn(cuda, R * C + offset, seed=12)[offset:].view(R, C)
    y = _randn(cuda, R, C, seed=13)
    vec = _randn(cuda, 1, C, seed=14)
    calls = {"axpy": lambda a, b: axpy_op(1.5, a, b, block_rows=br),
             "dot_partials": lambda a, b: dot_partials_op(a, b,
                                                          block_rows=br),
             "gemv": lambda a, b: gemv_op(a, vec, block_rows=br)}
    whole = calls[op](x, y)
    if op == "axpy":
        assert torch.equal(whole, axpy_ref(1.5, x, y, block_rows=br))
    for copy in (False, True):
        parts = [(x[i:i + br], y[i:i + br]) for i in range(0, R, br)]
        if copy:
            parts = [(a.clone(), b.clone()) for a, b in parts]
        assert torch.equal(whole, torch.cat([calls[op](a, b)
                                             for a, b in parts]))


def test_dot_kernel_unaligned_operands(cuda):
    base = _randn(cuda, 1, 4097, seed=15)
    x = base[0, 1:].reshape(16, 256)            # 4-byte aligned only
    y = _randn(cuda, 16, 256, seed=16)
    got = dot_partials_op(x, y, block_rows=4)
    want = dot_partials_ref(x, y, block_rows=4)
    terms = (x * y).abs().reshape(4, -1).sum(1, keepdim=True)
    assert _sum_err(got, want, terms) <= _dot_tol(4 * 256)
    xc = x.clone()                               # 16-byte aligned copy
    assert torch.equal(got, dot_partials_op(xc, y, block_rows=4))


def test_matmul_tiled_on_a_misaligned_view(cuda):
    """An A with K % 4 == 0 whose base lies 4 bytes past a 16-byte
    boundary (a [M, K] view of a flat buffer from element 1) takes the
    4-byte path: within 2e-4 of the scale, the same bits on two runs, and
    the aligned copy's bits (the same products in the same order)."""
    M, K, N = 1024, 576, 64
    flat = _randn(cuda, M * K + 1, seed=3)
    a = flat[1:].view(M, K)
    b = _randn(cuda, K, N, seed=4) * 0.05
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    want = matmul_ref(a, b)
    got = matmul_op(a, b)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-4 * scale
    assert torch.equal(got, matmul_op(a, b))
    assert torch.equal(got, matmul_op(a.clone(), b))


def test_launch_counters(cuda):
    reset_launch_counts()
    img = _randn(cuda, 64, 64)
    dilate_op(img, iters=3)
    matmul_op(_randn(cuda, 8, 8), _randn(cuda, 8, 8))       # narrow
    matmul_op(_randn(cuda, 8, 8), _randn(cuda, 8, 32))      # tiled
    knn_op(_randn(cuda, 4, 4), _randn(cuda, 40, 4), 3)
    v = _randn(cuda, 8, 8)
    axpy_op(2.0, v, v, block_rows=4)
    dot_op(v, v, block_rows=2)
    gemv_op(v, v[:1], block_rows=8)
    gemv_op(v, v[:1], block_rows=8)
    q = _randn(cuda, 1, 2, 8, 16)
    flash_attention_op(q, q, q)                     # the CUDA cores
    qb = _randn(cuda, 1, 2, 8, 64).bfloat16()
    flash_attention_op(qb, qb, qb)                  # the tensor cores
    assert launch_counts() == {"dilate": 3, "matmul": 2, "matmul_tiled": 1,
                               "knn": 1,
                               "axpy": 1, "dot_partials": 1, "gemv": 2,
                               "flash_attention": 2,
                               "flash_attention_tc": 1}


HBM_APPS = ["axpy", "dot", "gemv", "axpydot"]


@pytest.mark.parametrize("app", ["stencil", "pagerank", "cnn", "knn"]
                         + HBM_APPS)
def test_execute_on_cuda(cuda, app):
    graph = APPS[app].build_graph(2)
    mem = (MemConfig(banks_per_device=4, bank_bandwidth_Bps=2e9, credits=4,
                     burst_bytes=512) if app in HBM_APPS else None)
    design = compile(graph, fpga_ring_cluster(2),
                     CompileOptions(balance_kind="LUT", balance_tol=0.8,
                                    floorplan_devices=(), mem=mem))
    on_gpu = design.execute(fabric=None)
    on_cpu = design.execute(fabric=None, device="cpu")
    got, want = on_gpu.outputs, on_cpu.outputs
    if isinstance(got, tuple):
        assert torch.equal(got[1].cpu(), want[1])
        got, want = got[0], want[0]
    assert got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= 2e-4
    assert on_gpu.report.sweeps == on_cpu.report.sweeps
    assert on_gpu.report.agreement() == on_cpu.report.agreement()
    assert all(on_gpu.report.agreement().values())
    if app in HBM_APPS:
        binding = bind_programs(graph)
        banked = execute(design, binding)
        ideal = execute(design, binding, mem=None)
        assert torch.equal(banked.outputs, ideal.outputs)
        assert torch.equal(banked.outputs, binding.reference())
        assert banked.report.sweeps > ideal.report.sweeps


PAGERANK_MID = {"n_nodes": 1 << 17, "n_edges": 1 << 20, "iters": 10,
                "seed": 0}


def test_pagerank_mid_size_bits(cuda):
    """2^20 edges on a 4-ring: two card runs give the same bits, the fabric
    path gives the ideal path's bits, and the rank is within 1e-5 of its
    largest value of the CPU run's (in fact it has the CPU run's bits: the
    segment sums add in the same order on both)."""
    cluster = fpga_ring_cluster(4)
    design = compile(APPS["pagerank"].build_graph(4), cluster,
                     CompileOptions(balance_kind="LUT", balance_tol=0.8,
                                    floorplan_devices=(),
                                    fabric=cluster_fabric(cluster)))
    binding = bind_programs(design.graph, PAGERANK_MID)
    ideal = execute(design, binding, fabric=None).outputs
    again = execute(design, binding, fabric=None).outputs
    via_net = execute(design, binding)
    assert ideal.is_cuda and torch.isfinite(ideal).all()
    assert torch.equal(ideal.view(torch.int32), again.view(torch.int32))
    assert torch.equal(ideal.view(torch.int32),
                       via_net.outputs.view(torch.int32))
    assert all(via_net.report.agreement().values())
    on_cpu = design.execute(PAGERANK_MID, fabric=None, device="cpu").outputs
    scale = float(on_cpu.abs().max())
    assert float((ideal.cpu() - on_cpu).abs().max()) <= 1e-5 * scale
    assert torch.equal(ideal.cpu().view(torch.int32), on_cpu.view(torch.int32))
    ref = binding.reference()
    assert float((ideal - ref).abs().max()) <= 1e-5 * scale


# -- flash attention ----------------------------------------------------------

FLASH_SHAPES = [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 64, 64, 32),       # GQA
    (1, 8, 1, 128, 128, 64),     # MQA
    (1, 2, 2, 64, 256, 64),      # decode-style Sq<Sk
    (1, 2, 2, 100, 200, 64),     # unaligned
    (2, 4, 2, 70, 70, 128),      # unaligned, d = 128
    (1, 4, 4, 33, 90, 8),        # small head dim
    (1, 16, 1, 128, 128, 256),   # recurrentgemma's MQA, d = dv = 256
    (2, 16, 1, 70, 130, 256),    # the same, ragged, Sq < Sk
    (1, 14, 2, 128, 128, 128),   # llava-next-34b's G = 7
    (2, 14, 2, 100, 157, 64),    # G = 7, ragged, Sq < Sk
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(dev, B, H, K, Sq, Sk, d, dtype, seed=0):
    return (_randn(dev, B, H, Sq, d, seed=seed).to(dtype),
            _randn(dev, B, K, Sk, d, seed=seed + 1).to(dtype),
            _randn(dev, B, K, Sk, d, seed=seed + 2).to(dtype))


def _max_abs(got, want):
    return float((got.float() - want.float()).abs().max())


def _flash_err(q, k, v, **kw):
    """The kernel's largest error from the plain version.  The call takes
    the kernel that ``route`` names (read on the counters).  A bf16 call is
    also held row by row; on the tensor cores, the CUDA-core kernel on the
    same inputs is held to the same limits, and the tensor cores may lie at
    most twice its error from the fp32 plain version (both round p and the
    output at the same places).  The output is [B, H, Sq, dv]."""
    reset_launch_counts()
    got = flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    assert got.shape == (*q.shape[:3], v.shape[3])
    on_tc = flash_kernel.route(q, k, v) == "tensor_core"
    assert launch_counts()["flash_attention"] == 1
    assert launch_counts()["flash_attention_tc"] == int(on_tc)
    want = attention_ref(q, k, v, **kw)
    if q.dtype == torch.bfloat16:
        assert flash_cases.row_rel_err(got, want) <= flash_cases.ROW_REL_LIMIT
    if on_tc:
        cuda_core = flash_kernel._launch_cuda_core(q, k, v, **kw)
        assert flash_cases.excess(cuda_core, want) <= flash_cases.ATOL
        assert flash_cases.row_rel_err(cuda_core, want) <= \
            flash_cases.ROW_REL_LIMIT
        exact = attention_ref(q.float(), k.float(), v.float(), **kw)
        assert _max_abs(got, exact) <= 2 * _max_abs(cuda_core, exact)
    return _max_abs(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,d", FLASH_SHAPES)
def test_flash_attention_kernel_shapes(cuda, B, H, K, Sq, Sk, d, dtype):
    assert _flash_err(*_qkv(cuda, B, H, K, Sq, Sk, d, dtype)) <= \
        FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,d", [
    (1, 4, 4, 256, 96, 64),      # Sk ends inside a key tile
    (2, 16, 16, 512, 128, 64),   # seamless's cross attention, cut
    (1, 14, 2, 200, 77, 128),    # G = 7
])
def test_flash_attention_noncausal_sq_gt_sk(cuda, B, H, K, Sq, Sk, d, dtype):
    """No mask with more queries than keys (delta = Sk - Sq < 0), as
    seamless's cross attention runs it: every query sees every key."""
    assert _flash_err(*_qkv(cuda, B, H, K, Sq, Sk, d, dtype),
                      causal=False) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,kwargs",
                         [case[1:] for case in flash_cases.FEATURE_CASES],
                         ids=[case[0] for case in flash_cases.FEATURE_CASES])
def test_flash_attention_kernel_features(cuda, shape, kwargs, d, dtype):
    """Every feature case in fp32 (the CUDA cores) and bf16 (the tensor
    cores, at both of their head dims)."""
    q, k, v = _qkv(cuda, *shape, d, dtype)
    assert flash_kernel.route(q, k, v) == \
        ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    assert _flash_err(q, k, v, **kwargs) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kwargs",
                         [case[1:] for case in flash_cases.HD256_CASES],
                         ids=[case[0] for case in flash_cases.HD256_CASES])
def test_flash_attention_head_dim_256(cuda, shape, kwargs, dtype):
    """The (256, 256) instances (recurrentgemma-9b's local attention) on
    their cases, a window that bites and the 64-key tile's edges among
    them: bf16 on the tensor cores (``_flash_err`` holds the CUDA-core
    kernel beside it and their errors from fp32), fp32 on the CUDA cores;
    the plain version's output within the flash limits (bf16 also row by
    row)."""
    q, k, v = _qkv(cuda, *shape, 256, dtype)
    assert flash_kernel.route(q, k, v) == \
        ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    assert _flash_err(q, k, v, **kwargs) <= FLASH_TOL[dtype]
    if dtype == torch.bfloat16:
        got = flash_attention_op(q, k, v, **kwargs)
        assert flash_cases.excess(got, attention_ref(q, k, v, **kwargs)) \
            <= flash_cases.ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_leading_block(cuda, dtype):
    """Window 40 with Sk - Sq = 192: the first kv tiles of the last query
    rows are fully masked (the -1e30 rule, wiped by alpha = 0)."""
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 256, 64, dtype)
    assert _flash_err(q, k, v, window=40) <= FLASH_TOL[dtype]
    assert _flash_err(q, k, v, window=3, softcap=5.0) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_strided_views(cuda, dtype):
    """[B,S,H,d] tensors seen as [B,H,S,d]: read through strides (bf16 by
    TMA), the output laid out like q; a misaligned view takes the CUDA
    cores' scalar loads."""
    q = _randn(cuda, 2, 96, 8, 64).to(dtype).transpose(1, 2)
    k = _randn(cuda, 2, 96, 4, 64, seed=1).to(dtype).transpose(1, 2)
    v = _randn(cuda, 2, 96, 4, 64, seed=2).to(dtype).transpose(1, 2)
    assert flash_kernel.route(q, k, v) == \
        ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    got = flash_attention_op(q, k, v)
    assert got.transpose(1, 2).is_contiguous()
    assert _flash_err(q, k, v) <= FLASH_TOL[dtype]
    base = _randn(cuda, 1, 2, 40, 65).to(dtype)
    qm = base[..., 1:]                       # rows 2 or 4 bytes off 16
    assert flash_kernel.route(qm, qm, qm) == "cuda_core"
    assert _flash_err(qm, qm, qm, window=7) <= FLASH_TOL[dtype]


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    q = _randn(cuda, 1, 2, 8, 16)
    with pytest.raises(TypeError):
        flash_attention_op(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="d <= 256"):
        flash_attention_op(*(_randn(cuda, 1, 1, 4, 257),) * 3)
    with pytest.raises(ValueError, match="dv <= 256"):
        flash_attention_op(_randn(cuda, 1, 1, 4, 192),
                           _randn(cuda, 1, 1, 4, 192),
                           _randn(cuda, 1, 1, 4, 264))
    with pytest.raises(ValueError, match="H % K"):
        flash_attention_op(q, _randn(cuda, 1, 3, 8, 16),
                           _randn(cuda, 1, 3, 8, 16))
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        flash_kernel._launch_tensor_core(q, q, q)
    # bf16 and aligned, but (128, 64) is no pair of the tensor cores.
    qb = _randn(cuda, 1, 2, 8, 128).bfloat16()
    vb = _randn(cuda, 1, 2, 8, 64).bfloat16()
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        flash_kernel._launch_tensor_core(qb, qb, vb)


MLA_HEAD_DIMS = [(192, 128), (24, 16), (128, 64), (72, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", MLA_HEAD_DIMS)
@pytest.mark.parametrize("shape,kwargs",
                         [case[1:] for case in flash_cases.FEATURE_CASES],
                         ids=[case[0] for case in flash_cases.FEATURE_CASES])
def test_flash_attention_v_head_dim(cuda, shape, kwargs, d, dv, dtype):
    """q and k at head dim d, v at dv, every feature case.  bf16 at MLA's
    (192, 128) takes the tensor cores and is held as the square head dims
    are (``_flash_err``: the plain version elementwise and row by row, the
    CUDA-core kernel beside it, at most twice its error from fp32); fp32
    and the other pairs take the CUDA-core kernel, against the plain
    version (fp32 within 2e-5; bf16 elementwise and row by row)."""
    B, H, K, Sq, Sk = shape
    q = _randn(cuda, B, H, Sq, d).to(dtype)
    k = _randn(cuda, B, K, Sk, d, seed=1).to(dtype)
    v = _randn(cuda, B, K, Sk, dv, seed=2).to(dtype)
    on_tc = dtype == torch.bfloat16 and (d, dv) == (192, 128)
    assert flash_kernel.route(q, k, v) == \
        ("tensor_core" if on_tc else "cuda_core")
    if on_tc:
        assert _flash_err(q, k, v, **kwargs) <= FLASH_TOL[dtype]
        return
    reset_launch_counts()
    got = flash_attention_op(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    assert launch_counts()["flash_attention_tc"] == 0
    assert got.shape == (B, H, Sq, dv) and got.dtype == dtype
    want = attention_ref(q, k, v, **kwargs)
    if dtype == torch.bfloat16:
        assert flash_cases.excess(got, want) <= flash_cases.ATOL
        assert flash_cases.row_rel_err(got, want) <= \
            flash_cases.ROW_REL_LIMIT
    else:
        assert _max_abs(got, want) <= FLASH_TOL[dtype]


def test_flash_attention_v_head_dim_strided_views(cuda):
    """MLA's prefill operands as the model gives them: [B,S,H,d] seen as
    [B,H,S,d], read by TMA in place on the tensor cores; the output
    [B,H,S,128] laid out like q.  The same v 2 bytes off a 16-byte boundary
    sends the call to the CUDA cores."""
    q = _randn(cuda, 2, 96, 8, 192).bfloat16().transpose(1, 2)
    k = _randn(cuda, 2, 96, 8, 192, seed=1).bfloat16().transpose(1, 2)
    v = _randn(cuda, 2, 96, 8, 128, seed=2).bfloat16().transpose(1, 2)
    assert flash_kernel.route(q, k, v) == "tensor_core"
    got = flash_attention_op(q, k, v)
    assert got.shape == (2, 8, 96, 128)
    assert got.transpose(1, 2).is_contiguous()
    want = attention_ref(q, k, v)
    assert flash_cases.row_rel_err(got, want) <= flash_cases.ROW_REL_LIMIT
    assert _flash_err(q, k, v) <= FLASH_TOL[torch.bfloat16]
    base = torch.empty(v.numel() + 8, dtype=v.dtype, device=cuda)
    v_off = base[1:1 + v.numel()].view(2, 96, 8, 128)
    v_off.copy_(v.transpose(1, 2))
    v_off = v_off.transpose(1, 2)
    assert flash_kernel.route(q, k, v_off) == "cuda_core"
    assert _flash_err(q, k, v_off) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_mla_moe_prefill_on_cuda_matches_decode(cuda, arch):
    """The DeepSeek smoke() on the card (capacity_factor = experts / top_k,
    so the prefill drops no token): the prefill step, one CUDA-core flash
    launch a layer, agrees with the engine's sequential absorbed decode
    and with the prefill step on the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = get_arch(arch).smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = init_params(torch.Generator(cuda).manual_seed(0), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 12))
    reset_launch_counts()
    got = build_prefill_step(cfg)(params, {"tokens": toks})
    assert launch_counts()["flash_attention"] == cfg.num_layers
    assert launch_counts()["flash_attention_tc"] == 0
    dec, _ = ServingEngine(params, cfg, ServeConfig(3, 16)).prefill(toks)
    cpu = build_prefill_step(cfg, "cpu")(params.to("cpu"), {"tokens": toks})
    scale = float(dec.abs().max())
    assert float((got - dec).abs().max()) <= 1e-4 * scale
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-27b"])
def test_prefill_step_on_cuda_matches_decode(cuda, arch):
    """The smoke() model on the card: the prefill step (one flash kernel
    launch per attention layer) agrees with the ServingEngine's sequential
    prefill, and with the prefill step on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = get_arch(arch).smoke()
    params = init_params(torch.Generator(cuda).manual_seed(0), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 12))
    reset_launch_counts()
    got = build_prefill_step(cfg)(params, {"tokens": toks})
    assert launch_counts()["flash_attention"] == cfg.num_layers
    dec, _ = ServingEngine(params, cfg, ServeConfig(3, 16)).prefill(toks)
    cpu = build_prefill_step(cfg, "cpu")(params.to("cpu"), {"tokens": toks})
    scale = float(dec.abs().max())
    assert float((got - dec).abs().max()) <= 1e-4 * scale
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale


def test_snapshot_resume_on_cuda(cuda, tmp_path):
    """A CUDA stencil run through the ring's fabric, killed after a
    barrier and resumed: every restored token and sink output lies on the
    card (the kernel wrappers refuse CPU tensors), dilate launches in the
    resumed run, and the outputs are the uninterrupted run's bits."""
    from torch.utils import _pytree as pytree

    from repro_torch.exec import (ExecutionState, bit_identical,
                                  load_snapshot, restore_state,
                                  resume_execution, snapshot_steps)
    from repro_torch.obs.smoke import compile_app
    from repro_torch.runtime import FailureInjector

    graph, design = compile_app("stencil", 4)
    base = execute(design, bind_programs(graph, device=cuda), device=cuda)
    d = str(tmp_path)
    with pytest.raises(FailureInjector.Injected):
        execute(design, bind_programs(graph, device=cuda), device=cuda,
                injector=FailureInjector([5]), checkpoint_dir=d,
                checkpoint_every=3)
    steps = snapshot_steps(d)
    assert steps and steps[-1] < 5
    state = ExecutionState(design, bind_programs(graph, device=cuda),
                           device=cuda)
    restore_state(state, load_snapshot(d, steps[-1]))
    leaves = pytree.tree_leaves(
        ([e.token for fc in state.channels for e in fc._q],
         list(state.sink_outputs.values())))
    assert leaves and all(t.device.type == "cuda" for t in leaves)
    reset_launch_counts()
    resumed = resume_execution(design, d,
                               binding=bind_programs(graph, device=cuda),
                               device=cuda)
    assert launch_counts()["dilate"] > 0
    assert bit_identical(resumed.outputs, base.outputs)
    assert all(resumed.report.agreement().values())


@pytest.mark.parametrize("app", ["stencil", "cnn"])
def test_traced_fabric_run_on_cuda(cuda, app):
    """The obs smoke's contract on the card: the traced run gives the
    untraced bits and counters, and its counters equal the CPU run's."""
    from repro_torch.obs.smoke import check_app, compile_app, counters

    graph, design = compile_app(app, 4)
    run = check_app(app, graph, design, cuda)
    cpu = execute(design, bind_programs(graph, device="cpu"), device="cpu")
    assert counters(run["result"].report) == counters(cpu.report)
    assert run["result"].report.metrics.total("exec.device.fired") > 0


# -- the MoE FFN --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_forward_gives_the_same_bits_on_every_run(cuda, dtype):
    """The MoE combine sums each token's slots in a fixed order, so three
    runs on the card give the same bits (a scatter-add's atomics would add
    in a varying order), near the CPU's output."""
    from repro_torch.models import moe

    cfg = moe.MoEConfig(d_model=64, d_ff_expert=32, num_experts=16,
                        top_k=4, num_shared=1, capacity_factor=1.0)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, dtype)
    x = _randn("cpu", 4, 64, 64, seed=3).to(dtype)
    want, _ = moe.moe_forward(params, cfg, x)
    on_card = {k: v.to(cuda) for k, v in params.items() if k != "shared"}
    on_card["shared"] = {k: v.to(cuda) for k, v in params["shared"].items()}
    runs = [moe.moe_forward(on_card, cfg, x.to(cuda))[0] for _ in range(3)]
    for got in runs[1:]:
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           runs[0].view(torch.int16 if dtype == torch.bfloat16
                                        else torch.int32))
    scale = float(want.float().abs().max())
    assert float((runs[0].cpu().float() - want.float()).abs().max()) <= \
        (2e-2 if dtype == torch.bfloat16 else 1e-5) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_gives_the_cpu_bits(cuda, dtype):
    """``combine`` on the card gives the CPU's bits on the same inputs
    (``tests/test_torch_moe.py`` holds the CPU's to ``index_add_``)."""
    from repro_torch.models import moe

    G, S, E, k, C, D = 3, 24, 8, 3, 6, 40
    gen = torch.Generator().manual_seed(0)
    idx = torch.rand(G, S, E, generator=gen).argsort(-1)[..., :k]
    flat_e = idx.reshape(G, S * k)
    pos = moe.slot_positions(flat_e, E)
    g = torch.arange(G)[:, None].expand(G, S * k)
    slot_of = torch.where(pos < C, (flat_e * G + g) * C + pos,
                          E * G * C).view(G, S, k)
    contrib = torch.randn(E * G * C, D, generator=gen).to(dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    want = moe.combine(contrib, slot_of, idx)
    got = moe.combine(contrib.to(cuda), slot_of.to(cuda), idx.to(cuda))
    assert torch.equal(got.cpu().view(bits), want.view(bits))


# -- training -----------------------------------------------------------------

# (B, H, K, Sq, Sk, d, dv), keywords: each tensor-core instance, G = 1, 2,
# 4 and 7, a window and a softcap, Sq > Sk without a mask.
GRAD_CASES = [
    ((1, 8, 2, 256, 256, 128, 128), {}),
    ((1, 14, 2, 200, 200, 128, 128), {}),
    ((1, 4, 2, 256, 256, 128, 128), {"window": 64, "softcap": 50.0}),
    ((1, 4, 4, 256, 256, 64, 64), {"causal": False}),
    ((1, 4, 4, 256, 96, 64, 64), {"causal": False}),
    ((1, 4, 4, 192, 192, 192, 128), {}),
    ((1, 16, 1, 256, 256, 256, 256), {"window": 128}),
]


@pytest.mark.parametrize("shape,kw", GRAD_CASES)
def test_flash_op_gradient_bf16(cuda, shape, kw):
    """bf16: the tensor-core forward and the backward's dq, dk, dv within
    twice the plain version's error from the fp32 gradient; the forward
    launched once (the backward launches no kernel of the port)."""
    B, H, K, Sq, Sk, d, dv = shape
    q, k, v = (_randn(cuda, *s, seed=i).to(torch.bfloat16) for i, s in
               enumerate(((B, H, Sq, d), (B, K, Sk, d), (B, K, Sk, dv))))
    assert flash_kernel.route(q, k, v) == "tensor_core"
    do = _randn(cuda, B, H, Sq, dv, seed=7).to(torch.bfloat16)
    reset_launch_counts()
    errs = flash_cases.grad_errors(q, k, v, do, **kw)
    assert launch_counts()["flash_attention_tc"] == 1
    for name, (op, plain) in errs.items():
        assert op <= flash_cases.GRAD_GATE * plain, (name, op, plain)


@pytest.mark.parametrize("shape,kw", GRAD_CASES)
def test_flash_op_gradient_fp32(cuda, shape, kw):
    """fp32: the CUDA-core forward and the backward within 1e-5 of
    autograd of the plain version, relative to each gradient's scale."""
    B, H, K, Sq, Sk, d, dv = shape
    ts = [_randn(cuda, *s, seed=i).requires_grad_(True) for i, s in
          enumerate(((B, H, Sq, d), (B, K, Sk, d), (B, K, Sk, dv)))]
    do = _randn(cuda, B, H, Sq, dv, seed=7)
    got = torch.autograd.grad(flash_attention_op(*ts, **kw), ts, do)
    want = torch.autograd.grad(attention_ref(*ts, **kw), ts, do)
    for g, w in zip(got, want):
        assert _max_abs(g, w) <= 1e-5 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("S", [1, 5, 33, 2048])
def test_rglru_scan_gradient_on_cuda(cuda, S):
    """RG-LRU's scan Function on the card: in fp64 its output and d a,
    d bx within 1e-12 of autograd of the step loop (``rglru_scan_ref``)
    on the card, relative to their scale; in fp32 the same forward bits
    and gradients within 1e-5 of the CPU's."""
    from repro_torch.models.recurrent import rglru_scan, rglru_scan_ref

    gen = torch.Generator().manual_seed(S)
    a = torch.rand(2, S, 64, generator=gen, dtype=torch.float64) * 0.5 + 0.5
    bx, dh = (torch.randn(2, S, 64, generator=gen, dtype=torch.float64)
              for _ in range(2))

    def run(fn, dev, dtype):
        ts = [t.to(dev, dtype).requires_grad_(True) for t in (a, bx)]
        h = fn(*ts)
        return (h.detach(), *torch.autograd.grad(h, ts, dh.to(dev, dtype)))

    for g, w in zip(run(rglru_scan, cuda, torch.float64),
                    run(rglru_scan_ref, cuda, torch.float64)):
        assert float((g - w).abs().max()) <= \
            1e-12 * max(1.0, float(w.abs().max()))
    got = run(rglru_scan, cuda, torch.float32)
    want = run(rglru_scan, "cpu", torch.float32)
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert _max_abs(g.cpu(), w) <= 1e-5 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("S", [5, 2048])
def test_slstm_prefill_gradient_on_cuda(cuda, S):
    """sLSTM's prefill form (its stabilizer's Function and the scan of c
    and n) on the card, fp32: its output and its gradients with respect
    to x and every leaf within 1e-4 of the step loop's (the decode form
    from a fresh state) under autograd on the card, and within 1e-5 of
    the prefill form's on the CPU, relative to their norms."""
    from repro_torch.models import recurrent as rec

    cfg = rec.SLSTMConfig(64, 4)
    gen = torch.Generator().manual_seed(S)
    x, w = (torch.randn(2, S, 64, generator=gen) for _ in range(2))

    def run(dev, loop):
        p = rec.init_slstm(torch.Generator().manual_seed(0), cfg)
        p = {k: v.to(dev) if k != "norm" else
             {"scale": v["scale"].to(dev)} for k, v in p.items()}
        leaves = [p[k] for k in sorted(p) if k != "norm"]
        leaves.append(p["norm"]["scale"])
        for t in leaves:
            t.requires_grad_(True)
        xt = x.to(dev).requires_grad_(True)
        state = rec.init_slstm_state(cfg, 2, device=dev) if loop else None
        y, _ = rec.slstm_forward(p, cfg, xt, state)
        grads = torch.autograd.grad((y * w.to(dev)).sum(), (xt, *leaves))
        return [t.detach().cpu() for t in (y, *grads)]

    got = run(cuda, False)
    for want, tol in ((run(cuda, True), 1e-4), (run("cpu", False), 1e-5)):
        for g, r in zip(got, want):
            assert float((g - r).norm()) <= tol * float(r.norm())


@pytest.mark.parametrize("arch,param_tol", [
    ("qwen3-4b", 1e-3), ("gemma2-27b", 1e-3), ("deepseek-v3-671b", 1e-3),
    ("recurrentgemma-9b", 1e-3), ("xlstm-1.3b", 5e-3),
    ("seamless-m4t-large-v2", 1e-3), ("llava-next-34b", 1e-3),
    ("chatglm3-6b", 1e-3), ("mistral-nemo-12b", 1e-3),
    ("deepseek-v2-236b", 1e-3)])
def test_train_step_on_cuda_matches_cpu(cuda, arch, param_tol):
    """Two fp32 AdamW steps of the arch's ``smoke()`` on the card and on
    the CPU from the same weights and batches: the losses within 1e-5
    relative, each param leaf within ``param_tol`` of the norm of its
    update (the rule of ``tests/test_torch_train.py``, xlstm's 5e-3
    there too: AdamW's normalised step magnifies the rounding of its
    sLSTM gradients' elements near zero), the flash kernel launched
    ``train_flash_launches`` times a step."""
    from repro_torch.configs import get_arch
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.launch.train import data_config
    from repro_torch.models import train_flash_launches
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw_init

    cfg = get_arch(arch).smoke()
    cpu = init_train_state(cfg, device="cpu")
    before = [t.clone() for t in tree_leaves(cpu["params"])]
    params = init_train_state(cfg, device="cpu")["params"].to(cuda)
    states = {"cpu": cpu,
              "cuda": {"params": params, "opt": adamw_init(params),
                       "step": torch.zeros((), dtype=torch.int32,
                                           device=cuda)}}
    steps = {dev: build_train_step(cfg, device=dev) for dev in states}
    pipe = make_pipeline(data_config(cfg, 2, 64))
    try:
        for _ in range(2):
            batch = next(pipe)
            losses = {}
            for dev in states:
                reset_launch_counts()
                states[dev], m = steps[dev](states[dev], batch)
                losses[dev] = float(m["loss"])
            assert launch_counts()["flash_attention"] == \
                train_flash_launches(cfg)
            assert abs(losses["cuda"] - losses["cpu"]) <= \
                1e-5 * abs(losses["cpu"])
    finally:
        pipe.close()
    for i, (p0, a, b) in enumerate(zip(
            before, tree_leaves(states["cuda"]["params"]),
            tree_leaves(states["cpu"]["params"]))):
        assert a.device.type == "cuda"
        moved = float((b.detach() - p0).norm())
        err = float((a.detach().cpu() - b.detach()).norm())
        assert err <= param_tol * moved, (i, err / moved)
