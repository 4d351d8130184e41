"""The tiled matmul kernel's plan, on the CPU: ``tiled_plan(M, K, N)`` picks
the output tile and the number of K splits of ``csrc/matmul.cu``'s tiled
kernel from the shape alone, with the H100's 132 SMs as a design constant.

The split sum is emulated here as the card computes it: ``matmul_ref``
over each split's K range, the partials added in split order; it is held
to the JAX package's ``matmul_op`` (interpret mode on the CPU) within 2e-4
of the output's scale, the CNN binding's tolerance.  The wrapper's launch
is driven against a stand-in library to check what it hands the kernel:
the plan, the workspace, the 16-byte flags, one count a product.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro_torch.kernels import build
from repro_torch.kernels.systolic_matmul import kernel as mm
from repro_torch.kernels.systolic_matmul.ref import matmul_ref

from _torch_parity import scaled_err

TOL = 2e-4
CNN_DEFAULT = (1024, 576, 64)            # run_numeric's default im2col product
VGG_CONV3 = (3136, 2304, 256)            # 56 x 56 x 256 -> 256
# The tiled route's edges that the card checks too: just past the narrow
# route, N % 4 != 0, K % 4 != 0 (twice), 1 x 1 x 32, a deep K split.
RAGGED = [(1024, 576, 17), (300, 200, 150), (65, 17, 129), (1024, 575, 64),
          (1, 1, 32), (64, 4096, 64)]


def _shapes(n: int, seed: int) -> list:
    """``n`` shapes drawn log-uniformly: M up to 5,000,000, K from 1 to
    100,000, N from 1 to 20,000."""
    rng = np.random.default_rng(seed)
    m = np.exp(rng.uniform(0, np.log(5_000_000), n)).astype(np.int64)
    k = np.exp(rng.uniform(0, np.log(100_000), n)).astype(np.int64)
    n_ = np.exp(rng.uniform(0, np.log(20_000), n)).astype(np.int64)
    return [(int(a), int(b), int(c)) for a, b, c in zip(m, k, n_)]


SWEEP = (_shapes(40, 0) + [(5_000_000, 1, 17), (4_194_305, 4, 17),
                           (1, 100_000, 1), (5_000_000, 100_000, 20_000),
                           (1, 1, 1), (17, 16, 17), (17, 17, 17)])


def test_plan_is_a_pure_function_of_the_shape(monkeypatch):
    """The same shape gives the same plan, computed afresh, with every CUDA
    query made to fail: the plan reads nothing of the device."""
    want = {s: mm.tiled_plan(*s) for s in (CNN_DEFAULT, VGG_CONV3, *RAGGED)}

    def no_device(*args, **kwargs):
        raise AssertionError("tiled_plan asked the device")

    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    mm.tiled_plan.cache_clear()
    for shape, plan in want.items():
        assert mm.tiled_plan(*shape) == plan
        assert mm.tiled_plan(*shape) is mm.tiled_plan(*shape)


def test_plan_fills_the_card_at_the_vgg_row():
    """[3136, 2304] x [2304, 256]: 98 tiles of 64 x 128 hold 74% of the
    SMs, so K is split 4 ways into 392 blocks, 2.97 an SM, every one held
    at once (four 128-thread blocks fit an SM at 128 registers)."""
    plan = mm.tiled_plan(*VGG_CONV3)
    assert (plan.bm, plan.bn, plan.splits) == (64, 128, 4)
    assert plan.tiles == 98 and plan.blocks == 392
    assert plan.blocks / mm.SMS == pytest.approx(2.97, abs=0.005)
    threads = plan.bm * plan.bn // 64
    assert threads == 128
    assert plan.blocks <= mm.SMS * (mm.THREADS_HELD_PER_SM // threads)
    assert plan.k_ranges(2304) == [(0, 576), (576, 1152), (1152, 1728),
                                   (1728, 2304)]


def test_plan_fills_the_card_at_the_cnn_row():
    """[1024, 576] x [576, 64]: 8 tiles of 128 x 64 would hold 6% of the
    SMs; split 12 ways (3 slabs of 16 each) they make 96 blocks, one wave
    of one block an SM."""
    plan = mm.tiled_plan(*CNN_DEFAULT)
    assert (plan.bm, plan.bn, plan.splits, plan.slabs) == (128, 64, 12, 3)
    assert plan.tiles == 8 and plan.blocks == 96 <= mm.SMS
    assert [k1 - k0 for k0, k1 in plan.k_ranges(576)] == [48] * 12


def test_plan_prefers_the_modelled_fastest():
    """The plan is the least modelled time over every tile and split count
    that gives each split whole slabs."""
    for M, K, N in (CNN_DEFAULT, VGG_CONV3, *RAGGED):
        plan = mm.tiled_plan(M, K, N)
        total = -(-K // mm.SLAB)
        for bm, bn in mm.TILES:
            for s in range(1, min(total, mm.MAX_SPLITS) + 1):
                slabs = -(-total // s)
                if -(-total // slabs) == s:
                    assert plan.model_ns <= mm._model_ns(M, K, N, bm, bn, s,
                                                         slabs)


@pytest.mark.parametrize("M,K,N", SWEEP)
def test_splits_cover_k_and_the_grid_is_legal(M, K, N):
    plan = mm.tiled_plan(M, K, N)
    assert (plan.bm, plan.bn) in mm.TILES
    ranges = plan.k_ranges(K)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (k0, k1), (n0, _) in zip(ranges, ranges[1:]):
        assert k1 == n0                                    # contiguous
        assert k1 - k0 == plan.slabs * mm.SLAB             # whole slabs
    assert all(k1 > k0 for k0, k1 in ranges)               # none empty
    tiles = -(-M // plan.bm) * -(-N // plan.bn)
    assert plan.tiles == tiles and plan.blocks == tiles * plan.splits
    assert 1 <= plan.tiles <= 2**31 - 1                     # grid.x
    assert 1 <= plan.splits <= 65535                        # grid.y
    assert plan.slabs * mm.SLAB <= 2**30         # a split's depth is an int
    assert plan.splits <= mm.MAX_SPLITS


def _split_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tiled kernel's result as the plan makes it: one fp32 partial a
    K range, added in split order."""
    (M, K), N = a.shape, b.shape[1]
    parts = [matmul_ref(a[:, k0:k1], b[k0:k1])
             for k0, k1 in mm.tiled_plan(M, K, N).k_ranges(K)]
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


@functools.cache
def _operands(M, K, N, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K), dtype=np.float32),
            rng.standard_normal((K, N), dtype=np.float32) * 0.05)


@pytest.mark.parametrize("M,K,N", [
    CNN_DEFAULT,
    (256, 576, 64),            # the CNN's product at 16 x 16
    (196, 2304, 256),          # the VGG conv3 product at 14 x 14
    (784, 2304, 256),          # ... at 28 x 28
    *RAGGED,
])
def test_split_sum_matches_jax(M, K, N):
    a, b = _operands(M, K, N)
    want = np.asarray(jk.matmul_op(jnp.asarray(a), jnp.asarray(b)))
    got = _split_sum(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (M, N)
    assert scaled_err(got.numpy(), want) <= TOL


def test_the_rows_split_k():
    """Both rows' products take the split path, and a deep product splits
    many ways, so the emulation above covers the split sum."""
    assert mm.tiled_plan(*CNN_DEFAULT).splits > 1
    assert mm.tiled_plan(*VGG_CONV3).splits > 1
    assert mm.tiled_plan(196, 2304, 256).splits > 1
    assert mm.tiled_plan(64, 4096, 64).splits >= 32


class _Library:
    """Stands in for the kernel library: records each tiled launch."""

    def __init__(self):
        self.calls = []

    def repro_matmul_f32(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_handle", lambda device: 0)
    return lib


@pytest.mark.parametrize("M,K,N", [CNN_DEFAULT, (65, 17, 129), (1, 1, 32)])
def test_launch_hands_the_kernel_its_plan(library, M, K, N):
    """One call into the library a product, with the plan's tile, splits and
    slabs, a workspace of splits x M x N floats when K is split, and one
    count on each counter."""
    a = torch.zeros(M, K)
    b = torch.zeros(K, N)
    before = (mm.LAUNCHES.count, mm.TILED_LAUNCHES.count)
    out = mm._launch_tiled(a, b)
    assert out.shape == (M, N) and out.dtype == torch.float32
    assert (mm.LAUNCHES.count, mm.TILED_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    (call,) = library.calls
    pa, pb, pc, pw, m, n, k, bm, bn, splits, slabs, vec, stream = call
    plan = mm.tiled_plan(M, K, N)
    assert (pa, pb, pc) == (a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert (m, n, k) == (M, N, K)
    assert (bm, bn, splits, slabs) == (plan.bm, plan.bn, plan.splits,
                                        plan.slabs)
    if plan.splits == 1:
        assert pw == out.data_ptr()
    else:
        assert pw not in (pc, 0)
    assert vec == ((K % 4 == 0) | 2 * (N % 4 == 0))


def test_launch_takes_the_4_byte_path_for_a_misaligned_view(library):
    """An A whose base lies 4 bytes past a 16-byte boundary clears vec's
    bit 0; B's bit stays."""
    M, K, N = CNN_DEFAULT
    a = torch.zeros(M * K + 1)[1:].view(M, K)
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    mm._launch_tiled(a, torch.zeros(K, N))
    assert library.calls[0][11] == 2
