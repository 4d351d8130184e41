"""The gemv kernel's launch rule on the CPU.

The kernel (``csrc/hbm_blas.cu``) gives each row of A one block of 8 warps
and sums it in a fixed order.  ``gemv_vector_loads(A, x)`` decides whether
the call reads A and x in 16-byte loads; otherwise every row takes the
scalar path, which adds the same products in the same order.  The rule
reads N and the two pointers only, so a row's path, like its sum, never
depends on M, the row's place in the array or the card: these tests show
it on CPU tensors, whose pointers answer as the card's would.
"""
import pytest
import torch

from repro_torch.kernels.hbm_blas.kernel import gemv_vector_loads


def _view(shape, offset_floats=0):
    """A contiguous fp32 [M, N] view ``offset_floats`` past a 64-byte
    aligned start."""
    M, N = shape
    base = torch.zeros(M * N + 8)
    assert base.data_ptr() % 16 == 0
    return base[offset_floats:offset_floats + M * N].view(M, N)


def test_contiguous_arrays_take_the_vector_loads():
    A, x = _view((1024, 8192)), _view((1, 8192))
    assert gemv_vector_loads(A, x)


def test_every_shard_view_takes_the_vector_loads():
    """The app's shard tasks get row slices of one array: each starts
    16-byte aligned when N % 4 == 0."""
    A, x = _view((64, 8192)), _view((1, 8192))
    assert all(gemv_vector_loads(A[i:i + 8], x) for i in range(0, 64, 8))
    assert all(gemv_vector_loads(A[i:i + 1], x) for i in range(64))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_offset_views_take_the_scalar_path(offset):
    """A view 4, 8 or 12 bytes past an aligned start, and an aligned one."""
    A, x = _view((16, 256), offset), _view((1, 256))
    assert A.data_ptr() % 16 == 4 * offset
    assert not gemv_vector_loads(A, x)
    assert gemv_vector_loads(_view((16, 256), 4), x)


def test_a_misaligned_x_takes_the_scalar_path():
    A, x = _view((16, 256)), _view((1, 256), 1)
    assert not gemv_vector_loads(A, x)


@pytest.mark.parametrize("N", [4099, 4097, 1, 3, 4098])
def test_n_not_a_multiple_of_four_takes_the_scalar_path(N):
    """Every row of such an array, including those whose start happens to
    be 16-byte aligned (row 4 of a [48, 4099] array starts 65,584 bytes
    in), takes the scalar path: a row's path is the call's."""
    A, x = _view((48, N)), _view((1, N))
    assert not gemv_vector_loads(A, x)
    aligned_rows = [i for i in range(48) if A[i:i + 1].data_ptr() % 16 == 0]
    assert aligned_rows
    assert not any(gemv_vector_loads(A[i:i + 1], x) for i in aligned_rows)


@pytest.mark.parametrize("offset", [0, 1])
def test_the_rule_never_reads_m(offset):
    A, x = _view((1024, 512), offset), _view((1, 512))
    want = gemv_vector_loads(A, x)
    assert want == (offset == 0)
    for m in (1, 5, 100, 131, 132, 133, 1000, 1024):
        assert gemv_vector_loads(A[:m], x) == want


def test_the_rule_never_asks_the_device(monkeypatch):
    """No SM count, device property or CUDA call enters the rule."""
    def refuse(*args, **kwargs):
        raise AssertionError("gemv_vector_loads asked the device")

    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert gemv_vector_loads(_view((8, 64)), _view((1, 64)))
    assert not gemv_vector_loads(_view((8, 64), 1), _view((1, 64)))

