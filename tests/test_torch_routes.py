"""The rules by which the port's wrappers pick a kernel, on the CPU.

Flash attention: ``route(q, k, v)`` sends bf16 calls with d in {64, 128}
that TMA can read in place to the tensor-core kernel and every other call
to the CUDA-core kernel; ``tma_geometry`` gives the tensor map over
(d, S, heads, batch) of a ``[B, S, H, d]`` tensor seen as ``[B, H, S, d]``.
Matmul: ``route(M, K, N)`` sends N <= 16 to the narrow kernel while B fits
its shared memory.  The routes read dtypes, shapes, strides and pointers
only, so CPU tensors answer as the card's would.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.systolic_matmul.kernel import route as matmul_route
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import attention, init_params


def _bshd(B, S, H, d, dtype=torch.bfloat16):
    """A [B, S, H, d] tensor seen as [B, H, S, d], as attention_core passes
    the model's projections to the kernel."""
    return torch.zeros(B, S, H, d, dtype=dtype).transpose(1, 2)


def _prefill_qkv(B=4, S=2048, H=32, K=8, d=128, dtype=torch.bfloat16):
    return _bshd(B, S, H, d, dtype), _bshd(B, S, K, d, dtype), \
        _bshd(B, S, K, d, dtype)


def test_prefill_shape_takes_the_tensor_cores():
    assert flash.route(*_prefill_qkv()) == "tensor_core"


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_head_dims_of_the_tensor_cores(d):
    assert flash.route(*_prefill_qkv(B=1, S=100, H=4, K=2, d=d)) == \
        "tensor_core"


def test_fp32_takes_the_cuda_cores():
    assert flash.route(*_prefill_qkv(dtype=torch.float32)) == "cuda_core"


@pytest.mark.parametrize("d", [8, 32, 96])
def test_other_head_dims_take_the_cuda_cores(d):
    assert flash.route(*_prefill_qkv(B=1, S=64, H=4, K=2, d=d)) == \
        "cuda_core"


def test_misaligned_view_takes_the_cuda_cores():
    """Rows 2 bytes off a 16-byte boundary and a row stride of 130 bytes:
    TMA cannot read them."""
    base = torch.zeros(1, 2, 40, 65, dtype=torch.bfloat16)
    qm = base[..., 1:]
    assert qm.shape[-1] == 64
    assert flash.route(qm, qm, qm) == "cuda_core"


def test_four_byte_offset_view_takes_the_cuda_cores():
    """The view 4 bytes past an aligned start (strides aligned)."""
    base = torch.zeros(2 * 40 * 64 + 8, dtype=torch.bfloat16)
    view = base[2:2 + 2 * 40 * 64].view(1, 2, 40, 64)
    assert view.data_ptr() % 16 == 4
    assert flash.route(view, view, view) == "cuda_core"
    aligned = base[8:8 + 2 * 40 * 64].view(1, 2, 40, 64)
    assert flash.route(aligned, aligned, aligned) == "tensor_core"


def test_one_operand_decides_for_all():
    q, k, v = _prefill_qkv(B=1, S=64, H=4, K=2)
    assert flash.route(q, k.float(), v) == "cuda_core"
    v_off = torch.zeros(v.numel() + 8, dtype=v.dtype)[1:1 + v.numel()]
    assert flash.route(q, k, v_off.view(v.shape)) == "cuda_core"


def test_tma_geometry_of_the_bshd_view():
    B, S, H, d = 4, 2048, 32, 128
    dims, strides, box = flash.tma_geometry(_bshd(B, S, H, d))
    assert dims == (d, S, H, B)
    assert strides == (H * d * 2, d * 2, S * H * d * 2)
    assert box == (64, 128, 1, 1)
    assert all(s % 16 == 0 for s in strides)


def test_tma_geometry_of_a_contiguous_tensor():
    t = torch.zeros(2, 8, 70, 64, dtype=torch.bfloat16)
    dims, strides, _ = flash.tma_geometry(t)
    assert dims == (64, 70, 8, 2)
    assert strides == (64 * 2, 70 * 64 * 2, 8 * 70 * 64 * 2)


def test_the_prefill_step_hands_the_kernel_tensor_core_operands(monkeypatch):
    """The operands attention_core gives the kernel in a bf16 prefill step
    at qwen3-4b's head dim (128; narrow widths, 2 layers), as the step
    computes them: each call takes the tensor-core route."""
    cfg = dataclasses.replace(get_arch("qwen3-4b").smoke(), head_dim=128,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    seen = []
    op = attention.flash_attention_op

    def spy(q, k, v, **kw):
        seen.append((flash.route(q, k, v), q.shape, q.stride()))
        return op(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_op", spy)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    build_prefill_step(cfg, "cpu")(params, {"tokens": tokens})
    assert len(seen) == cfg.num_layers
    H, d = cfg.num_heads, cfg.head_dim
    for r, shape, stride in seen:
        assert r == "tensor_core"
        assert shape == (2, H, 24, d)
        assert stride[3] == 1 and stride[2] == H * d


@pytest.mark.parametrize("N,want", [(1, "narrow"), (4, "narrow"),
                                    (16, "narrow"), (17, "tiled"),
                                    (80, "tiled")])
def test_matmul_route_at_the_cnn_depth(N, want):
    assert matmul_route(1024, 576, N) == want


def test_matmul_route_keeps_b_in_shared_memory():
    """The narrow kernel holds B transposed, N padded to a power of two and
    K to a multiple of 4, in 48 KB of shared memory."""
    assert matmul_route(1024, 768, 16) == "narrow"       # 48 KB
    assert matmul_route(1024, 769, 16) == "tiled"
    assert matmul_route(1024, 3072, 3) == "narrow"       # N padded to 4
    assert matmul_route(1024, 3073, 4) == "tiled"
