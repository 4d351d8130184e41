"""The rules by which the port's wrappers pick a kernel, on the CPU.

Flash attention: ``route(q, k, v)`` sends bf16 calls whose (q/k head dim,
v head dim) is (64, 64), (128, 128) or MLA's (192, 128) and that TMA can
read in place to the tensor-core kernel and every other call to the
CUDA-core kernel (recurrentgemma's (256, 256) among them);
``check_operands`` refuses head dims past 256; ``tma_geometry`` gives the tensor map over
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


def _mla_qkv(B=4, S=2048, H=128, d=192, dv=128, dtype=torch.bfloat16):
    """MLA's prefill operands as ``mla_forward`` gives them: q and k
    [B, S, H, d] (``torch.cat``, so contiguous) and v a view of the
    [B, S, H * dv] product, each seen as [B, H, S, *].  ``torch.empty``: a
    route reads no values, and the full-width tensors (1.07 GB in bf16)
    are never touched."""
    q, k = (torch.empty(B, S, H, d, dtype=dtype).transpose(1, 2)
            for _ in range(2))
    v = torch.empty(B, S, H * dv, dtype=dtype).view(B, S, H, dv)
    return q, k, v.transpose(1, 2)


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


def test_mla_prefill_views_take_the_tensor_cores():
    """bf16 q/k head dim 192 and v 128 at MLA's full-width prefill shape
    (deepseek-v2/v3: 128 heads, 4 x 2048), as the model's views."""
    q, k, v = _mla_qkv()
    assert q.shape == k.shape == (4, 128, 2048, 192)
    assert v.shape == (4, 128, 2048, 128)
    assert flash.route(q, k, v) == "tensor_core"


def test_mla_contiguous_operands_take_the_tensor_cores():
    q, k = (torch.zeros(2, 4, 100, 192, dtype=torch.bfloat16)
            for _ in range(2))
    v = torch.zeros(2, 4, 100, 128, dtype=torch.bfloat16)
    assert flash.route(q, k, v) == "tensor_core"


def test_mla_fp32_takes_the_cuda_cores():
    """MLA's fp32 parity runs stay on the CUDA-core kernel's (192, 128)
    instance."""
    assert flash.route(*_mla_qkv(B=1, S=64, H=4,
                                 dtype=torch.float32)) == "cuda_core"


@pytest.mark.parametrize("d,dv", [(128, 64), (24, 16), (72, 40), (64, 128),
                                  (192, 192), (192, 64)])
def test_other_head_dim_pairs_take_the_cuda_cores(d, dv):
    """Only (64, 64), (128, 128) and (192, 128) are tensor-core pairs."""
    assert flash.route(*_mla_qkv(B=1, S=64, H=4, d=d, dv=dv)) == \
        "cuda_core"


def test_recurrentgemma_prefill_takes_the_cuda_cores():
    """bf16 (256, 256) at recurrentgemma-9b's prefill shape (16 query heads
    on one kv head, 4 x 2048), as the model's views: no tensor-core
    instance takes head dim 256, so the CUDA-core kernel's (256, 256)
    instance does, and the wrapper accepts the operands."""
    q, k, v = _prefill_qkv(H=16, K=1, d=256)
    assert q.shape == (4, 16, 2048, 256) and k.shape == (4, 1, 2048, 256)
    assert flash.route(q, k, v) == "cuda_core"
    flash.check_operands(q, k, v)
    assert flash.route(*_prefill_qkv(H=16, K=1, d=256,
                                     dtype=torch.float32)) == "cuda_core"


@pytest.mark.parametrize("d,dv", [(257, 257), (256, 257), (257, 128),
                                  (320, 256)])
def test_head_dims_past_256_are_refused(d, dv):
    """No instance takes a head dim past 256: the wrapper raises and
    nothing falls back."""
    q, k, v = _mla_qkv(B=1, S=8, H=2, d=d, dv=dv)
    with pytest.raises(ValueError, match="d <= 256 and dv <= 256"):
        flash.check_operands(q, k, v)
    flash.check_operands(*_mla_qkv(B=1, S=8, H=2, d=256, dv=256))


def test_misaligned_mla_v_takes_the_cuda_cores():
    """(192, 128) with v 2 bytes off a 16-byte boundary: TMA cannot read
    it, so the whole call takes the CUDA cores."""
    q, k, v = _mla_qkv(B=1, S=64, H=4)
    assert flash.route(q, k, v) == "tensor_core"
    base = torch.zeros(v.numel() + 8, dtype=v.dtype)
    v_off = base[1:1 + v.numel()].view(1, 64, 4, 128).transpose(1, 2)
    assert v_off.data_ptr() % 16 == 2
    assert flash.route(q, k, v_off) == "cuda_core"


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


def test_tma_geometry_of_mla_views():
    """q (and k) 192 wide: three 64-wide boxes a row; v 128 wide, a view
    of the [B, S, H * 128] product."""
    B, S, H = 4, 2048, 128
    q, _, v = _mla_qkv(B=B, S=S, H=H)
    dims, strides, box = flash.tma_geometry(q)
    assert dims == (192, S, H, B)
    assert strides == (H * 192 * 2, 192 * 2, S * H * 192 * 2)
    assert strides == (49152, 384, 100663296)
    assert box == (64, 128, 1, 1) and dims[0] % box[0] == 0
    dims, strides, box = flash.tma_geometry(v)
    assert dims == (128, S, H, B)
    assert strides == (H * 128 * 2, 128 * 2, S * H * 128 * 2)
    assert box == (64, 128, 1, 1) and dims[0] % box[0] == 0
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


def test_the_mla_prefill_hands_the_kernel_tensor_core_operands(monkeypatch):
    """The operands MLA's prefill gives the kernel in a bf16 prefill step
    of deepseek-v2's smoke() with MLA's full head dims (q/k 128 nope + 64
    rope, v 128; 4 heads, 2 layers, narrow elsewhere): each call takes the
    tensor-core route, q and k at head dim 192, v at 128."""
    base = get_arch("deepseek-v2-236b").smoke()
    mla = dataclasses.replace(base.mla, qk_nope_dim=128, qk_rope_dim=64,
                              v_head_dim=128)
    cfg = dataclasses.replace(base, mla=mla, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    assert mla.num_heads == 4 and cfg.num_layers == 2
    seen = []
    op = attention.flash_attention_op

    def spy(q, k, v, **kw):
        seen.append((flash.route(q, k, v), q.shape, k.shape, v.shape))
        return op(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_op", spy)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    logits = build_prefill_step(cfg, "cpu")(params, {"tokens": tokens})
    assert bool(torch.isfinite(logits.float()).all())
    assert len(seen) == cfg.num_layers
    for r, qs, ks, vs in seen:
        assert r == "tensor_core"
        assert qs == ks == (2, 4, 24, 192)
        assert vs == (2, 4, 24, 128)


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
