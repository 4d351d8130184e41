"""The rules by which the port's wrappers pick a kernel, on the CPU.

Flash attention: ``route(q, k, v)`` sends bf16 calls whose (q/k head dim,
v head dim) is (64, 64), (128, 128), MLA's (192, 128) or recurrentgemma's
(256, 256) and that TMA can read in place to the tensor-core kernel and
every other call to the CUDA-core kernel (fp32, recurrentgemma's fp32
parity runs among them, and misaligned views); ``check_operands`` refuses
head dims past 256; ``tma_geometry`` gives the tensor map over (d, S,
heads, batch) of a ``[B, S, H, d]`` tensor seen as ``[B, H, S, d]``, with
a box of ``tc_query_tile(d, Sq)`` rows for q (128; at d = 64 192, or 128
when Sq <= 512) and ``tc_key_tile(d)`` rows (64 at d = 256) for k and v.
Matmul: ``route(M, K, N)`` sends N <= 16 to the narrow kernel while B fits
its shared memory.  The routes read dtypes, shapes, strides and pointers
only, so CPU tensors answer as the card's would.
"""
import ctypes
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
    """What stays on the CUDA-core kernel's (256, 256) instance at
    recurrentgemma-9b's prefill shape (16 query heads on one kv head,
    4 x 2048): the fp32 operands (its fp32 parity runs), and bf16 with a
    kv view 2 bytes off a 16-byte boundary, which TMA cannot read; the
    wrapper accepts both."""
    q, k, v = _prefill_qkv(H=16, K=1, d=256, dtype=torch.float32)
    assert q.shape == (4, 16, 2048, 256) and k.shape == (4, 1, 2048, 256)
    assert flash.route(q, k, v) == "cuda_core"
    flash.check_operands(q, k, v)
    q, k, v = _prefill_qkv(B=1, S=64, H=16, K=1, d=256)
    base = torch.zeros(v.numel() + 8, dtype=v.dtype)
    v_off = base[1:1 + v.numel()].view(1, 64, 1, 256).transpose(1, 2)
    assert v_off.data_ptr() % 16 == 2
    assert flash.route(q, k, v_off) == "cuda_core"
    assert flash.route(q, v_off, v_off) == "cuda_core"
    flash.check_operands(q, k, v_off)


def test_recurrentgemma_prefill_takes_the_tensor_cores():
    """bf16 (256, 256) at recurrentgemma-9b's prefill shape, as the model's
    views ([4, 2048, 16, 256] and [4, 2048, 1, 256] seen as [B, H, S, d]),
    and contiguous: the tensor-core kernel's (256, 256) instance."""
    q, k, v = _prefill_qkv(H=16, K=1, d=256)
    assert q.shape == (4, 16, 2048, 256) and k.shape == (4, 1, 2048, 256)
    assert flash.route(q, k, v) == "tensor_core"
    flash.check_operands(q, k, v)
    assert (256, 256) in flash.TC_HEAD_DIMS
    q, k = (torch.zeros(1, n, 100, 256, dtype=torch.bfloat16)
            for n in (16, 1))
    assert flash.route(q, k, k) == "tensor_core"


@pytest.mark.parametrize("d,want", [(64, 128), (128, 128), (192, 128),
                                    (256, 64)])
def test_key_tile_of_each_tensor_core_instance(d, want):
    """128-key tiles, and 64 at head dim 256, where two stages of 128-key
    K and V tiles (256 KB) would not fit in the 227 KB a block may
    take."""
    assert flash.tc_key_tile(d) == want


@pytest.mark.parametrize("d,sq,want", [(64, 1, 128), (64, 200, 128),
                                       (64, 512, 128), (64, 513, 192),
                                       (64, 2048, 192), (128, 1, 128),
                                       (128, 2048, 128), (192, 2048, 128),
                                       (256, 2048, 128)])
def test_query_tile_of_each_tensor_core_instance(d, sq, want):
    """Q's box rows: a block's 128, and at head dim 64 a work tile of three
    consumer warpgroups' 192 rows, or two's 128 when Sq <= 512, where
    192-row tiles would leave most SMs idle in a second round (seamless's
    encoder: 4 x 16 heads of 512 rows are 192 tiles of 192 on 132 SMs,
    256 of 128)."""
    assert flash.tc_query_tile(d, sq) == want


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


def test_tma_geometry_of_recurrentgemma_views():
    """d = 256: q keeps its box of 64 x 128 rows; k and v take the 64-key
    tile's box of 64 x 64 rows.  Four 64-wide boxes a row."""
    B, S = 4, 2048
    q, k, v = _prefill_qkv(B=B, S=S, H=16, K=1, d=256)
    tile = flash.tc_key_tile(256)
    dims, strides, box = flash.tma_geometry(q)
    assert dims == (256, S, 16, B)
    assert strides == (16 * 256 * 2, 256 * 2, S * 16 * 256 * 2)
    assert box == (64, 128, 1, 1) and dims[0] // box[0] == 4
    for t in (k, v):
        dims, strides, box = flash.tma_geometry(t, tile)
        assert dims == (256, S, 1, B)
        assert strides == (256 * 2, 256 * 2, S * 256 * 2)
        assert box == (64, 64, 1, 1)
        assert all(s % 16 == 0 for s in strides)


@pytest.mark.parametrize("Sq,Sk,rows", [(512, 512, 128), (2048, 2048, 192),
                                        (2048, 512, 192)],
                         ids=["encoder", "decoder", "cross"])
def test_tma_geometry_of_seamless_views(Sq, Sk, rows):
    """seamless's three uses at head dim 64 (16 heads, G = 1), [B, S, 16,
    64] projections seen as [B, 16, S, 64]: the encoder's 512 frames on
    themselves, the decoder's 2048 positions on themselves, and cross
    attention's 2048 queries on the encoder's 512 keys.  Q's box is the
    work tile's rows (tc_query_tile), K's and V's tc_key_tile(64) = 128;
    one 64-wide box a row (128 bytes, the swizzle span)."""
    B, H, d = 4, 16, 64
    q, k, v = _bshd(B, Sq, H, d), _bshd(B, Sk, H, d), _bshd(B, Sk, H, d)
    assert flash.route(q, k, v) == "tensor_core"
    assert flash.tc_query_tile(d, Sq) == rows
    dims, strides, box = flash.tma_geometry(q, flash.tc_query_tile(d, Sq))
    assert dims == (64, Sq, H, B)
    assert strides == (H * 64 * 2, 64 * 2, Sq * H * 64 * 2)
    assert box == (64, rows, 1, 1) and dims[0] == box[0]
    tile = flash.tc_key_tile(d)
    assert tile == 128
    for t in (k, v):
        dims, strides, box = flash.tma_geometry(t, tile)
        assert dims == (64, Sk, H, B)
        assert strides == (2048, 128, Sk * 2048)
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


def test_the_recurrentgemma_prefill_hands_the_kernel_tensor_core_operands(
        monkeypatch):
    """The operands recurrentgemma's local attention gives the kernel in a
    bf16 prefill step of its smoke() with the full head dim (256; 4 query
    heads on one kv head, narrow elsewhere): each call takes the
    tensor-core route, and the fp32 step's the CUDA cores."""
    base = dataclasses.replace(get_arch("recurrentgemma-9b").smoke(),
                               head_dim=256)
    tokens = np.random.default_rng(0).integers(0, base.vocab, (2, 24))
    op = attention.flash_attention_op
    for dtype, want in ((torch.bfloat16, "tensor_core"),
                        (torch.float32, "cuda_core")):
        cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
        seen = []

        def spy(q, k, v, **kw):
            seen.append((flash.route(q, k, v), q.shape, k.shape, v.shape))
            return op(q, k, v, **kw)

        monkeypatch.setattr(attention, "flash_attention_op", spy)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        logits = build_prefill_step(cfg, "cpu")(params, {"tokens": tokens})
        assert bool(torch.isfinite(logits.float()).all())
        assert len(seen) == cfg.num_superblocks       # one gqa a block
        for r, qs, ks, vs in seen:
            assert r == want
            assert qs == (2, 4, 24, 256)
            assert ks == vs == (2, 1, 24, 256)


def test_llava_and_seamless_views_take_the_tensor_cores():
    """At full width, as the projections give them ([B, S, H, d] views of
    the [B, S, H * d] products, seen as [B, H, S, d]; ``torch.empty``, so
    nothing is touched): llava's q [4, 56, 2048, 128] on k, v
    [4, 8, 2048, 128] (G = 7), and seamless's cross attention, q
    [4, 16, 2048, 64] on the encoder's k, v [4, 16, 512, 64]."""
    def proj(B, S, H, d):
        return torch.empty(B, S, H * d, dtype=torch.bfloat16).view(
            B, S, H, d).transpose(1, 2)

    llava = get_arch("llava-next-34b").full()
    H, K, d = llava.num_heads, llava.num_kv_heads, llava.head_dim
    assert (H, K, H // K, d) == (56, 8, 7, 128)
    assert flash.route(proj(4, 2048, H, d), proj(4, 2048, K, d),
                       proj(4, 2048, K, d)) == "tensor_core"
    seamless = get_arch("seamless-m4t-large-v2").full()
    H, d = seamless.num_heads, seamless.head_dim
    assert (H, seamless.num_kv_heads, d) == (16, 16, 64)
    assert flash.route(proj(4, 2048, H, d), proj(4, 512, H, d),
                       proj(4, 512, H, d)) == "tensor_core"


@pytest.mark.parametrize("B,S,H,K", [(4, 2048, 32, 8), (4, 2048, 32, 2),
                                     (4, 2048, 56, 8), (1, 100, 14, 2)])
def test_bf16_d128_views_take_the_tensor_cores(B, S, H, K):
    """The (128, 128) kernel's calls: qwen3-4b's, chatglm3-6b's (G = 16)
    and llava's (G = 7) prefill views at full width, and a ragged one,
    bshd views and contiguous tensors alike (``torch.empty``: nothing is
    touched)."""
    def bshd(n):
        return torch.empty(B, S, n, 128, dtype=torch.bfloat16).transpose(
            1, 2)

    assert flash.route(bshd(H), bshd(K), bshd(K)) == "tensor_core"
    q, k = (torch.empty(B, n, S, 128, dtype=torch.bfloat16)
            for n in (H, K))
    assert flash.route(q, k, k) == "tensor_core"


@pytest.mark.parametrize("sq", [1, 64, 100, 128, 129, 512, 513, 2048,
                                4096])
def test_query_tile_at_d128_is_128_at_every_length(sq):
    """The (128, 128) kernel's work tiles and Q's TMA box are 128 rows,
    two consumer warpgroups', whatever Sq."""
    assert flash.tc_query_tile(128, sq) == 128


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_counter_exactly_for_causal_persistent_calls(d, causal):
    """The persistent kernels ((64, 64), (128, 128)) take causal work tiles
    from a counter in the wrapper's scratch; their other calls and the
    other instances take none."""
    assert flash.tc_tile_counter(d, causal) == (causal and d in (64, 128))


def _fake_launch(monkeypatch):
    """Replace the library by a stand-in that records the tensor-core
    entry point's scratch pointer and geometry (read while the wrapper's
    ctypes array is alive) and returns success."""
    calls = []

    class Lib:
        @staticmethod
        def repro_flash_attention_sm90(*args):
            geom = (ctypes.c_longlong * 44).from_address(args[4])
            calls.append({"scratch": args[17], "geom": list(geom),
                          "d": args[11], "dv": args[12]})
            return 0

    monkeypatch.setattr(flash.build, "library", lambda: Lib)
    monkeypatch.setattr(flash.build, "stream_handle", lambda device: 0)
    return calls


@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (192, 128),
                                  (256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_wrapper_asks_for_the_tile_counter_as_tc_tile_counter_says(
        monkeypatch, d, dv, causal):
    """``_launch_tensor_core`` hands the library 4 bytes of scratch for the
    work-tile counter exactly when ``tc_tile_counter`` says so, and the
    geometry of q, k, v and the output, the output's box
    ``TC_OUT_ROWS`` rows."""
    calls = _fake_launch(monkeypatch)
    q, k = (torch.zeros(1, 2, 300, n, dtype=torch.bfloat16).transpose(
        1, 2) for n in (d, d))
    v = torch.zeros(1, 2, 300, dv, dtype=torch.bfloat16).transpose(1, 2)
    out = flash._launch_tensor_core(q, k, v, causal=causal)
    (call,) = calls
    assert (call["scratch"] is not None) == flash.tc_tile_counter(d, causal)
    assert (call["d"], call["dv"]) == (d, dv)
    want = [x for part in flash.tma_geometry(out, flash.TC_OUT_ROWS)
            for x in part]
    assert call["geom"][33:] == want
    assert call["geom"][40:] == [64, flash.TC_OUT_ROWS, 1, 1]


def test_output_tensor_map_has_q_geometry_at_the_bshd_view():
    """At (128, 128) the output is ``empty_like(q)``: at the model's bshd
    view its tensor map has q's dims and byte strides (the box a
    warpgroup's 64 rows)."""
    q = _bshd(4, 2048, 32, 128)
    out = flash.empty_like_q(q, 128)
    dims, strides, box = flash.tma_geometry(out, flash.TC_OUT_ROWS)
    assert (dims, strides) == flash.tma_geometry(q)[:2]
    assert box == (64, 64, 1, 1)
    assert all(s % 16 == 0 for s in strides)


@pytest.mark.parametrize("pairs,n_q", [(128, 16), (224, 16), (8, 3),
                                       (13, 5), (1, 1), (98, 3)])
def test_work_tiles_cover_every_tile_once_heaviest_first(pairs, n_q):
    """``tc_work_tile`` (the persistent kernels' order) visits every (pair,
    query tile) once: the pairs in groups of ``TC_HEAD_GROUP``, a group's
    last query tiles (the heaviest under the causal mask) first, each
    over the group's pairs."""
    order = [flash.tc_work_tile(w, pairs, n_q) for w in range(pairs * n_q)]
    assert sorted(order) == [(p, t) for p in range(pairs)
                             for t in range(n_q)]
    G = flash.TC_HEAD_GROUP
    for w, (p, t) in enumerate(order):
        group = w // (G * n_q)
        assert group * G <= p < min(pairs, (group + 1) * G)
        if w + 1 < len(order) and order[w + 1][0] // G == p // G:
            assert order[w + 1][1] <= t


@pytest.mark.parametrize("B,H,Sq", [(4, 32, 2048), (4, 56, 2048),
                                    (2, 49, 257)])
def test_last_query_tiles_come_after_a_blocks_first(B, H, Sq):
    """At rows 7 and 7d and the persistent-grid feature case, some of the
    last query tiles (the planted fault ``skips_last_query_tile``) are
    work tiles past the grid of 132 blocks, taken after a block's first."""
    pairs, n_q = B * H, -(-Sq // 128)
    ws = [w for w in range(pairs * n_q)
          if flash.tc_work_tile(w, pairs, n_q)[1] == n_q - 1]
    assert len(ws) == pairs
    assert max(ws) >= min(132, pairs * n_q)


def _spy_prefill(monkeypatch, cfg, batch):
    """(route, causal, q shape, k shape) of every flash call a bf16 prefill
    step of ``cfg`` makes on the CPU."""
    seen = []
    op = attention.flash_attention_op

    def spy(q, k, v, **kw):
        seen.append((flash.route(q, k, v), kw["causal"], tuple(q.shape),
                     tuple(k.shape)))
        return op(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_op", spy)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    logits = build_prefill_step(cfg, "cpu")(params, batch)
    assert bool(torch.isfinite(logits.float()).all())
    return seen


def test_the_llava_prefill_hands_the_kernel_tensor_core_operands(
        monkeypatch):
    """llava's smoke() at its full head dim (128) and grouping (14 query
    heads on 2 kv heads, G = 7), bf16, 4 patches before 20 tokens: each
    layer's call takes the tensor cores, causal, over all 24 positions."""
    cfg = dataclasses.replace(get_arch("llava-next-34b").smoke(),
                              head_dim=128, num_heads=14, num_kv_heads=2,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 20)),
             "frontend": rng.standard_normal((2, 4, cfg.d_model))}
    seen = _spy_prefill(monkeypatch, cfg, batch)
    assert seen == [("tensor_core", True, (2, 14, 24, 128),
                     (2, 2, 24, 128))] * cfg.num_layers


def test_the_seamless_prefill_hands_the_kernel_tensor_core_operands(
        monkeypatch):
    """seamless's smoke() at its full head dim (64), bf16, 24 tokens and 6
    frames: the encoder's layers (non-causal, 6 on 6), then each decoder
    layer's self attention (causal, 24 on 24) and cross attention
    (non-causal, 24 queries on the encoder's 6 keys), all on the tensor
    cores."""
    cfg = dataclasses.replace(get_arch("seamless-m4t-large-v2").smoke(),
                              head_dim=64, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)),
             "src": rng.standard_normal((2, 6, cfg.d_model))}
    seen = _spy_prefill(monkeypatch, cfg, batch)
    H = cfg.num_heads
    enc = ("tensor_core", False, (2, H, 6, 64), (2, H, 6, 64))
    self_attn = ("tensor_core", True, (2, H, 24, 64), (2, H, 24, 64))
    cross = ("tensor_core", False, (2, H, 24, 64), (2, H, 6, 64))
    assert seen == ([enc] * cfg.enc_superblocks
                    + [self_attn, cross] * cfg.num_superblocks)


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
