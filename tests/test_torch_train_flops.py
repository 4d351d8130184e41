"""``chip_smoke.train_step_flops``, the model FLOPs behind the ``[train]``
rows' MFU, at the rows' 4 × 2048 tokens.  The three rows that ran before
MoE, MLA and enc-dec were counted keep their values (6·N·T plus the causal
GQA pairs); the seamless-m4t-large-v2, llava-next-34b and deepseek-v2-236b
rows are held to counts written out from their configs.  Runs on the CPU:
importing the script makes no CUDA call."""
import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.configs import get_arch

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 2048
CAUSAL = S * (S + 1) // 2


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_flops", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _no_cuda(*args, **kw):
    raise AssertionError("importing chip_smoke made a CUDA call")


@pytest.fixture(scope="module")
def smoke():
    with mock.patch.object(torch.cuda, "_lazy_init", _no_cuda):
        return _load_smoke()


def test_importing_chip_smoke_makes_no_cuda_call():
    with mock.patch.object(torch.cuda, "_lazy_init", _no_cuda):
        module = _load_smoke()
    assert callable(module.train_step_flops)
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("arch,want", [
    pytest.param("qwen3-4b", 212563006586880.0, id="qwen3-4b"),
    pytest.param("recurrentgemma-9b", 466786776514560.0,
                 id="recurrentgemma-9b"),
    pytest.param("xlstm-1.3b", 89258043899904.0, id="xlstm-1.3b")])
def test_earlier_rows_keep_their_flops(smoke, arch, want):
    got = smoke.train_step_flops(get_arch(arch).full(), B, S)
    assert abs(got - want) <= 1e-4 * want


def _seamless() -> float:
    """24 encoder layers over S // 4 frames, 24 decoder layers over S
    positions, each with a cross block whose K and V act on the frames;
    the tied table once; non-causal encoder and cross pairs."""
    D, V, H, K, hd, F, L = 1024, 256206, 16, 16, 64, 8192, 24
    E = S // 4
    layer = 2 * D * hd * (H + K) + 3 * D * F + 2 * D
    cross_qo, cross_kv = 2 * D * H * hd, 2 * D * K * hd
    per_token = L * (layer + cross_qo + D) + D + V * D
    per_frame = L * layer + D + L * cross_kv
    attn = 3 * 2 * (2 * hd) * H * (L * CAUSAL + L * E * E + L * S * E)
    return 6 * B * (per_token * S + per_frame * E) + B * attn


def _llava() -> float:
    """6 of 60 layers, G = 7; the 576 patches are among the S positions;
    the untied unembedding counts, the input table (a lookup) does not."""
    D, V, H, K, hd, F, L = 7168, 64000, 56, 8, 128, 20480, 6
    layer = 2 * D * hd * (H + K) + 3 * D * F + 2 * D
    per_token = L * layer + D + V * D
    attn = 3 * 2 * (2 * hd) * H * L * CAUSAL
    return 6 * B * per_token * S + B * attn


def _deepseek_v2() -> float:
    """1 of 60 layers: MLA at 128 heads, qk 192 and v 128; 6 of 160
    routed experts and the 2 shared; the untied unembedding."""
    D, V, H = 5120, 102400, 128
    qrank, kvrank, qn, qr, vd = 1536, 512, 128, 64, 128
    E, k, Fe, shared = 160, 6, 1536, 2
    mla = (D * qrank + qrank + qrank * H * (qn + qr) + D * (kvrank + qr)
           + kvrank + kvrank * H * (qn + vd) + H * vd * D)
    moe = D * E + E + 3 * D * Fe * k + 3 * D * Fe * shared
    per_token = mla + moe + 2 * D + D + V * D
    attn = 3 * 2 * ((qn + qr) + vd) * H * CAUSAL
    return 6 * B * per_token * S + B * attn


@pytest.mark.parametrize("arch,superblocks,count", [
    pytest.param("seamless-m4t-large-v2", None, _seamless,
                 id="seamless-m4t-large-v2"),
    pytest.param("llava-next-34b", 6, _llava, id="llava-next-34b"),
    pytest.param("deepseek-v2-236b", 1, _deepseek_v2,
                 id="deepseek-v2-236b")])
def test_new_rows_count_what_a_step_computes(smoke, arch, superblocks,
                                             count):
    cfg = get_arch(arch).full()
    if superblocks is not None:
        cfg = dataclasses.replace(cfg, num_superblocks=superblocks)
    want = count()
    assert abs(smoke.train_step_flops(cfg, B, S) - want) <= 1e-9 * want
