"""The port's flash attention op on the CPU (its plain version) against the
JAX package's ``flash_attention_op`` in interpret mode, on the same numpy
inputs: every case of ``tests/test_kernels.py``'s flash attention tests,
fp32 within 2e-5 and bf16 within 2e-2; the cases of the (256, 256)
instances at head dim 256; the card's feature cases in bf16
under the gates that hold the CUDA kernels on the card; the row gate's
power against a key tile skipped at the prefill step's length (128 keys
at d = 128, 64 at d = 256); and, with a
v head dim other than q's (MLA), the plain version against the JAX
model's ``attention_core``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention_op as jax_flash_attention_op
from repro.models.attention import attention_core as jax_attention_core
from repro_torch.kernels import flash_attention_op, launch_counts
from repro_torch.kernels.flash_attention import cases
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def _qkv(B, H, K, Sq, Sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, d), dtype=np.float32),
            rng.standard_normal((B, K, Sk, d), dtype=np.float32),
            rng.standard_normal((B, K, Sk, d), dtype=np.float32))


def _both(arrays, dtype_np, dtype_t, **kw):
    jax_out = jax_flash_attention_op(
        *(jnp.asarray(a, dtype_np) for a in arrays), block_q=64, block_k=64,
        **kw)
    port = flash_attention_op(
        *(torch.from_numpy(a).to(dtype_t) for a in arrays), **kw)
    return np.asarray(jax_out, np.float32), port.float().numpy()


@pytest.mark.parametrize("B,H,K,Sq,Sk,d", [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 64, 64, 32),       # GQA
    (1, 8, 1, 128, 128, 64),     # MQA
    (1, 2, 2, 64, 256, 64),      # decode-style Sq<Sk
    (1, 2, 2, 100, 200, 64),     # unaligned → pad path
])
def test_flash_attention_shapes_match_jax(B, H, K, Sq, Sk, d):
    want, got = _both(_qkv(B, H, K, Sq, Sk, d), jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kwargs", [
    {"window": 32}, {"softcap": 50.0}, {"causal": False},
    {"window": 64, "softcap": 30.0},
])
def test_flash_attention_features_match_jax(kwargs):
    want, got = _both(_qkv(1, 2, 2, 128, 128, 64), jnp.float32,
                      torch.float32, **kwargs)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16_matches_jax():
    want, got = _both(_qkv(1, 2, 2, 128, 128, 64), jnp.bfloat16,
                      torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_flash_attention_window_with_delta_matches_jax():
    """A fully masked leading kv block (window with Sk > Sq): the JAX
    kernel's -1e30 rule and the plain version's -inf agree."""
    want, got = _both(_qkv(1, 4, 2, 64, 256, 32), jnp.float32,
                      torch.float32, window=40)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cpu_tensor_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 16))
    before = launch_counts()["flash_attention"]
    flash_attention_op(q, k, v)
    assert launch_counts()["flash_attention"] == before


def test_kernel_wrapper_refuses_cpu_tensors_and_other_devices():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_op(*meta)


@pytest.mark.parametrize("shape,kwargs",
                         [case[1:] for case in cases.FEATURE_CASES],
                         ids=[case[0] for case in cases.FEATURE_CASES])
def test_feature_cases_in_bf16_pass_the_card_gates(shape, kwargs):
    """The JAX kernel rounds p to bf16 where the CUDA kernels do; against
    the port's plain version (which does not) it passes the gates that
    hold them on the card: elementwise and row by row."""
    B, H, K, Sq, Sk = shape
    jax_out, plain = (torch.from_numpy(a) for a in _both(
        _qkv(B, H, K, Sq, Sk, 64), jnp.bfloat16, torch.bfloat16, **kwargs))
    assert cases.excess(jax_out, plain) <= cases.ATOL
    assert cases.row_rel_err(jax_out, plain) <= cases.ROW_REL_LIMIT


@pytest.mark.parametrize("shape,kwargs",
                         [case[1:] for case in cases.HD256_CASES],
                         ids=[case[0] for case in cases.HD256_CASES])
def test_head_dim_256_cases_match_jax(shape, kwargs):
    """The (256, 256) instance's cases (recurrentgemma-9b's head dim and
    MQA grouping, a window that bites): the port's op against the JAX
    kernel in interpret mode, fp32 within 2e-5, and bf16 under the card's
    gates."""
    B, H, K, Sq, Sk = shape
    arrays = _qkv(B, H, K, Sq, Sk, 256)
    want, got = _both(arrays, jnp.float32, torch.float32, **kwargs)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    jax_out, plain = (torch.from_numpy(a) for a in _both(
        arrays, jnp.bfloat16, torch.bfloat16, **kwargs))
    assert cases.excess(jax_out, plain) <= cases.ATOL
    assert cases.row_rel_err(jax_out, plain) <= cases.ROW_REL_LIMIT


@pytest.mark.parametrize("fault", ["skips_first_tile", "skips_diagonal_tile"])
def test_row_gate_rejects_a_skipped_key_tile(fault):
    """At the prefill step's length (2048 keys, d = 128, causal, bf16) the
    last query block's outputs are ~0.02: a key tile dropped from those
    rows alone fails the row gate by a wide margin."""
    S, T = 2048, 128
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 1, S, S, 128))
    want = attention_ref(q, k, v)
    kk, vv, causal = {
        "skips_first_tile": (k[:, :, T:], v[:, :, T:], True),
        "skips_diagonal_tile": (k[:, :, :S - T], v[:, :, :S - T], False),
    }[fault]
    bad = want.clone()
    bad[:, :, S - T:] = attention_ref(q[:, :, S - T:], kk, vv, causal=causal)
    assert cases.row_rel_err(want, want) == 0.0
    assert cases.row_rel_err(bad, want) > 10 * cases.ROW_REL_LIMIT


@pytest.mark.parametrize("fault", ["skips_first_tile", "skips_diagonal_tile"])
def test_row_gate_rejects_a_skipped_64_key_tile(fault):
    """At recurrentgemma's head dim (256, the tensor cores' 64-key tiles),
    2048 keys, causal, bf16: one 64-key tile dropped from the last 64 rows
    fails the row gate by a wide margin too."""
    from repro_torch.kernels.flash_attention.kernel import tc_key_tile

    S, T = 2048, tc_key_tile(256)
    assert T == 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 1, S, S, 256))
    want = attention_ref(q, k, v)
    kk, vv, causal = {
        "skips_first_tile": (k[:, :, T:], v[:, :, T:], True),
        "skips_diagonal_tile": (k[:, :, :S - T], v[:, :, :S - T], False),
    }[fault]
    bad = want.clone()
    bad[:, :, S - T:] = attention_ref(q[:, :, S - T:], kk, vv, causal=causal)
    assert cases.row_rel_err(bad, want) > 10 * cases.ROW_REL_LIMIT


@pytest.mark.parametrize("d,dv,kwargs", [
    (24, 16, {}),                      # deepseek smoke()'s MLA
    (192, 128, {}),                    # deepseek full()'s MLA
    (24, 16, {"window": 5, "softcap": 30.0}),
    (12, 8, {"causal": False}),
])
def test_plain_version_v_head_dim_matches_jax_attention_core(d, dv, kwargs):
    """The Pallas kernel takes one head dim; the JAX model's MLA prefill
    runs ``attention_core`` (jnp) with q/k and v head dims that differ.
    The op's plain version against it, fp32, on [B,S,H,d] inputs."""
    rng = np.random.default_rng(7)
    B, S, H, K = 2, 16, 4, 2
    q = rng.standard_normal((B, S, H, d), dtype=np.float32)
    k = rng.standard_normal((B, S, K, d), dtype=np.float32)
    v = rng.standard_normal((B, S, K, dv), dtype=np.float32)
    causal = kwargs.get("causal", True)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = jax_attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
        window=kwargs.get("window"), softcap=kwargs.get("softcap"),
        scale=d ** -0.5, q_chunk=8, causal=causal)
    got = flash_attention_op(*(torch.from_numpy(a).transpose(1, 2)
                               for a in (q, k, v)), scale=d ** -0.5,
                             **kwargs).transpose(1, 2)
    assert got.shape == (B, S, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_v_head_dim_routes_to_the_cuda_cores():
    """bf16 at a tensor-core head dim still takes the CUDA cores when v's
    head dim differs and (d, dv) is not MLA's (192, 128), the one unequal
    pair of the tensor cores: (128, 64) here.  The wrapper's output is
    [B,H,Sq,dv] laid out like q."""
    from repro_torch.kernels.flash_attention.kernel import (empty_like_q,
                                                            route)
    q = torch.zeros(2, 32, 4, 128, dtype=torch.bfloat16).transpose(1, 2)
    v = torch.zeros(2, 32, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert route(q, q, q) == "tensor_core"
    assert route(q, q, v) == "cuda_core"
    out = empty_like_q(q, 64)
    assert out.shape == (2, 4, 32, 64)
    assert out.transpose(1, 2).is_contiguous()
    assert empty_like_q(q.contiguous(), 64).is_contiguous()
