"""The port's flash attention op on the CPU (its plain version) against the
JAX package's ``flash_attention_op`` in interpret mode, on the same numpy
inputs: every case of ``tests/test_kernels.py``'s flash attention tests,
fp32 within 2e-5 and bf16 within 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention_op as jax_flash_attention_op
from repro_torch.kernels import flash_attention_op, launch_counts
from repro_torch.kernels.flash_attention.kernel import flash_attention


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
