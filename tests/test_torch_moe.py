"""The port's MoE FFN against the JAX package on the CPU, in fp32, on the
same numpy inputs and the same weights (JAX's ``init_moe`` carried over):
the routed expert ids equal, the capacity drops equal to the rule JAX
applies (a case that drops and one that drops nothing), the output within
1e-5 of its scale and the aux loss within 1e-6.  Then the properties of
``tests/test_moe_properties.py`` on the port, as fixed-seed cases, and the
router's fp32 whatever the model's dtype.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro_torch.models import moe, params_from_jax
from repro_torch.models.convert import tree_from_numpy

from _torch_parity import np_tree, scaled_err, torch_model_config

TOL = 1e-5
AUX_TOL = 1e-6


def mk(E=8, k=2, D=16, F=32, cf=2.0, shared=0, aux_free=True, softcap=None,
       module=moe):
    return module.MoEConfig(d_model=D, d_ff_expert=F, num_experts=E,
                            top_k=k, num_shared=shared, capacity_factor=cf,
                            aux_loss_free=aux_free, router_softcap=softcap)


def _x(G, S, D, seed=1):
    return np.random.default_rng(seed).standard_normal((G, S, D),
                                                       dtype=np.float32)


def keep_rule(idx: np.ndarray, C: int) -> np.ndarray:
    """JAX's drop rule in numpy: slots in token-major order (then choice),
    a slot kept while fewer than C earlier slots of its group chose its
    expert."""
    G = idx.shape[0]
    flat = idx.reshape(G, -1)
    keep = np.zeros(flat.shape, bool)
    for g in range(G):
        seen = {}
        for i, e in enumerate(flat[g]):
            keep[g, i] = seen.get(e, 0) < C
            seen[e] = seen.get(e, 0) + 1
    return keep


# (name, config keywords, G, S): "drops" fills some experts past their
# capacity C = 5; "no_drops" has C = S.
PARITY_CASES = {
    "drops": (dict(cf=1.25, shared=0, aux_free=False), 2, 16),
    "drops_shared_aux_free": (dict(cf=1.25, shared=2, aux_free=True), 3, 16),
    "no_drops": (dict(cf=4.0, shared=1, aux_free=False), 2, 16),
    "no_drops_softcap": (dict(cf=4.0, shared=0, softcap=2.0), 2, 12),
}


@pytest.mark.parametrize("name", sorted(PARITY_CASES))
def test_moe_forward_matches_jax(name):
    kw, G, S = PARITY_CASES[name]
    jcfg, cfg = mk(module=jmoe, **kw), mk(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    # Aux-loss-free routing with a non-zero bias, so the bias takes part.
    jp["router_bias_e"] = jnp.linspace(-0.5, 0.5, jcfg.num_experts)
    p = tree_from_numpy(np_tree(jp), device="cpu")
    x = _x(G, S, cfg.d_model)

    jidx, jw, jaux = jmoe._route(jp, jcfg, jnp.asarray(x))
    idx, w, aux = moe._route(p, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert scaled_err(w, jw) <= TOL

    C = moe.capacity(cfg, S)
    want_keep = keep_rule(np.asarray(jidx), C)
    keep = (moe.slot_positions(idx.reshape(G, -1), cfg.num_experts)
            < C).numpy()
    np.testing.assert_array_equal(keep, want_keep)
    assert (not want_keep.all()) == name.startswith("drops")

    want, jaux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(p, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert scaled_err(got, want) <= TOL
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


def test_deepseek_smoke_moe_matches_jax():
    """deepseek-v2's smoke() MoE (8 experts, top-2, 2 shared, capacity
    1.25) on an 8-token group."""
    jcfg = jax_configs.get_arch("deepseek-v2-236b").smoke().moe
    cfg = torch_model_config(
        jax_configs.get_arch("deepseek-v2-236b").smoke()).moe
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    p = tree_from_numpy(np_tree(jp), device="cpu")
    x = _x(2, 8, cfg.d_model, seed=4)
    want, jaux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(p, cfg, torch.from_numpy(x))
    assert scaled_err(got, want) <= TOL
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


# -- the properties of tests/test_moe_properties.py, on the port --------------

def _params(cfg, seed=0, dtype=torch.float32):
    return moe.init_moe(torch.Generator().manual_seed(seed), cfg, dtype)


@pytest.mark.parametrize("seed,G,S,aux_free", [
    (0, 1, 2, True), (17, 3, 8, False), (523, 2, 5, True),
    (4242, 1, 7, False), (9999, 3, 3, True),
])
def test_moe_output_finite_and_shaped(seed, G, S, aux_free):
    cfg = mk(aux_free=aux_free)
    y, aux = moe.moe_forward(_params(cfg, seed % 100), cfg,
                             torch.from_numpy(_x(G, S, cfg.d_model, seed)))
    assert y.shape == (G, S, cfg.d_model)
    assert bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0


def test_moe_combine_weights_normalized():
    cfg = mk()
    idx, w, _ = moe._route(_params(cfg), cfg,
                           torch.from_numpy(_x(2, 8, cfg.d_model)))
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert bool((idx >= 0).all()) and bool((idx < cfg.num_experts).all())


def test_moe_capacity_drops_zero_not_garbage():
    """With capacity_factor → 0 (C = 1), at most E slots of a group
    survive: every other token's routed output is exactly zero (no shared
    expert)."""
    cfg = mk(cf=1e-9, shared=0)
    y, _ = moe.moe_forward(_params(cfg), cfg,
                           torch.from_numpy(_x(2, 16, cfg.d_model)))
    zero_rows = int((y == 0.0).all(dim=-1).sum())
    assert zero_rows >= 2 * 16 - 2 * cfg.num_experts


def combine_case(dtype, seed=0):
    """Routes, capacity drops and expert outputs for ``moe.combine``: G 3,
    S 24, E 8, k 3, C 6 (some slots dropped), D 40.  Returns the combine's
    arguments and the [G·(S+1)] token row of each buffer slot (an empty
    slot's is its group's pad row S)."""
    G, S, E, k, C, D = 3, 24, 8, 3, 6, 40
    gen = torch.Generator().manual_seed(seed)
    idx = torch.rand(G, S, E, generator=gen).argsort(-1)[..., :k]
    flat_e = idx.reshape(G, S * k)
    pos = moe.slot_positions(flat_e, E)
    keep = pos < C
    assert 0 < int(keep.sum()) < keep.numel()
    g = torch.arange(G)[:, None].expand(G, S * k)
    slot_of = torch.where(keep, (flat_e * G + g) * C + pos, E * G * C)
    contrib = torch.randn(E * G * C, D, generator=gen).to(dtype)
    buf_tok = (torch.arange(E * G * C) // C % G) * (S + 1) + S
    buf_tok[slot_of[keep]] = (g * (S + 1) + torch.arange(S * k) // k)[keep]
    return contrib, slot_of.view(G, S, k), idx, buf_tok


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_gives_the_index_add_bits(dtype):
    """``combine`` gives, bit for bit, the CPU's ``index_add_`` of the
    expert-major buffer onto its tokens (dropped and empty slots on the pad
    row), in fp32 and in bf16 (which ``index_add_`` sums in fp32)."""
    contrib, slot_of, idx, buf_tok = combine_case(dtype)
    G, S, _ = idx.shape
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    want = torch.zeros(G * (S + 1), contrib.shape[1], dtype=dtype)
    want = want.index_add_(0, buf_tok, contrib).view(G, S + 1, -1)[:, :S]
    got = moe.combine(contrib, slot_of, idx)
    assert got.dtype == dtype
    assert torch.equal(got.view(bits), want.view(bits))


def test_moe_permutation_equivariance():
    """Permuting tokens within a group permutes the outputs alike (no
    drops: generous capacity)."""
    cfg = mk(cf=8.0)
    params = _params(cfg)
    x = torch.from_numpy(_x(1, 8, cfg.d_model))
    perm = torch.tensor([3, 1, 7, 0, 5, 2, 6, 4])
    y1, _ = moe.moe_forward(params, cfg, x)
    y2, _ = moe.moe_forward(params, cfg, x[:, perm])
    np.testing.assert_allclose(y1[:, perm].numpy(), y2.numpy(), atol=2e-5)


def test_aux_free_bias_changes_routing_not_weights():
    """The aux-free bias shifts the selection, but the combine weights stay
    the softmax of the logits."""
    cfg = mk(aux_free=True)
    params = _params(cfg)
    x = torch.from_numpy(_x(1, 4, cfg.d_model))
    biased = dict(params)
    biased["router_bias_e"] = params["router_bias_e"].clone()
    biased["router_bias_e"][0] += 100.0
    idx1, w1, _ = moe._route(biased, cfg, x)
    assert bool((idx1[..., 0] == 0).all())
    probs = torch.softmax(x @ params["router_de"], -1)
    picked = torch.gather(probs, -1, idx1)
    np.testing.assert_allclose(w1[..., 0].numpy(),
                               (picked[..., 0] / picked.sum(-1)).numpy(),
                               atol=1e-5)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router logits: jax.lax.top_k picks the lowest ids."""
    cfg = mk(E=6, k=3, aux_free=False)
    params = _params(cfg)
    params["router_de"] = torch.zeros_like(params["router_de"])
    idx, w, _ = moe._route(params, cfg,
                           torch.from_numpy(_x(2, 3, cfg.d_model)))
    assert bool((idx == torch.tensor([0, 1, 2])).all())
    np.testing.assert_allclose(w.numpy(), 1 / 3, atol=1e-6)


# -- the router's dtype ---------------------------------------------------------

def test_router_is_fp32_whatever_the_dtype():
    """bf16 experts, fp32 router: drawn so, and carried over from JAX so
    (JAX keeps router_de and router_bias_e fp32)."""
    cfg = mk(shared=1)
    p = _params(cfg, dtype=torch.bfloat16)
    assert p["router_de"].dtype == p["router_bias_e"].dtype == torch.float32
    assert p["wi_edf"].dtype == p["shared"]["wi_df"].dtype == torch.bfloat16

    jcfg = dataclasses.replace(jax_configs.get_arch("deepseek-v3-671b").smoke(),
                               dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tree = params_from_jax(np_tree(j_init_params(jax.random.PRNGKey(0),
                                                 jcfg)),
                           torch_model_config(jcfg), device="cpu")
    ffn = tree["blocks"][0]["ffn"]
    assert ffn["router_de"].dtype == ffn["router_bias_e"].dtype == \
        torch.float32
    assert ffn["wi_edf"].dtype == tree["embed_vd"].dtype == torch.bfloat16


def test_expert_init_draws_n01_over_fan_in():
    cfg = mk(E=4, D=64, F=48)
    p = _params(cfg)
    for name, fan_in in (("wi_edf", 64), ("wg_edf", 64), ("wo_efd", 48)):
        t = p[name]
        assert t.shape[0] == 4 and t.shape[1] == fan_in
        assert abs(float(t.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert not torch.equal(p["wi_edf"][0], p["wi_edf"][1])
