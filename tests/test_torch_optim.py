"""The port's optimizers and gradient compression (``repro_torch.optim``)
against the JAX package's (``repro.optim``) on the CPU, from the same
numpy state: AdamW and Adafactor over 3 steps in fp32 within 1e-6 (the
updates are the same fp32 arithmetic; the sums of the global norm and
Adafactor's means run in another order), bf16 params equal after the
cast, the global norm, the cosine schedule, the int8 codes and the error
feedback residuals; then the port's cases of ``tests/test_substrate.py``'s
optimizer and compression tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim
from repro_torch.models.layers import tree_leaves

TOL = 1e-6


def _tree(seed=0, scale=1.0):
    """A tree of numpy leaves: a matrix, a vector, a 3-D leaf and a
    [n, 1] leaf (unfactored under Adafactor), nested."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": r(6, 5), "b": r(5), "blk": {"k": r(3, 4, 2), "col": r(4, 1)}}


def _torch_tree(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype)


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np(tree):
    """Leaves of a JAX tree in the port's walk order (the dict orders of
    ``_tree``)."""
    return [np.asarray(tree["w"], np.float32), np.asarray(tree["b"],
            np.float32), np.asarray(tree["blk"]["k"], np.float32),
            np.asarray(tree["blk"]["col"], np.float32)]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_matches_jax(clip_norm):
    """3 steps, weight decay 0.1; a clip of 1.0 bites (the gradients'
    norm is about 6), one of 100 does not."""
    cfg = dict(lr=1e-2, clip_norm=clip_norm)
    params = _tree(0)
    p, jp = _torch_tree(params), _jax_tree(params)
    s, js = optim.adamw_init(p), jopt.adamw_init(jp)
    for i in range(3):
        g = _tree(10 + i)
        p, s = optim.adamw_update(p, _torch_tree(g), s,
                                  optim.AdamWConfig(**cfg))
        jp, js = jopt.adamw_update(jp, _jax_tree(g), js,
                                   jopt.AdamWConfig(**cfg))
        assert abs(float(s["grad_norm"]) - float(js["grad_norm"])) <= \
            TOL * float(js["grad_norm"])
        js = {k: js[k] for k in ("mu", "nu", "count")}
        _close(tree_leaves(p), _np(jp))
        _close(tree_leaves(s["mu"]), _np(js["mu"]))
        _close(tree_leaves(s["nu"]), _np(js["nu"]))
        assert s["count"].dtype == torch.int32
        assert int(s["count"]) == int(js["count"]) == i + 1
    assert all(m.dtype == torch.float32 for m in tree_leaves(s["mu"]))


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adafactor_update_matches_jax(weight_decay):
    """Factored ([6, 5], [3, 4, 2]) and unfactored ([5], [4, 1]) leaves,
    3 steps, with and without weight decay."""
    cfg = dict(lr=1e-2, weight_decay=weight_decay)
    params = _tree(1)
    p, jp = _torch_tree(params), _jax_tree(params)
    s, js = optim.adafactor_init(p), jopt.adafactor_init(jp)
    assert set(s["v"]["w"]) == {"vr", "vc"}
    assert set(s["v"]["blk"]["col"]) == {"v"}
    for i in range(3):
        g = _tree(20 + i, scale=0.1 * (i + 1))
        p, s = optim.adafactor_update(p, _torch_tree(g), s,
                                      optim.AdafactorConfig(**cfg))
        jp, js = jopt.adafactor_update(jp, _jax_tree(g), js,
                                       jopt.AdafactorConfig(**cfg))
        _close(tree_leaves(p), _np(jp))
        for key in (("w", "vr"), ("w", "vc"), ("b", "v")):
            np.testing.assert_allclose(
                s["v"][key[0]][key[1]].numpy(),
                np.asarray(js["v"][key[0]][key[1]]), rtol=1e-6)
        assert int(s["count"]) == int(js["count"]) == i + 1


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_bf16_params_equal_jax_after_the_cast(name):
    params = _tree(2)
    p, jp = _torch_tree(params, torch.bfloat16), _jax_tree(params,
                                                           jnp.bfloat16)
    init, upd, ocfg = {
        "adamw": (optim.adamw_init, optim.adamw_update, optim.AdamWConfig),
        "adafactor": (optim.adafactor_init, optim.adafactor_update,
                      optim.AdafactorConfig)}[name]
    jinit, jupd, jcfg = {
        "adamw": (jopt.adamw_init, jopt.adamw_update, jopt.AdamWConfig),
        "adafactor": (jopt.adafactor_init, jopt.adafactor_update,
                      jopt.AdafactorConfig)}[name]
    s, js = init(p), jinit(jp)
    for i in range(3):
        g = _tree(30 + i)
        p, s = upd(p, _torch_tree(g, torch.bfloat16), s, ocfg(lr=3e-2))
        jp, js = jupd(jp, _jax_tree(g, jnp.bfloat16), js, jcfg(lr=3e-2))
        js = {k: v for k, v in js.items() if k != "grad_norm"}
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p))
        for got, want in zip(tree_leaves(p), _np(jp)):
            np.testing.assert_array_equal(got.float().numpy(), want)


def test_clip_by_global_norm_matches_jax():
    g = _tree(3)
    scale, gn = optim.clip_by_global_norm(_torch_tree(g), 1.0)
    jclipped, jgn = jopt.clip_by_global_norm(_jax_tree(g), 1.0)
    assert abs(float(gn) - float(jgn)) <= TOL * float(jgn)
    assert float(optim.global_norm(_torch_tree(g))) == float(gn)
    _close([t.float() * scale for t in tree_leaves(_torch_tree(g))],
           _np(jclipped))
    # Under the limit the factor is 1.
    scale, _ = optim.clip_by_global_norm(_torch_tree(g), 1e6)
    assert float(scale) == 1.0


@pytest.mark.parametrize("total,warmup", [(1000, 100), (50, 0), (10, 20)])
def test_cosine_schedule_matches_jax(total, warmup):
    steps = np.array([0, 1, 5, 10, 37, 99, 100, 101, 500, 999, 1000, 2000],
                     np.int32)
    got = optim.cosine_schedule(torch.from_numpy(steps), total, warmup)
    want = jopt.cosine_schedule(jnp.asarray(steps), total, warmup)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    assert float(optim.cosine_schedule(37, total, warmup)) == \
        pytest.approx(float(want[4]), abs=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_match_jax(seed):
    x = np.random.default_rng(seed).standard_normal(257).astype(
        np.float32) * 10 ** (seed - 1)
    q, s = optim.compress_int8(torch.from_numpy(x))
    jq, js = jopt.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        optim.decompress_int8(q, s).numpy(),
        np.asarray(jopt.decompress_int8(jq, js)))


def test_int8_rounds_half_to_even():
    """amax 127 gives scale 1: the halves round to even, as jnp.round."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5], np.float32)
    q, s = optim.compress_int8(torch.from_numpy(x))
    jq, _ = jopt.compress_int8(jnp.asarray(x))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -126] == np.asarray(
        jq).tolist()


def test_error_feedback_matches_jax():
    res, jres = optim.ErrorFeedback.init(_torch_tree(_tree(0))), \
        jopt.ErrorFeedback.init(_jax_tree(_tree(0)))
    for i in range(4):
        g = _tree(40 + i, scale=0.01 * (i + 1))
        out, res = optim.ErrorFeedback.apply(_torch_tree(g), res)
        jout, jres = jopt.ErrorFeedback.apply(_jax_tree(g), jres)
        _close(tree_leaves(out), _np(jout), tol=1e-7)
        _close(tree_leaves(res), _np(jres), tol=1e-7)


# -- the port's cases of tests/test_substrate.py --------------------------------

def _quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


def _grad(p):
    leaves = [p["w"], p["b"]]
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        g = torch.autograd.grad(_quad_loss(p), leaves)
    return {"w": g[0], "b": g[1]}


def test_adamw_converges():
    params = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    state = optim.adamw_init(params)
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        params, state = optim.adamw_update(params, _grad(params), state,
                                           cfg)
        state = {k: state[k] for k in ("mu", "nu", "count")}
    assert float(_quad_loss(params).detach()) < 1e-2


def test_adafactor_converges():
    params = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    state = optim.adafactor_init(params)
    cfg = optim.AdafactorConfig(lr=0.3)
    for _ in range(300):
        params, state = optim.adafactor_update(params, _grad(params), state,
                                               cfg)
    assert float(_quad_loss(params).detach()) < 5e-2


def test_adafactor_state_is_factored():
    state = optim.adafactor_init({"w": torch.zeros((64, 32))})
    leaves = state["v"]["w"]
    assert leaves["vr"].shape == (64,)
    assert leaves["vc"].shape == (32,)
    assert state["count"].dtype == torch.int32


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 1e3),
                                        (3, 37.5)])
def test_int8_quant_error_bound(seed, scale):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        64).astype(np.float32)) * scale
    q, s = optim.compress_int8(x)
    deq = optim.decompress_int8(q, s)
    amax = float(torch.max(torch.abs(x)))
    assert float(torch.max(torch.abs(deq - x))) <= amax / 127.0 + 1e-6


def test_error_feedback_beats_plain_quantization():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32)) * 0.01
    res = {"g": torch.zeros(256)}
    acc_ef, acc_plain, true = (torch.zeros(256) for _ in range(3))
    for i in range(50):
        gi = g * (1 + 0.1 * i)
        true += gi
        out, res = optim.ErrorFeedback.apply({"g": gi}, res)
        acc_ef += out["g"]
        q, s = optim.compress_int8(gi)
        acc_plain += optim.decompress_int8(q, s)
    assert float(torch.linalg.norm(acc_ef - true)) <= \
        float(torch.linalg.norm(acc_plain - true)) + 1e-5
