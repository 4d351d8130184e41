"""The port's training slice against the JAX package on the CPU, in fp32,
on the same numpy inputs and weights (``params_from_jax``) and the same
optimizer state (``opt_state_from_jax``).

- The flash op's gradient (``FlashAttentionFn``: the plain forward on the
  CPU, the backward of ``kernels/flash_attention/backward.py``):
  ``gradcheck`` in fp64; against autograd of ``attention_ref`` within
  1e-5 of each gradient's scale (causal, no mask, window, softcap, G in
  {1, 2, 7}, Sq < Sk, (d, dv) = (192, 128), one row a chunk); against
  ``jax.grad`` of JAX's ``attention_core``.
- ``train_loss`` and every leaf of its gradient against
  ``jax.value_and_grad(train_loss)``: the loss within 1e-5 relative, each
  leaf within 1e-4 of that leaf's norm, for qwen3-4b, gemma2-27b,
  deepseek-v3-671b, seamless-m4t-large-v2, llava-next-34b,
  recurrentgemma-9b and xlstm-1.3b ``smoke()``; ``chunked_xent`` over
  several chunks; ``update_router_bias``; the flash op's calls under
  recompute; the per-layer recompute of a 4-layer pattern (3 mLSTM and an
  sLSTM) against JAX's ``inner_remat``, with each layer's forward runs
  counted.
- ``build_train_step`` over 2 steps against JAX's (no mesh), AdamW and
  Adafactor, microbatches 1 and 2 (recurrentgemma with Adafactor, xlstm
  with AdamW); the port's
  ``test_training_reduces_loss`` and ``test_checkpoint_restart_bitexact``
  (``tests/test_system.py``), the Trainer resumed under
  ``run_with_restarts``, and the CLI in a subprocess (qwen3-4b and
  xlstm-1.3b).
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import attention as jattn
from repro.models import LayerSpec as JLayerSpec
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.optim import adafactor_init as j_adafactor_init
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.kernels.flash_attention import backward as fbw
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ops import (attention_ref,
                                                     flash_attention_op)
from repro_torch.launch.steps import (batch_to_device, build_train_step,
                                      init_train_state)
from repro_torch.launch.train import data_config, train_with_restarts
from repro_torch.data import make_pipeline
from repro_torch.models import (attention as attn, moe, opt_state_from_jax,
                                params_from_jax)
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_paths
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import FailureInjector, TrainerConfig

from _torch_parity import np_tree, scaled_err, torch_model_config

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-5
LEAF_TOL = 1e-4


def _rand(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def _qkv(B, H, K, Sq, Sk, d, dv, dtype=torch.float32, seed=0):
    return tuple(_rand(*s, seed=seed + i, dtype=dtype).requires_grad_(True)
                 for i, s in enumerate(((B, H, Sq, d), (B, K, Sk, d),
                                        (B, K, Sk, dv))))


# -- the flash op's gradient ----------------------------------------------------

@pytest.mark.parametrize("shape,kw", [
    ((1, 2, 2, 5, 5, 4, 4), {}),
    ((1, 4, 2, 5, 7, 3, 2), {"causal": False}),
    ((2, 2, 1, 6, 6, 4, 3), {"window": 3}),
    ((1, 2, 2, 4, 6, 4, 4), {"softcap": 2.0}),
    ((1, 7, 1, 3, 8, 4, 4), {"window": 2, "softcap": 1.5}),
])
def test_flash_op_gradcheck_fp64(shape, kw):
    q, k, v = _qkv(*shape, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention_op(a, b, c, **kw), (q, k, v))


# (B, H, K, Sq, Sk, d, dv), keywords: G = 1, 2 and 7; Sq < Sk; MLA's
# (192, 128).
GRAD_CASES = [
    ((2, 4, 2, 16, 16, 16, 16), {}),
    ((1, 4, 4, 16, 16, 16, 16), {"causal": False}),
    ((1, 4, 2, 16, 16, 16, 16), {"window": 5}),
    ((1, 4, 2, 16, 16, 16, 16), {"softcap": 3.0}),
    ((1, 4, 2, 12, 12, 16, 16), {"window": 4, "softcap": 2.0}),
    ((1, 14, 2, 9, 20, 8, 8), {}),
    ((1, 7, 1, 10, 24, 8, 8), {"causal": False}),
    ((1, 2, 1, 8, 8, 192, 128), {}),
]


@pytest.mark.parametrize("rows", [None, 1])
@pytest.mark.parametrize("shape,kw", GRAD_CASES)
def test_flash_op_gradient_matches_attention_ref(shape, kw, rows,
                                                 monkeypatch):
    """``rows=1`` runs the backward one query row a chunk (each chunk
    then sees its own key range)."""
    if rows is not None:
        monkeypatch.setattr(fbw, "CHUNK_ELEMENTS", rows)
    q, k, v = _qkv(*shape)
    do = _rand(*shape[:2], shape[3], shape[6], seed=9)
    got = torch.autograd.grad(flash_attention_op(q, k, v, **kw), (q, k, v),
                              do)
    want = torch.autograd.grad(attention_ref(q, k, v, **kw), (q, k, v), do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert scaled_err(g.numpy(), w.numpy()) <= TOL


@pytest.mark.parametrize("kw", [{}, {"window": 5}, {"softcap": 20.0},
                                {"causal": False}])
def test_attention_core_gradient_matches_jax(kw):
    """The port's ``attention_core`` (the flash op) against ``jax.grad``
    of JAX's (``jnp`` attention chunked over queries) on the same arrays:
    q [B,S,H,hd], k, v [B,S,K,hd]."""
    B, S, H, K, hd = 2, 16, 4, 2, 8
    q, k, v = (_rand(B, S, n, hd, seed=i).numpy() for i, n in
               enumerate((H, K, K)))
    do = _rand(B, S, H, hd, seed=7).numpy()
    opts = dict(window=kw.get("window"), softcap=kw.get("softcap"),
                scale=0.3, causal=kw.get("causal", True))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention_core(
        a, b, c, pos, pos, q_chunk=4, **opts), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(attn.attention_core(*ts, **opts), ts,
                              torch.from_numpy(do))
    for g, w in zip(got, want):
        assert scaled_err(g.numpy(), np.asarray(w)) <= TOL


def test_flash_backward_refuses_rows_that_see_no_key():
    q, k, v = _qkv(1, 2, 2, 8, 4, 8, 8)
    o = flash_attention_op(q, k, v)
    with pytest.raises(ValueError, match="see no key"):
        o.sum().backward()


def test_flash_op_records_autograd_only_where_asked():
    q, k, v = _qkv(1, 2, 2, 4, 4, 8, 8)
    assert type(flash_attention_op(q, k, v).grad_fn).__name__ == \
        "FlashAttentionFnBackward"
    with torch.no_grad():
        assert flash_attention_op(q, k, v).grad_fn is None
    q, k, v = (t.detach() for t in (q, k, v))
    assert flash_attention_op(q, k, v).grad_fn is None


# -- train_loss and its gradient -------------------------------------------------

TRAIN_ARCHS = ["qwen3-4b", "gemma2-27b", "deepseek-v3-671b",
               "seamless-m4t-large-v2", "llava-next-34b", "chatglm3-6b",
               "mistral-nemo-12b", "deepseek-v2-236b"]
#: The archs with recurrent mixers (xlstm's has no attention, so the
#: flash op's launch test leaves them out).
RECURRENT_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b"]


def _setup(arch, seed=0, **replace):
    jcfg = dataclasses.replace(jax_configs.get_arch(arch).smoke(), **replace)
    cfg = torch_model_config(jcfg)
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, params_from_jax(np_tree(jp), cfg, device="cpu")


def _batch(cfg, B=2, S=32, seed=0):
    """A batch from the port's pipeline (the JAX pipeline's bits)."""
    pipe = make_pipeline(data_config(cfg, B, S, seed=seed))
    try:
        return next(pipe)
    finally:
        pipe.close()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(params, cfg, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.train_loss(params, cfg, batch_to_device(cfg, batch, CPU))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _leaf_errs(got, want_tree):
    """(path, ||got - want|| / ||want||) of every leaf (the error alone
    where the JAX gradient is zero)."""
    out = []
    for (path, want), g in zip(tree_paths(want_tree), got):
        n = float(want.norm())
        e = float((g - want).norm())
        out.append((path, e / n if n > 0 else e))
    return out


@pytest.mark.parametrize("arch", TRAIN_ARCHS + RECURRENT_ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    jcfg, cfg, jp, p = _setup(arch)
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: JT.train_loss(q, jcfg, _jbatch(batch))))(jp)
    loss, grads = _grads(p, cfg, batch)
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    want = params_from_jax(np_tree(jg), cfg, device="cpu")
    errs = _leaf_errs(grads, want)
    assert len(errs) == len(tree_leaves(p))
    worst = max(errs, key=lambda e: e[1])
    assert worst[1] <= LEAF_TOL, worst


def test_chunked_xent_matches_jax_over_chunks():
    """gemma2's final softcap, 4 chunks of 8 positions, with weights; the
    gradient with respect to x and the table too."""
    jcfg, cfg, jp, p = _setup("gemma2-27b")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    t = rng.integers(0, cfg.vocab, (2, 32))
    w = (rng.random((2, 32)) > 0.3).astype(np.float32)

    def jf(xx, table):
        return JT.chunked_xent({"embed_vd": table}, jcfg, xx, jnp.asarray(t),
                               jnp.asarray(w), chunk=8)
    jl, (jgx, jgt) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jp["embed_vd"])
    xt = torch.from_numpy(x).requires_grad_(True)
    table = p["embed_vd"].detach().clone().requires_grad_(True)
    loss = T.chunked_xent({"embed_vd": table}, cfg, xt,
                          torch.from_numpy(t), torch.from_numpy(w), chunk=8)
    gx, gt = torch.autograd.grad(loss, (xt, table))
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    assert scaled_err(gx.numpy(), np.asarray(jgx)) <= TOL
    assert scaled_err(gt.numpy(), np.asarray(jgt)) <= TOL
    with pytest.raises(ValueError, match="multiple"):
        T.chunked_xent({"embed_vd": table}, cfg, xt[:, :30],
                       torch.from_numpy(t[:, :30]),
                       torch.from_numpy(w[:, :30]), chunk=8)


def test_update_router_bias_matches_jax():
    jcfg, cfg, jp, p = _setup("deepseek-v3-671b")
    rng = np.random.default_rng(4)
    bias = rng.standard_normal(cfg.moe.num_experts).astype(np.float32)
    idx = rng.integers(0, cfg.moe.num_experts, (2, 16, cfg.moe.top_k))
    # Expert 0 at exactly its target load: the sign is 0 and it stays.
    idx[0, :, 0] = np.arange(16) % cfg.moe.num_experts
    want = jmoe.update_router_bias({"router_bias_e": jnp.asarray(bias)},
                                   jcfg.moe, jnp.asarray(idx))
    got = moe.update_router_bias({"router_bias_e": torch.from_numpy(bias)},
                                 cfg.moe, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_aux_carries_the_router_gradient_as_jax():
    jcfg, cfg, jp, p = _setup("deepseek-v3-671b")
    x = _rand(2, 8, cfg.d_model, seed=5).numpy()
    jffn = jax.tree.map(lambda a: a[0], jp["blocks"]["p0"]["ffn"])
    jg = jax.grad(lambda r: jmoe._route({**jffn, "router_de": r}, jcfg.moe,
                                        jnp.asarray(x))[2])(
        jffn["router_de"])
    ffn = p["blocks"][0]["ffn"]
    router = ffn["router_de"].detach().clone().requires_grad_(True)
    aux = moe._route({"router_de": router,
                      "router_bias_e": ffn["router_bias_e"]}, cfg.moe,
                     torch.from_numpy(x))[2]
    (g,) = torch.autograd.grad(aux, router)
    assert float(np.abs(np.asarray(jg)).max()) > 0
    assert scaled_err(g.numpy(), np.asarray(jg)) <= TOL


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_archs_refuse_training(arch):
    """Once refused, the recurrent archs now train: ``train_loss`` and a
    ``build_train_step`` step on the arch's ``smoke()`` give a finite
    loss.  What is refused is a layer kind the model does not know: a copy
    with an unknown mixer raises ``NotImplementedError`` from both."""
    cfg = configs.get_arch(arch).smoke()
    p = T.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg, S=16)
    with torch.no_grad():
        loss = T.train_loss(p, cfg, batch_to_device(cfg, batch, CPU))
    assert loss.shape == () and torch.isfinite(loss)
    state, m = build_train_step(cfg, device="cpu")(
        init_train_state(cfg, device="cpu"), batch)
    assert int(state["step"]) == 1 and math.isfinite(float(m["loss"]))
    bad = dataclasses.replace(cfg, pattern=(
        dataclasses.replace(cfg.pattern[0], mixer="s4"),) + cfg.pattern[1:])
    with pytest.raises(NotImplementedError, match="'s4'"):
        T.train_loss(p, bad, batch_to_device(cfg, batch, CPU))
    with pytest.raises(NotImplementedError, match="'s4'"):
        build_train_step(bad, device="cpu")


@pytest.mark.parametrize("arch,want", [
    ("qwen3-4b", 72), ("gemma2-27b", 92), ("chatglm3-6b", 56),
    ("deepseek-v3-671b", 123), ("seamless-m4t-large-v2", 144),
    ("llava-next-34b", 120), ("recurrentgemma-9b", 24), ("xlstm-1.3b", 0)])
def test_train_flash_launches_of_the_full_configs(arch, want):
    """Two a recomputed attention (forward and recompute): qwen3-4b's 36
    layers 72; deepseek-v3's 61 and its MTP block, which is not
    recomputed, 123; seamless's 24 encoder layers, 24 decoder layers and
    their 24 cross blocks, 144; recurrentgemma's 12 local-attention
    layers 24 (its 3-layer pattern has no per-layer recompute); xlstm
    none."""
    assert T.train_flash_launches(configs.get_arch(arch).full()) == want


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_flash_calls_under_recompute(arch, monkeypatch):
    """The flash op's forward runs ``train_flash_launches(cfg)`` times in
    one ``train_loss`` forward and backward: each super-block's attention
    twice, the MTP block once."""
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return attention_ref(*args, **kw)
    monkeypatch.setattr(fops, "_forward", counting)
    cfg = configs.get_arch(arch).smoke()
    p = T.init_params(torch.Generator().manual_seed(0), cfg)
    _grads(p, cfg, _batch(cfg, S=16))
    assert len(calls) == T.train_flash_launches(cfg) > 0


# (pattern of mixers, the flash launches of each super-block's layers):
# a pattern of 4 or more layers recomputes each layer a second time, but
# the super-block's recompute stops at its last layer's input.
INNER_REMAT_PATTERNS = [
    (("gqa", "gqa", "gqa", "gqa"), (3, 3, 3, 2)),
    (("gqa", "none", "none", "none"), (3, 0, 0, 0)),
    (("none", "gqa", "none", "none", "gqa"), (0, 3, 0, 0, 2)),
    (("gqa", "none", "gqa"), (2, 0, 2)),
]


@pytest.mark.parametrize("pattern,runs", INNER_REMAT_PATTERNS)
def test_flash_calls_under_the_per_layer_recompute(pattern, runs,
                                                   monkeypatch):
    """qwen3-4b ``smoke()`` with its pattern replaced, 2 super-blocks:
    the flash op's forward runs ``train_flash_launches(cfg)`` times, the
    sum of ``runs`` over the super-blocks."""
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return attention_ref(*args, **kw)
    monkeypatch.setattr(fops, "_forward", counting)
    cfg = dataclasses.replace(
        configs.get_arch("qwen3-4b").smoke(), num_superblocks=2,
        pattern=tuple(T.LayerSpec(m, "dense") for m in pattern))
    p = T.init_params(torch.Generator().manual_seed(0), cfg)
    _grads(p, cfg, _batch(cfg, S=16))
    assert len(calls) == T.train_flash_launches(cfg) == 2 * sum(runs)


def test_per_layer_recompute_matches_jax(monkeypatch):
    """xlstm-1.3b ``smoke()`` with a 4-layer pattern (3 mLSTM and an
    sLSTM, replaced on both sides), so both run the per-layer recompute
    (JAX's ``inner_remat``): the loss and every leaf's gradient against
    ``jax.value_and_grad``.  In one forward and backward each mLSTM layer
    runs 3 times (forward, the super-block's recompute, its own) and the
    pattern's last layer, the sLSTM, twice."""
    pattern = (("mlstm", "none"),) * 3 + (("slstm", "none"),)
    jcfg, cfg, jp, p = _setup("xlstm-1.3b", pattern=tuple(
        JLayerSpec(*s) for s in pattern))
    assert len(cfg.pattern) >= T.INNER_REMAT_LAYERS
    runs = {"mlstm": 0, "slstm": 0}
    for name in runs:
        fwd = getattr(T.rec, f"{name}_forward")

        def counted(*a, name=name, fwd=fwd, **kw):
            runs[name] += 1
            return fwd(*a, **kw)
        monkeypatch.setattr(T.rec, f"{name}_forward", counted)
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: JT.train_loss(q, jcfg, _jbatch(batch))))(jp)
    loss, grads = _grads(p, cfg, batch)
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    errs = _leaf_errs(grads, params_from_jax(np_tree(jg), cfg, device="cpu"))
    worst = max(errs, key=lambda e: e[1])
    assert worst[1] <= LEAF_TOL, worst
    assert runs == {"mlstm": 3 * 3 * cfg.num_superblocks,
                    "slstm": 2 * cfg.num_superblocks}


# -- the train step --------------------------------------------------------------

# (optimizer, microbatches, superblocks): JAX's Adafactor factors a stacked
# vector leaf across its super-blocks, the port's per layer (ROADMAP,
# "Differences by design"), so its cases keep one super-block.
STEP_CASES = [("adamw", 1, None), ("adamw", 2, None), ("adafactor", 1, 1),
              ("adafactor", 2, 1)]


@pytest.mark.parametrize("optimizer,microbatches,superblocks", STEP_CASES)
def test_train_step_matches_jax(optimizer, microbatches, superblocks):
    """Two steps of qwen3-4b ``smoke()`` from the same params and
    optimizer state: each loss within 1e-5 relative; after them each
    param leaf within 1e-3 of the norm of its update over the two steps,
    and each moment leaf within 1e-5 of its norm (1e-3 under bf16
    accumulation).  The param gate is looser
    than the gradients' 1e-4: the normalised update turns a gradient
    element's relative error into an error of the same size in its step
    (an element near zero has a large one), and Adafactor's bf16
    accumulation rounds a gradient that differs in its 7th digit to a
    neighbouring bf16 value now and then (measured: 1.4e-4 at most)."""
    _two_steps_against_jax("qwen3-4b", optimizer, microbatches, superblocks)


@pytest.mark.parametrize("arch,optimizer,superblocks,tols", [
    ("recurrentgemma-9b", "adafactor", 1, {}),
    ("xlstm-1.3b", "adamw", None,
     {"param_tol": 5e-3, "moment_tol": LEAF_TOL})])
def test_recurrent_train_step_matches_jax(arch, optimizer, superblocks,
                                          tols):
    """Two steps of the recurrent archs' ``smoke()`` against JAX's
    ``build_train_step`` under the gates of ``test_train_step_matches_jax``:
    recurrentgemma with Adafactor at one super-block (and its extra
    layer), xlstm with AdamW over its two super-blocks.  xlstm's params
    are held within 5e-3 of their update's norm: its sLSTM gradients have
    elements near 4e-7 whose fp32 rounding through the exponential gates
    differs from JAX's by half their size (the leaf agrees within 1.9e-6
    of its norm), and AdamW's normalised step turns that into an error of
    the step's size on those elements (1.3e-3 of the update's norm on
    ``wz_dd``).  Its moments, sums of the gradients and of their squares,
    are held to the gradients' gate, 1e-4 of their norms (measured 1.4e-5
    on ``mu`` of the mLSTM's ``w_if_ih``)."""
    _two_steps_against_jax(arch, optimizer, 1, superblocks, **tols)


def _two_steps_against_jax(arch, optimizer, microbatches, superblocks,
                           param_tol=1e-3, moment_tol=None):
    kw = {} if superblocks is None else {"num_superblocks": superblocks}
    acc_bf16 = optimizer == "adafactor" and microbatches > 1
    jcfg, cfg, jp, p = _setup(arch, **kw)
    before = {k: v.clone() for k, v in tree_paths(p)}
    jinit = j_adamw_init if optimizer == "adamw" else j_adafactor_init
    jstate = {"params": jp, "opt": jinit(jp),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": p, "opt": opt_state_from_jax(np_tree(jstate["opt"]),
                                                    cfg, device="cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(j_build_train_step(jcfg, None, optimizer,
                                       microbatches=microbatches))
    step = build_train_step(cfg, optimizer, microbatches=microbatches,
                            device="cpu")
    for i in range(2):
        batch = _batch(cfg, B=4, S=16, seed=i)
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, batch)
        assert set(m) == {"loss"}
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            TOL * abs(float(jm["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 2
    assert set(state["opt"]) == set(jstate["opt"])
    want = dict(tree_paths(params_from_jax(np_tree(jstate["params"]), cfg,
                                           device="cpu")))
    for path, got in tree_paths(state["params"]):
        err = float((got.detach() - want[path]).norm())
        moved = float((want[path] - before[path]).norm())
        assert moved > 0 and err <= param_tol * moved, (path, err, moved)
    want_opt = dict(tree_paths(opt_state_from_jax(np_tree(jstate["opt"]),
                                                  cfg, device="cpu")))
    assert int(state["opt"]["count"]) == 2
    # Adafactor accumulates microbatch gradients in bf16: a rounding that
    # flips to a neighbouring bf16 value moves g² by 2^-7 (measured 1.2e-4
    # of a leaf's norm at most); in fp32 the moments agree within 1.3e-6.
    if moment_tol is None:
        moment_tol = 1e-3 if acc_bf16 else 1e-5
    for path, got in tree_paths({k: v for k, v in state["opt"].items()
                                 if k != "count"}):
        w = want_opt[path]
        assert float((got - w).norm()) <= moment_tol * float(w.norm()), path


def test_opt_state_from_jax_refuses_a_state_factored_across_superblocks():
    """JAX's Adafactor state of a stacked norm scale [2, D] is vr [2], vc
    [D]: no per-layer state of the port's holds it."""
    jcfg, cfg, jp, p = _setup("qwen3-4b")
    jopt = j_adafactor_init(jp)
    assert jopt["v"]["blocks"]["p0"]["ln_mixer"]["scale"]["vr"].shape == (2,)
    with pytest.raises(ValueError, match="across"):
        opt_state_from_jax(np_tree(jopt), cfg, device="cpu")
    # AdamW's moments unstack as the params do.
    got = opt_state_from_jax(np_tree(j_adamw_init(jp)), cfg, device="cpu")
    shapes = dict(tree_paths(got["mu"]))
    assert {k: v.shape for k, v in tree_paths(p)} == {
        k: v.shape for k, v in shapes.items()}
    assert got["count"].dtype == torch.int32


def test_init_train_state():
    cfg = configs.get_arch("qwen3-4b").smoke()
    state = init_train_state(cfg, "adafactor", device="cpu")
    assert set(state) == {"params", "opt", "step"}
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    assert set(state["opt"]) == {"v", "count"}
    with pytest.raises(ValueError, match="optimizer"):
        init_train_state(cfg, "sgd", device="cpu")


def test_training_reduces_loss():
    """``tests/test_system.py``'s case: smoke config, 30 AdamW steps at lr
    3e-3 on one fixed batch."""
    cfg = configs.get_arch("qwen3-4b").smoke()
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=3e-3)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             "weights": np.ones(toks.shape, np.float32)}
    losses = []
    for _ in range(30):
        loss, g = _grads(params, cfg, batch)
        it = iter(g)
        grads = T.layers.tree_map(lambda _: next(it), params)
        params, new = adamw_update(params, grads, opt, ocfg)
        opt = {k: new[k] for k in ("mu", "nu", "count")}
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses[::10]


def test_checkpoint_restart_bitexact(tmp_path):
    """``tests/test_system.py``'s case: chatglm3-6b ``smoke()``, 6 steps
    straight against 3 steps, a save and a restore into a fresh state, and
    3 more (within 1e-6; equal in practice)."""
    cfg = configs.get_arch("chatglm3-6b").smoke()
    data = np.random.default_rng(2).integers(0, cfg.vocab, (6, 2, 16))
    step = build_train_step(cfg, device="cpu")

    def run(state, i):
        toks = data[i]
        return step(state, {"tokens": toks,
                            "targets": np.roll(toks, -1, 1),
                            "weights": np.ones(toks.shape, np.float32)})[0]

    def init():
        return init_train_state(cfg, device="cpu")

    s = init()
    for i in range(6):
        s = run(s, i)
    straight = s
    s = init()
    for i in range(3):
        s = run(s, i)
    save_checkpoint(str(tmp_path), 3, s)
    s, _ = load_checkpoint(str(tmp_path), init())
    for i in range(3, 6):
        s = run(s, i)
    for a, b in zip(tree_leaves(straight["params"]),
                    tree_leaves(s["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)


def test_trainer_resumes_to_the_uninterrupted_run(tmp_path):
    """6 steps, saves every 2, killed after step 3 and resumed under
    ``run_with_restarts`` from step 2 with the stream at batch 2: the
    params equal an uninterrupted run's bit for bit."""
    cfg = configs.get_arch("qwen3-4b").smoke()
    step_fn = build_train_step(cfg, device="cpu")

    def train(ckpt, fail_at):
        return train_with_restarts(
            step_fn, lambda: init_train_state(cfg, device="cpu"),
            data_config(cfg, 2, 16),
            TrainerConfig(total_steps=6, ckpt_dir=ckpt, save_interval=2),
            FailureInjector(fail_at))

    straight, straight_state = train(str(tmp_path / "a"), None)
    resumed, resumed_state = train(str(tmp_path / "b"), [3])
    assert len(straight) == 1 and len(resumed) == 2
    assert int(resumed_state["step"]) == 6
    assert [m["step"] for m in resumed[1].metrics_history] == [3, 4, 5, 6]
    assert resumed[1].metrics_history[-1] == \
        straight[0].metrics_history[-1]
    for a, b in zip(tree_leaves(straight_state["params"]),
                    tree_leaves(resumed_state["params"])):
        assert torch.equal(a, b)


def test_train_cli_in_a_subprocess(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU, killed after
    step 2 and restarted: exit 0, ``done: step=4``; ``-X importtime``
    lists every module it imported, and none is JAX's or the JAX
    package's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "repro_torch.launch.train", "--arch", "qwen3-4b", "--smoke",
         "--steps", "4", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--inject-failure-at", "2", "--ckpt", str(tmp_path / "ckpt")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("done: step=4 ")
    assert "restart 1 after: injected failure at step 2" in out.stderr
    modules = [line.rsplit("|", 1)[1].strip() for line in
               out.stderr.splitlines() if line.startswith("import time:")]
    assert {"repro_torch.launch.steps", "repro_torch.optim",
            "repro_torch.ckpt", "repro_torch.data"} <= set(modules)
    assert [m for m in modules if m.split(".")[0] in
            ("jax", "jaxlib", "repro")] == []


def test_train_cli_trains_xlstm(tmp_path):
    """``python -m repro_torch.launch.train --arch xlstm-1.3b --smoke`` on
    the CPU (mLSTM and sLSTM under autograd, the per-layer recompute off
    at the smoke's 2-layer pattern): exit 0 and a finite loss."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xlstm-1.3b", "--smoke", "--steps", "2", "--batch", "2", "--seq",
         "16", "--device", "cpu", "--ckpt", str(tmp_path / "ckpt")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("done: step=2 ")
    assert math.isfinite(float(last.rsplit("loss=", 1)[1]))
