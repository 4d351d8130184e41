"""The port's serving side on the CPU: the ServingEngine's contracts (those
of ``tests/test_serving.py``), its greedy tokens and logits against the
JAX engine's (also for chatglm3-6b's, the DeepSeek archs' and the
recurrent archs' ``smoke()``; like JAX's, the engine carries a recurrent
state from one request to the next),
the prefill step against JAX's ``build_prefill_step``, the device rule of
every entry point, and the serving CLI.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.launch.steps import build_prefill_step as j_build_prefill_step
from repro.models import LayerSpec as JLayerSpec
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init_params
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.kernels import launch_counts
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import (init_cache, init_params, params_from_jax,
                                serve_step)
from repro_torch.serving import ServeConfig, ServingEngine

from _torch_parity import np_tree, scaled_err, torch_model_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, P, V = 2, 6, 64
TOL = 1e-5

# tests/test_serving.py's model.
NEW_ARCHS = ["chatglm3-6b", "deepseek-v2-236b", "deepseek-v3-671b"]
RECURRENT_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b"]
JCFG = JModelConfig(name="t", d_model=32, vocab=V,
                    pattern=(JLayerSpec("gqa", "dense"),),
                    num_superblocks=2, num_heads=4, num_kv_heads=2,
                    head_dim=8, d_ff=64, dtype=jnp.float32,
                    param_dtype=jnp.float32, q_chunk=4)
CFG = torch_model_config(JCFG)


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(np_tree(jax_params), CFG, device="cpu")


def _prompts(seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, P),
                                                dtype=np.int32)


def _engine(params, temperature=0.0, slots=B):
    return ServingEngine(params, CFG, ServeConfig(
        batch_slots=slots, max_len=64, temperature=temperature),
        device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# -- the engine's contracts ---------------------------------------------------

def test_prefill_matches_manual_serve_step_loop(params):
    prompts = _prompts()
    logits, pos = _engine(params).prefill(prompts)
    assert pos == P
    cache = init_cache(CFG, B, 64, device="cpu")
    for t in range(P):
        cache, manual = serve_step(params, CFG, cache,
                                   torch.from_numpy(prompts[:, t:t + 1]), t)
    assert torch.equal(logits, manual)


def test_generate_shape_and_token_range(params):
    out = _engine(params).generate(_prompts(), max_new=5)
    assert out.shape == (B, 5) and out.dtype == np.int32
    assert np.all((out >= 0) & (out < V))


def test_greedy_is_generator_independent(params):
    prompts = _prompts()
    a = _engine(params).generate(prompts, max_new=8)
    b = _engine(params).generate(prompts, max_new=8, gen=_gen(123))
    c = _engine(params).generate(prompts, max_new=8, gen=_gen(999))
    assert np.array_equal(a, b) and np.array_equal(b, c)


def test_greedy_first_token_is_argmax_of_prefill_logits(params):
    prompts = _prompts()
    logits, _ = _engine(params).prefill(prompts)
    out = _engine(params).generate(prompts, max_new=1)
    assert np.array_equal(out[:, 0], torch.argmax(logits, -1).numpy())


def test_temperature_sampling_deterministic_per_seed(params):
    prompts = _prompts()
    a = _engine(params, 1.0).generate(prompts, max_new=8, gen=_gen(42))
    b = _engine(params, 1.0).generate(prompts, max_new=8, gen=_gen(42))
    assert np.array_equal(a, b)
    greedy = _engine(params).generate(prompts, max_new=8)
    nogen = _engine(params, 1.0).generate(prompts, max_new=8)
    assert np.array_equal(nogen, greedy)


def test_hot_temperature_diverges_from_greedy(params):
    prompts = _prompts()
    greedy = _engine(params).generate(prompts, max_new=16)
    hot = _engine(params, 5.0).generate(prompts, max_new=16, gen=_gen(7))
    assert not np.array_equal(hot, greedy)


def test_slot_reuse_across_requests(params):
    eng = _engine(params)
    prompts = _prompts()
    assert np.array_equal(eng.generate(prompts, max_new=8),
                          eng.generate(prompts, max_new=8))
    other = _prompts(seed=3)
    assert np.array_equal(eng.generate(other, max_new=8),
                          _engine(params).generate(other, max_new=8))


# -- against the JAX engine ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_greedy_tokens_and_logits_match_jax(jax_params, params, seed):
    """The same greedy continuation as the JAX engine: the logits along
    JAX's tokens agree within TOL of their scale at every step, and the
    tokens are equal wherever JAX's top-2 margin exceeds that."""
    prompts = _prompts(seed)
    new = 12
    want = JServingEngine(jax_params, JCFG, JServeConfig(
        batch_slots=B, max_len=64)).generate(prompts, max_new=new)
    got = _engine(params).generate(prompts, max_new=new)
    seq = np.concatenate([prompts, want], axis=1)
    jeng = JServingEngine(jax_params, JCFG, JServeConfig(batch_slots=B,
                                                         max_len=64))
    eng = _engine(params)
    margins = []
    for t in range(seq.shape[1] - 1):
        jeng.cache, jl = jeng._step(jax_params, jeng.cache,
                                    jnp.asarray(seq[:, t:t + 1]),
                                    jnp.int32(t))
        pl = eng._step(torch.from_numpy(seq[:, t:t + 1]).long(), t)
        scale = max(1.0, float(jnp.max(jnp.abs(jl))))
        assert scaled_err(pl, jl) <= TOL, t
        top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]) / scale)
    margins = np.stack(margins[P - 1:], axis=1)        # [B, new]
    sure = margins > TOL
    assert sure.mean() > 0.5
    assert np.array_equal(got[sure], want[sure])


@pytest.mark.parametrize("arch", NEW_ARCHS + RECURRENT_ARCHS)
def test_smoke_arch_greedy_tokens_match_jax(arch):
    """The engine's greedy continuation of an arch's smoke() (MLA + MoE
    for DeepSeek) equals the JAX engine's, with JAX's weights."""
    jcfg = jax_configs.get_arch(arch).smoke()
    cfg = torch_model_config(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(np_tree(jp), cfg, device="cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (B, P),
                                                dtype=np.int32)
    want = JServingEngine(jp, jcfg, JServeConfig(
        batch_slots=B, max_len=32)).generate(prompts, max_new=8)
    got = ServingEngine(p, cfg, ServeConfig(batch_slots=B, max_len=32),
                        device="cpu").generate(prompts, max_new=8)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", ["gqa", "gqa_window", "qwen3-4b",
                                  "gemma2-27b", "mistral-nemo-12b",
                                  *NEW_ARCHS, *RECURRENT_ARCHS])
def test_prefill_step_matches_jax(name):
    if name.startswith("gqa"):
        window = 4 if name == "gqa_window" else None
        jcfg = JModelConfig(**{**JCFG.__dict__, "pattern": (
            JLayerSpec("gqa", "dense", window=window),)})
    else:
        jcfg = jax_configs.get_arch(name).smoke()
    cfg = torch_model_config(jcfg)
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    p = params_from_jax(np_tree(jp), cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (3, 16))
    want = j_build_prefill_step(jcfg, None)(jp, {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(cfg, device="cpu")(p, {"tokens": toks})
    assert got.shape == (3, cfg.vocab) and got.dtype == torch.float32
    assert scaled_err(got, want) <= TOL


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_engine_carries_recurrent_state_across_requests_as_jax(arch):
    """Neither engine resets its cache between requests.  A recurrent
    state carries over, so a second prefill of the same prompts on one
    engine gives other logits than the first; the port's equal JAX's
    for both calls (ROADMAP reference caveat 6)."""
    jcfg = jax_configs.get_arch(arch).smoke()
    cfg = torch_model_config(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(np_tree(jp), cfg, device="cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (B, 8),
                                                dtype=np.int32)
    jeng = JServingEngine(jp, jcfg, JServeConfig(batch_slots=B, max_len=32))
    eng = ServingEngine(p, cfg, ServeConfig(batch_slots=B, max_len=32),
                        device="cpu")
    firsts = []
    for _ in range(2):
        want, _ = jeng.prefill(prompts)
        got, _ = eng.prefill(prompts)
        assert scaled_err(got, want) <= TOL
        firsts.append(got)
    assert scaled_err(firsts[1], firsts[0].numpy()) > 1e-3


def test_build_serve_step_is_serve_step(params):
    step = build_serve_step(CFG, device="cpu")
    toks = _prompts()
    a = init_cache(CFG, B, 8, device="cpu")
    b = init_cache(CFG, B, 8, device="cpu")
    for t in range(3):
        a, la = step(params, a, toks[:, t:t + 1], t)
        b, lb = serve_step(params, CFG, b,
                           torch.from_numpy(toks[:, t:t + 1]).long(), t)
        assert torch.equal(la, lb)


# -- the device rule ----------------------------------------------------------

def test_entry_points_need_a_card_unless_asked_for_the_cpu(params,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ServingEngine(params, CFG, ServeConfig(2, 8)),
                 lambda: build_prefill_step(CFG),
                 lambda: build_serve_step(CFG),
                 lambda: init_cache(CFG, 2, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_prefill_on_cpu_launches_no_kernel(params):
    before = launch_counts()["flash_attention"]
    build_prefill_step(CFG, device="cpu")(params, {"tokens": _prompts()})
    assert launch_counts()["flash_attention"] == before


def test_engine_refuses_params_on_another_device(params):
    meta = params.to("meta")
    with pytest.raises(ValueError, match="params lie on"):
        ServingEngine(meta, CFG, ServeConfig(2, 8), device="cpu")


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-27b", *NEW_ARCHS,
                                  *RECURRENT_ARCHS])
def test_serve_cli_smoke_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill (4, 8) on cpu" in out.stdout
    assert "generated (4, 4)" in out.stdout


def test_decode_step_script_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "scripts/torch_decode_step.py", "--arch",
         "qwen3-4b", "--smoke", "--device", "cpu", "--rounds", "2",
         "--prompt-len", "4", "--max-new", "4", "--label", "t"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.splitlines()[-1])
    assert row["label"] == "t" and row["device"] == "cpu"
    assert len(row["step_wall_ms"]) == 2
    assert row["step_aten_ops"] > 0


def test_decode_step_script_cuts_depth_on_cpu():
    """``--superblocks`` keeps that many super-blocks (how a MoE arch's
    decode step is timed on one card)."""
    from repro_torch.configs import get_arch

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "scripts/torch_decode_step.py", "--arch",
         "deepseek-v2-236b", "--smoke", "--superblocks", "1", "--device",
         "cpu", "--rounds", "1", "--prompt-len", "4", "--max-new", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.splitlines()[-1])
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b").smoke(),
                              num_superblocks=1)
    assert row["layers"] == cfg.num_layers
    assert cfg.num_layers < get_arch("deepseek-v2-236b").smoke().num_layers
    assert row["step_aten_ops"] > 0
