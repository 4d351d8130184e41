"""The port's mesh steps on 8 gloo ranks of the CPU, a (2, 2, 2)
('pod', 'data', 'model') mesh, against the JAX package's no-mesh steps
(fp32) on the same numpy weights, state and batches.

- Two ``build_train_step(mesh=)`` steps: qwen3-4b ``smoke()`` with AdamW
  and 2 microbatches (its second batch weighs its rows differently, so
  the batch slices' weight sums differ), and deepseek-v2-236b ``smoke()``
  (MoE, MLA) with Adafactor at one super-block (JAX's Adafactor factors
  a stacked vector across super-blocks; ROADMAP, differences by design).
  Each loss within 1e-5 relative of JAX's; every param and moment leaf
  within 1e-5 (absolute) of the port's one-device steps from the same
  state and batches; each moment within 1e-5 of its norm of JAX's, and
  each param within 1e-3 of the norm of JAX's update over the two steps
  (``test_torch_train``'s ``test_train_step_matches_jax`` gate; 2e-3 for
  qwen3-4b, ``PARAM_TOL``: AdamW's normalised step turns a gradient
  element's fp32 rounding into an error of its own size, so after these
  two steps the port's one-device params are 5.8e-5 (absolute) from
  JAX's on qwen3-4b's ``wo_fd``, the mesh's 5.0e-5); every rank's local
  block of the shape its spec gives.
- The prefill step and 4 decode steps of qwen3-4b ``smoke()`` through
  ``mesh=``: batch 4 (split over 'pod' × 'data', the K/V cache's heads
  over 'model', gathered at use) and batch 1 (the tokens whole, the
  cache's sequence over 'data'), each logit within 1e-5 of its scale of
  JAX's ``build_prefill_step`` / ``serve_step``.
- ``python -m repro_torch.launch.train --smoke --device cpu`` under
  ``torch.distributed.run --nproc_per_node 2``, killed after step 2 and
  resumed through the sharded checkpoint, ends on the loss of a
  one-process run within 1e-5.

Every multi-rank run is a subprocess with a timeout of its own
(``_torch_parity.run_ranks``).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.launch.steps import build_prefill_step as j_build_prefill_step
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import serve_step as j_serve_step
from repro.optim import adafactor_init as j_adafactor_init
from repro.optim import adamw_init as j_adamw_init
from repro_torch.data import make_pipeline
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import data_config
from repro_torch.models import opt_state_from_jax, params_from_jax
from repro_torch.models.layers import ParamTree, tree_map, tree_paths

from _torch_parity import np_tree, run_ranks, scaled_err, torch_model_config

TOL = 1e-5
#: Each param leaf's distance from JAX's after two steps, over the norm of
#: JAX's update over them: ``test_torch_train``'s 1e-3, and 2e-3 for
#: qwen3-4b, whose ``wo_fd`` has one element whose first gradient is at
#: fp32 rounding level, so that its normalised first step differs from
#: JAX's by a third (5.8e-5 absolute, the rest of the leaf within 1.4e-7):
#: the one-device port lands at 1.38e-3 of that leaf's update on these
#: batches, the mesh at 1.17e-3.  A leaf that JAX leaves unmoved (the
#: router bias) must equal it.
PARAM_TOL = {"qwen3-4b": 2e-3, "deepseek-v2-236b": 1e-3}
MESH = (2, 2, 2)
ROOT = Path(__file__).resolve().parent.parent


def _batch(cfg, B, S, seed):
    pipe = make_pipeline(data_config(cfg, B, S, seed=seed))
    try:
        return next(pipe)
    finally:
        pipe.close()


def _weighted(batch):
    """The batch with each row weighed differently (row 0 not at all)."""
    rows = batch["weights"].shape[0]
    w = np.linspace(0.0, 1.5, rows, dtype=np.float32)[:, None]
    return dict(batch, weights=batch["weights"] * w)


# (arch, optimizer, microbatches, config overrides)
TRAIN_CASES = [("qwen3-4b", "adamw", 2, {}),
               ("deepseek-v2-236b", "adafactor", 1, {"num_superblocks": 1})]


@pytest.mark.parametrize("arch,optimizer,microbatches,replace", TRAIN_CASES)
def test_mesh_train_steps_match_jax(arch, optimizer, microbatches, replace,
                                    tmp_path):
    jcfg = dataclasses.replace(jax_configs.get_arch(arch).smoke(), **replace)
    cfg = torch_model_config(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    jinit = j_adamw_init if optimizer == "adamw" else j_adafactor_init
    jstate = {"params": jp, "opt": jinit(jp),
              "step": jnp.zeros((), jnp.int32)}
    params = tree_map(lambda t: t, params_from_jax(np_tree(jp), cfg,
                                                   device="cpu"))
    before = {k: v.clone() for k, v in tree_paths(params)}
    opt = opt_state_from_jax(np_tree(jstate["opt"]), cfg, device="cpu")
    batches = [_batch(cfg, 8, 16, 0), _weighted(_batch(cfg, 8, 16, 1))]
    out = run_ranks("train", 8, tmp_path, {
        "cfg": cfg, "optimizer": optimizer, "microbatches": microbatches,
        "mesh": MESH, "params": params, "opt": opt, "batches": batches})
    assert out["bad_shapes"] == []
    assert out["step"] == 2
    # The port's one-device steps from the same state and batches.
    state = {"params": ParamTree(params), "opt": opt,
             "step": torch.zeros((), dtype=torch.int32)}
    step = build_train_step(cfg, optimizer, microbatches, device="cpu")
    jstep = jax.jit(j_build_train_step(jcfg, None, optimizer,
                                       microbatches=microbatches))
    for batch, loss in zip(batches, out["losses"]):
        state, _ = step(state, batch)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        assert abs(loss - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    got = dict(tree_paths(out["state"]))
    one = dict(tree_paths({"params": state["params"], "opt": state["opt"]}))
    assert int(got.pop("['opt']['count']")) == int(
        one.pop("['opt']['count']")) == 2
    assert set(got) == set(one)
    worst = max((float((got[k] - w).detach().abs().max()), k)
                for k, w in one.items())
    assert worst[0] <= TOL, worst
    want = dict(tree_paths(opt_state_from_jax(np_tree(jstate["opt"]), cfg,
                                              device="cpu")))
    want.pop("['count']")
    for path, w in want.items():
        err = float((got["['opt']" + path] - w).norm())
        assert err <= TOL * float(w.norm()), (path, err)
    want = dict(tree_paths(params_from_jax(np_tree(jstate["params"]), cfg,
                                           device="cpu")))
    ratios = {}
    for path, w in want.items():
        err = float((got["['params']" + path] - w).detach().norm())
        moved = float((w - before[path]).norm())
        ratios[path] = err / moved if moved else (0.0 if err == 0 else err)
    worst = max((r, k) for k, r in ratios.items())
    assert worst[0] <= PARAM_TOL[arch], worst


def test_mesh_prefill_and_decode_match_jax(tmp_path):
    jcfg = jax_configs.get_arch("qwen3-4b").smoke()
    cfg = torch_model_config(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = tree_map(lambda t: t, params_from_jax(np_tree(jp), cfg,
                                                   device="cpu"))
    rng = np.random.default_rng(0)
    cases, steps = [], 4
    for B in (4, 1):
        cases.append({"prefill": torch.from_numpy(rng.integers(
                          0, cfg.vocab, (B, 8), dtype=np.int64)),
                      "decode": torch.from_numpy(rng.integers(
                          0, cfg.vocab, (B, steps), dtype=np.int64)),
                      "max_len": 16})
    out = run_ranks("serve", 8, tmp_path, {"cfg": cfg, "mesh": MESH,
                                           "params": params,
                                           "cases": cases})
    prefill = jax.jit(j_build_prefill_step(jcfg))
    decode = jax.jit(lambda p, c, t, pos: j_serve_step(p, jcfg, c, t, pos))
    for case, got in zip(cases, out):
        want = prefill(jp, {"tokens": jnp.asarray(case["prefill"].numpy(),
                                                  jnp.int32)})
        assert scaled_err(got["prefill"].numpy(), want) <= TOL
        B = case["decode"].shape[0]
        cache = j_init_cache(jcfg, B, case["max_len"])
        for t in range(steps):
            cache, want = decode(jp, cache, jnp.asarray(
                case["decode"][:, t:t + 1].numpy(), jnp.int32), t)
            assert scaled_err(got["decode"][t].numpy(), want) <= TOL, (B, t)
    # Batch 4 splits over 'pod' × 'data' and the K/V heads over 'model';
    # batch 1 keeps the batch whole and splits the sequence over 'data'.
    assert out[0]["placements"]["k"] == ["Shard(dim=0)", "Shard(dim=0)",
                                         "Shard(dim=2)"]
    assert out[1]["placements"]["k"] == ["Replicate()", "Shard(dim=1)",
                                         "Shard(dim=2)"]


def _train_cli(args, env, nproc=None):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-4b", "--smoke", "--steps", "4", "--batch", "4", "--seq",
           "32", "--device", "cpu", "--save-interval", "1"] + args
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc)] + cmd[1:]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    last = res.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"done: step=(\d+) loss=(\S+)", last)
    assert m, last
    return int(m.group(1)), float(m.group(2))


def test_train_cli_two_ranks_with_restart(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    step1, one = _train_cli(["--ckpt", str(tmp_path / "one")], env)
    step2, two = _train_cli(["--ckpt", str(tmp_path / "two"),
                             "--inject-failure-at", "2"], env, nproc=2)
    assert step1 == step2 == 4
    assert abs(two - one) <= TOL * abs(one)
    assert sorted(os.listdir(tmp_path / "two")) == ["step_2", "step_3",
                                                    "step_4"]
