"""The port's launch planning and dry run against the JAX package's:

- ``make_plan`` equals JAX's (optimizer, pod strategy, microbatches, the
  partition's device count and assignment, the pipeline depths, the
  byte figures) for every arch on ``train_4k`` at 1 and 2 pods, at the
  reference's per-chip memory;
- ``collective_bytes`` equals JAX's on the same op lists, and
  ``_is_dcn`` over a group's ranks equals JAX's over the same explicit
  replica group;
- the per-layer FLOPs that ``FlopCounterMode`` counts in a forward of 1
  and of 3 layers, differenced, are within 25% of
  ``graphs.layer_flops`` (``tests/test_roofline_crosscheck.py`` for the
  port);
- ``repro_torch.launch.dryrun.run_on_mesh`` of qwen3-4b ``smoke()`` on
  ``train_4k`` over a fake (2, 2, 2) mesh and a fake (4, 2) one (each a
  subprocess with a timeout, since the fake process group is the
  process's default group): an ``ok`` record whose argument bytes are
  the sum of the local shards' bytes (state and batch), with all-gathers
  and reduce-scatters among its collectives, and collective bytes across
  pods (DCN) above 0 on the multi-pod mesh only.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jax_configs
from repro.launch import hlo_analysis as jhlo
from repro.launch.plan import make_plan as j_make_plan
from repro_torch import configs
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.launch.graphs import layer_flops
from repro_torch.launch.plan import make_plan
from repro_torch.models import LayerSpec, init_params
from repro_torch.models import layers
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("num_pods", [1, 2])
@pytest.mark.parametrize("arch", list(configs.ALL_ARCHS))
def test_make_plan_matches_jax(arch, num_pods):
    got = make_plan(arch, configs.get_arch(arch).full(), "train_4k",
                    num_pods=num_pods)
    want = j_make_plan(arch, jax_configs.get_arch(arch).full(), "train_4k",
                       num_pods=num_pods)
    for f in ("optimizer", "pod_strategy", "microbatches", "param_bytes",
              "state_bytes_per_chip", "rationale", "pipeline_depths"):
        assert getattr(got, f) == getattr(want, f), f
    if want.partition is None:
        assert got.partition is None
    else:
        assert got.partition.num_devices() == want.partition.num_devices()
        assert got.partition.assignment == want.partition.assignment


def _ops(rng, n, line=""):
    kinds = list(jhlo.COLLECTIVE_KINDS)
    out = []
    for i in range(n):
        dtype = ("f32", "bf16", "s32")[i % 3]
        shape = tuple(int(d) for d in rng.integers(1, 64, size=2))
        out.append(dict(kind=kinds[i % len(kinds)], dtype=dtype, shape=shape,
                        bytes_per_exec=float(np.prod(shape)
                                             * jhlo.DTYPE_BYTES[dtype]),
                        while_depth=0, trip_mult=float(1 + i % 3),
                        is_dcn=bool(i % 2), line=line))
    return out


def test_collective_bytes_match_jax():
    rng = np.random.default_rng(0)
    for line in ("", "all-gather", "dot_general"):
        ops = _ops(rng, 40, line)
        assert hlo.collective_bytes([hlo.CollectiveOp(**o) for o in ops]) \
            == jhlo.collective_bytes([jhlo.CollectiveOp(**o) for o in ops])


@pytest.mark.parametrize("chips_per_pod", [4, 256])
def test_is_dcn_matches_jax(chips_per_pod):
    rng = np.random.default_rng(1)
    world = 2 * chips_per_pod
    for _ in range(50):
        size = int(rng.integers(1, 9))
        ranks = sorted(int(r) for r in rng.choice(world, size,
                                                  replace=False))
        line = "replica_groups={{" + ",".join(map(str, ranks)) + "}}"
        assert hlo._is_dcn(ranks, chips_per_pod) == \
            jhlo._is_dcn(line, chips_per_pod), ranks


def _forward_flops(cfg, batch, seq):
    """FLOPs that FlopCounterMode counts in a forward (logits of the last
    position) on the CPU."""
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((batch, seq), dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        x = T._embed_inputs(params, cfg, {"tokens": toks})
        pos = torch.arange(seq).expand(batch, seq)
        x, _ = T._run_stack(params, cfg, x, pos)
        x = layers.rmsnorm(params["final_norm"], x)
        layers.unembed(T._unembed_table(params, cfg), x[:, -1, :])
    return fc.get_total_flops()


def test_layer_flops_match_flop_counter_differencing():
    base = configs.get_arch("qwen3-4b").smoke()
    B, S = 2, 64
    cfg1 = dataclasses.replace(base, pattern=(LayerSpec("gqa", "dense"),),
                               num_superblocks=1)
    cfg3 = dataclasses.replace(base,
                               pattern=(LayerSpec("gqa", "dense"),) * 3,
                               num_superblocks=1)
    per_layer = (_forward_flops(cfg3, B, S) - _forward_flops(cfg1, B, S)) / 2
    analytic = layer_flops(cfg1, LayerSpec("gqa", "dense"), B, S)
    assert abs(per_layer - analytic) / analytic < 0.25, (per_layer,
                                                          analytic)


def _dryrun(mesh_shape, axes):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    code = ("import json, sys\n"
            "from repro_torch.configs import get_arch\n"
            "from repro_torch.launch.dryrun import run_on_mesh\n"
            "rec = run_on_mesh('qwen3-4b', get_arch('qwen3-4b').smoke(),\n"
            f"                  'train_4k', {tuple(mesh_shape)!r}, "
            f"{tuple(axes)!r})\n"
            "print(json.dumps(rec, default=float))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def _argument_bytes(rec, mesh):
    cfg = configs.get_arch("qwen3-4b").smoke()
    optimizer = rec["plan"]["optimizer"]
    shapes = steps.state_shape(cfg, optimizer)
    specs = steps.state_shardings(cfg, mesh, optimizer, shapes)
    flat = dict(sh.flat_specs({k: specs[k] for k in ("params", "opt")}))
    total = 0
    for keys, t in sh.flat_specs(torch.utils._pytree.tree_map(
            lambda t: t, {"params": shapes["params"],
                          "opt": shapes["opt"]})):
        total += math.prod(sh.local_shape(flat[keys], t.shape, mesh)) \
            * t.element_size()
    total += 4                                    # the step
    for t in configs.input_specs(cfg, "train_4k").values():
        total += t.numel() * t.element_size()
    return total


@pytest.mark.parametrize("mesh_shape,axes", [
    ((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model"))])
def test_dryrun_smoke_on_a_fake_mesh(mesh_shape, axes):
    rec = _dryrun(mesh_shape, axes)
    assert rec["ok"] is True, rec.get("error")
    assert rec["chips"] == math.prod(mesh_shape)
    mesh = dict(zip(axes, mesh_shape))
    assert rec["memory"]["argument_bytes"] == _argument_bytes(rec, mesh)
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    kinds = rec["collectives"]["by_kind"]
    assert kinds.get("all-gather", 0) > 0
    assert kinds.get("reduce-scatter", 0) > 0
    assert rec["cost_raw"]["flops"] > 0
    if "pod" in axes:
        assert rec["collectives"]["dcn_bytes"] > 0
    else:
        assert rec["collectives"]["dcn_bytes"] == 0
    assert rec["roofline"]["bound_s"] > 0
