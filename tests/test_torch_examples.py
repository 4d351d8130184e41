"""The port's last entry points on the CPU, against the JAX package: the
``run_numeric`` of stencil, KNN and CNN on ``numeric_inputs``' arrays
(the JAX ops in interpret mode), ``dot_ref``, ``axpydot_ref`` and
``layernorm``, and the four ``examples/torch_*.py`` at small sizes: the
compile numbers of the quickstart and of ``run_app`` equal JAX's, the
quickstart's ``design.execute()`` within 1e-4 of the JAX op, the serving
example's greedy tokens and the training example's first loss on JAX's
weights, and each example's refusal to run without a card unless the CPU
is asked for.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.kernels as jk
from repro.apps import APPS as JAX_APPS
from repro.compiler import CompileOptions as JaxCompileOptions
from repro.compiler import compile as jax_compile
from repro.core import fpga_ring_cluster as jax_ring
from repro.exec import execute as jax_execute
from repro.kernels.hbm_blas.ref import axpydot_ref as j_axpydot_ref
from repro.kernels.hbm_blas.ref import dot_ref as j_dot_ref
from repro.models import init_params as j_init_params
from repro.models import layers as jlayers
from repro.models import train_loss as j_train_loss
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.apps import APPS, cnn, knn, stencil
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels.hbm_blas import ops as hbm_ops
from repro_torch.kernels.hbm_blas.ref import axpydot_ref, dot_ref
from repro_torch.models import params_from_jax
from repro_torch.models.layers import layernorm, layernorm_init
from repro_torch.optim import adamw_init

from _torch_parity import channel_bytes, max_abs, np_tree, scaled_err

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
# KNN's compile as the KNN parity tests run it: no floorplan (its MILP
# stops at a 30 s limit) and recursive bisection past 200.
KNN_FAST = {"floorplan_devices": (), "exact_limit": 200}


def example(name):
    """``examples/<name>.py`` as a module (``examples`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- run_numeric ----------------------------------------------------------------

def test_stencil_run_numeric_matches_jax_bit_for_bit():
    h = w = 64
    img = stencil.numeric_inputs(h, w, seed=3)["img"]
    got = stencil.run_numeric(h, w, iters=2, seed=3, device="cpu")
    want = np.asarray(jk.dilate_op(jnp.asarray(img), iters=2,
                                   block_rows=min(128, h)))
    assert got.dtype == torch.float32 and got.shape == (h, w)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_knn_run_numeric_matches_jax():
    n, dim, q, k = 256, 8, 8, 10
    arrays = knn.numeric_inputs(n, dim, q, seed=1)
    gd, gi = knn.run_numeric(n, dim, q, k, seed=1, device="cpu")
    wd, wi = jk.knn_op(jnp.asarray(arrays["queries"]),
                       jnp.asarray(arrays["data"]), k=k, block_q=min(32, q),
                       block_n=min(512, n))
    assert gd.shape == gi.shape == (q, k) and gi.dtype == torch.int32
    assert max_abs(gd.numpy(), wd) <= TOL
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_cnn_run_numeric_matches_jax():
    """8 x 8 x 8 -> 24: N = 24 > 16, the product the tiled kernel takes
    on the card."""
    from repro_torch.kernels.systolic_matmul.kernel import route

    h = w = cin = 8
    cout = 24
    assert route(h * w, 9 * cin, cout) == "tiled"
    arrays = cnn.numeric_inputs(h, w, cin, cout, seed=2)
    got = cnn.run_numeric(h, w, cin, cout, seed=2, device="cpu")
    want = jk.conv_op(jnp.asarray(arrays["x"]), jnp.asarray(arrays["wgt"]))
    assert got.shape == (h, w, cout)
    assert scaled_err(got.numpy(), want) <= 2e-4


@pytest.mark.parametrize("app", ["stencil", "knn", "cnn", "pagerank"])
def test_run_numeric_keeps_jax_defaults_and_needs_a_device(app):
    """JAX's arguments and defaults, then ``device``; no card and no
    ``device="cpu"`` raises."""
    import inspect

    want = inspect.signature(JAX_APPS[app].run_numeric).parameters
    got = inspect.signature(APPS[app].run_numeric).parameters
    assert [(p.name, p.default) for p in want.values()] == \
        [(p.name, p.default) for p in got.values()][:len(want)]
    assert list(got)[len(want):] == ["device"]
    with pytest.raises(RuntimeError, match="none is available"):
        APPS[app].run_numeric()


# -- dot_ref, axpydot_ref, layernorm ----------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (16, 128), (3, 5, 33)])
def test_dot_and_axpydot_refs_match_jax(shape):
    rng = np.random.default_rng(6)
    x, y, w = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    a = 1.75
    t = [torch.from_numpy(v) for v in (x, y, w)]
    got = dot_ref(t[0], t[1])
    assert got.shape == () and got.dtype == torch.float32
    scale = float(np.abs(x * y).sum())
    assert abs(float(got) - float(j_dot_ref(x, y))) <= 1e-6 * scale
    got = axpydot_ref(a, *t)
    scale = float(np.abs((a * x.astype(np.float64) + y) * w).sum())
    assert abs(float(got) - float(j_axpydot_ref(a, x, y, w))) <= 1e-6 * scale
    assert {"dot_ref", "axpydot_ref"} <= set(hbm_ops.__all__)
    assert hbm_ops.dot_ref is dot_ref and hbm_ops.axpydot_ref is axpydot_ref


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at ``|v|``."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((2, 5, 48)) + 1.5).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p = layernorm_init(48, dtype=tdt, device="cpu")
    jp = jlayers.layernorm_init(48, jdt)
    for key in ("scale", "bias"):
        assert p[key].dtype == tdt and p[key].device.type == "cpu"
        np.testing.assert_array_equal(p[key].float().numpy(),
                                      np.asarray(jp[key], np.float32))
    p = {"scale": torch.from_numpy(scale).to(tdt),
         "bias": torch.from_numpy(bias).to(tdt)}
    jp = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}
    got = layernorm(p, torch.from_numpy(x).to(tdt))
    want = np.asarray(jlayers.layernorm(jp, jnp.asarray(x, jdt)), np.float32)
    assert got.dtype == tdt
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= 1e-6 * max(1.0, float(np.abs(want).max()))
    else:
        assert np.all(err <= _bf16_ulp(want))


# -- the examples -------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    """The quickstart module and its KNN design at KNN_FAST, with the JAX
    package's design of the same graph and options."""
    qs = example("torch_quickstart")
    design = qs.compile_flow(**KNN_FAST)
    g = JAX_APPS["knn"].build_graph(ndev=4, n_points=4_000_000, dim=16)
    ref = jax_compile(g, jax_ring(4), JaxCompileOptions(
        balance_kind="LUT", balance_tol=0.8,
        hbm_tasks=tuple(t for t in g.tasks if t.startswith("dist")),
        freq_hz=JAX_APPS["knn"].FREQS["FCS"], **KNN_FAST))
    return qs, design, ref


def _same_compile(port, ref):
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost
    assert (len(port.partition.cut_channels)
            == len(ref.partition.cut_channels))
    assert (port.pipeline_report.num_crossings
            == ref.pipeline_report.num_crossings)
    assert (port.pipeline_report.max_crossing
            == ref.pipeline_report.max_crossing)
    assert port.schedule.makespan == pytest.approx(ref.schedule.makespan,
                                                   rel=1e-12)


def test_quickstart_compile_matches_jax(quickstart):
    _, design, ref = quickstart
    _same_compile(design, ref)
    assert design.floorplans == {} and ref.floorplans == {}


def test_quickstart_execute_matches_jax(quickstart):
    """``design.execute()`` at the binder's default spec: the outputs
    within 1e-4 of JAX's op on the same arrays, the counters JAX's."""
    qs, design, ref = quickstart
    got = qs.execute_flow(design, "cpu")
    want = jax_execute(ref)
    arrays = knn.make_inputs(design.graph)
    single = [jk.knn_op(jnp.asarray(qs_), jnp.asarray(arrays["data"]),
                        k=10, block_q=8, block_n=512)
              for qs_ in arrays["queries"]]
    gd, gi = got.outputs
    assert max_abs(gd.numpy(), np.stack([s[0] for s in single])) <= TOL
    np.testing.assert_array_equal(gi.numpy(),
                                  np.stack([s[1] for s in single]))
    assert got.report.sweeps == want.report.sweeps
    assert channel_bytes(got.report) == channel_bytes(want.report)
    assert got.report.agreement() == want.report.agreement()
    assert all(got.report.agreement().values())


def test_quickstart_lm_loss_falls():
    losses = example("torch_quickstart").tiny_lm_train(steps=6,
                                                       device="cpu")
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("app,build_kwargs,options", [
    ("stencil", {"iters": 256}, {}), ("pagerank", {}, {}), ("cnn", {}, {}),
    ("knn", {}, KNN_FAST)], ids=["stencil", "pagerank", "cnn", "knn"])
def test_run_app_compile_matches_jax(app, build_kwargs, options):
    mf = example("torch_multi_fpga_apps")
    port = mf.run_app(app, APPS[app], build_kwargs, **options)
    mod = JAX_APPS[app]
    freq = getattr(mod, "FREQS", {"FCS": 300e6}).get("FCS", 300e6)
    ref = jax_compile(mod.build_graph(4, **build_kwargs), jax_ring(4),
                      JaxCompileOptions(balance_kind="LUT", balance_tol=0.8,
                                        freq_hz=freq, **options))
    _same_compile(port, ref)
    assert APPS[app].speedup_table() == mod.speedup_table()


def test_multi_fpga_apps_fabric_and_numerics_on_the_cpu(capsys):
    mf = example("torch_multi_fpga_apps")
    fabric, ideal = mf.fabric_execution(device="cpu")
    out = mf.numerics("cpu", stencil_hw=32, pagerank_nodes=64,
                      pagerank_edges=256, knn_n=128, knn_q=4, cnn_hw=8,
                      cnn_cin=8, cnn_cout=24)
    lines = capsys.readouterr().out
    assert "bit-identical to ideal path: True" in lines
    assert all(fabric.report.agreement().values())
    assert out["cnn"].shape == (8, 8, 24) and out["knn"][1].shape == (4, 10)
    assert "stencil 32x32 x2: out range" in lines
    assert "cnn conv3 8x8x8: out std=" in lines


def test_serve_lm_greedy_tokens_match_jax(monkeypatch):
    """The serving example at temperature 0 on JAX's weights: JAX's
    engine's greedy tokens."""
    sv = example("torch_serve_lm")
    jcfg = jax_configs.get_arch("mistral-nemo-12b").smoke()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = sv.get_arch("mistral-nemo-12b").smoke()
    carried = params_from_jax(np_tree(jp), cfg, device="cpu")
    monkeypatch.setattr(sv, "init_params", lambda gen, c: carried)
    got = sv.main(temperature=0.0, device="cpu")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (4, 12),
                                                dtype=np.int32)
    want = JServingEngine(jp, jcfg, JServeConfig(
        batch_slots=4, max_len=96, temperature=0.0)).generate(
            prompts, max_new=24)
    assert got.shape == (4, 24)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_lm_samples_the_same_tokens_from_one_seed():
    sv = example("torch_serve_lm")
    a = sv.main(max_new=6, device="cpu")
    b = sv.main(max_new=6, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, sv.main(max_new=6, sample_seed=8,
                                         device="cpu"))


def test_train_lm_restarts_and_starts_at_jax_loss(monkeypatch):
    """12 steps, killed after step 5, saving every 4: two attempts, the
    second resumed from step 4, ending at 12; the first loss is JAX's
    ``train_loss`` on the same weights and the pipeline's first batch."""
    tl = example("torch_train_lm")
    jcfg = jax_configs.get_arch("gemma2-27b").smoke()
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = tl.get_arch("gemma2-27b").smoke()

    def init_state(cfg_, optimizer, device):
        params = params_from_jax(np_tree(jp), cfg_, device=device)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32)}

    monkeypatch.setattr(tl, "init_train_state", init_state)
    final, attempts = tl.main(steps=12, fail_at=5, save_interval=4,
                              log_interval=4, device="cpu")
    assert final == 12 and len(attempts) == 2
    assert [m["step"] for m in attempts[0]] == [1, 2, 3, 4]
    assert [m["step"] for m in attempts[1]] == list(range(5, 13))
    losses = [m["loss"] for h in attempts for m in h]
    assert all(np.isfinite(losses))
    pipe = make_pipeline(DataConfig(global_batch=4, seq_len=32,
                                    vocab=cfg.vocab, seed=3))
    try:
        batch = next(pipe)
    finally:
        pipe.close()
    want = float(j_train_loss(jp, jcfg, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))
    assert abs(losses[0] - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_multi_fpga_apps", "torch_serve_lm",
                                  "torch_train_lm"])
def test_examples_refuse_to_run_without_a_card(name):
    """No silent CPU: without a card and without ``--device cpu`` each
    example raises before it does any work (quickstart's and
    multi_fpga_apps' ``main`` parse an empty command line)."""
    mod = example(name)
    with pytest.raises(RuntimeError, match="none is available"):
        if name in ("torch_quickstart", "torch_multi_fpga_apps"):
            mod.main([])
        else:
            mod.main()
