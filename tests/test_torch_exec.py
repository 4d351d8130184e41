"""PyTorch port: executor plumbing, device rules and import hygiene.

* the port's executor never runs on the CPU unless asked (``device="cpu"``);
* an op on a device with no kernel raises, and a kernel wrapper refuses a
  CPU tensor — nothing falls back;
* ``execute()`` takes no shared-mode argument, as the JAX package's
  ``execute()`` takes none, while ``ExecutionState`` accepts a tenant
  server's flow view; the bank model, the fabric and the metrics registry
  run;
* ``repro_torch`` (``obs``, ``runtime``, the snapshots and both smokes
  included) and ``chip_smoke.py`` import no JAX and nothing of ``repro``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.apps import APPS
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import fpga_ring_cluster
from repro_torch.exec import FifoChannel, bind_programs, execute, token_bytes
from repro_torch.kernels import (axpy_op, conv_op, dilate_op,
                                 dot_partials_op, gemv_op, knn_op,
                                 launch_counts, matmul_op)
from repro_torch.kernels.hbm_blas.kernel import axpy, dot_partials, gemv
from repro_torch.kernels.knn.kernel import knn
from repro_torch.kernels.stencil_dilate.kernel import dilate
from repro_torch.kernels.systolic_matmul.kernel import matmul

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def stencil_design():
    return compile(APPS["stencil"].build_graph(2), fpga_ring_cluster(2),
                   CompileOptions(balance_kind="LUT", balance_tol=0.8))


def test_token_bytes_sums_tensor_leaves():
    tok = {"x": torch.zeros(3, 4), "y": (torch.zeros(2, dtype=torch.int32),
                                         np.zeros(5, np.float64))}
    assert token_bytes(tok) == 3 * 4 * 4 + 2 * 4 + 5 * 8
    assert token_bytes((torch.zeros(8, 10), torch.zeros(8, 10,
                                                        dtype=torch.int32))
                       ) == 8 * 10 * 8


def test_channel_transfer_semantics():
    from repro_torch.core.graph import Channel
    deep = FifoChannel(0, Channel("a", "b", 32, depth=2), 0, 1,
                       dst_device=torch.device("cpu"))
    shallow = FifoChannel(1, Channel("a", "b", 32, depth=1), 0, 1,
                          dst_device=torch.device("cpu"))
    local = FifoChannel(2, Channel("a", "b", 32, depth=2), 1, 1)
    assert deep.eager_transfer and not shallow.eager_transfer
    assert not local.inter_device and not local.eager_transfer
    t = torch.arange(6.0)
    for fc in (deep, shallow, local):
        fc.push(t, sweep=0)
        assert not fc.head_visible(0) and fc.head_visible(1)
        assert torch.equal(fc.pop(1), t)
    assert deep.stats.measured_bytes == shallow.stats.measured_bytes == 24
    assert local.stats.measured_bytes == 0


def test_no_silent_cpu(stencil_design, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute(stencil_design)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stencil_design.execute()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bind_programs(stencil_design.graph)


def test_cpu_run_launches_no_kernel(stencil_design):
    before = launch_counts()
    res = execute(stencil_design, device="cpu")
    assert all(res.report.agreement().values())
    assert launch_counts() == before


@pytest.mark.parametrize("call", [
    lambda t: dilate_op(t, iters=1),
    lambda t: matmul_op(t, t),
    lambda t: conv_op(t.reshape(4, 4, 1), torch.empty(3, 3, 1, 2,
                                                      device="meta")),
    lambda t: knn_op(t, t, 2),
    lambda t: axpy_op(1.0, t, t, block_rows=4),
    lambda t: dot_partials_op(t, t, block_rows=4),
    lambda t: gemv_op(t, t[:1], block_rows=4),
])
def test_ops_raise_on_a_device_without_kernel(call):
    with pytest.raises(ValueError, match="no kernel"):
        call(torch.empty(4, 4, device="meta"))


@pytest.mark.parametrize("call", [
    lambda t: dilate(t, torch.empty_like(t)),
    lambda t: matmul(t, t),
    lambda t: knn(t, t, 2),
    lambda t: axpy(1.0, t, t, 4),
    lambda t: dot_partials(t, t, 4),
    lambda t: gemv(t, t[:1], 4),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros(4, 4))


def test_unported_layers_fail_loudly(stencil_design):
    # Shared mode belongs to ExecutionState, which a tenant server builds:
    # execute() takes no transport=, memsys= or device_map=, as the JAX
    # package's execute() takes none.
    for kw in ("transport", "memsys", "device_map"):
        with pytest.raises(TypeError, match=kw):
            execute(stencil_design, device="cpu", **{kw: object()})
    # ExecutionState accepts a flow view of a shared transport: the
    # channels route between the mapped fabric ids, tagged with the flow,
    # and the state owns neither the transport nor a memory system.
    from repro_torch.exec import ExecutionState
    from repro_torch.net import FabricTransport, cluster_fabric
    from repro_torch.tenants import FlowTransport
    shared = FabricTransport(cluster_fabric(fpga_ring_cluster(4)),
                             flow_weights={0: 1.0, 3: 2.0})
    state = ExecutionState(stencil_design, device="cpu",
                           transport=FlowTransport(shared, 3, 5),
                           device_map=[0, 2], trace_flow=3)
    assert not state.owns_transport and state.memsys is None
    assert state.device_map == [0, 2]
    cut = [fc for fc in state.channels if fc.inter_device]
    assert cut and all(fc.transport is state.transport
                       and {fc.net_src_dev, fc.net_dst_dev} == {0, 2}
                       and fc.trace_flow == 3 for fc in cut)
    # obs is ported: the report's registry view reconciles with the
    # report, its link goodput equal to the report's link bytes.
    from repro_torch.obs import MetricsRegistry, assert_registry_consistent
    res = execute(stencil_design, device="cpu")
    assert isinstance(res.report.metrics, MetricsRegistry)
    assert_registry_consistent(res.report.metrics, res.report)
    assert stencil_design.summary()["obs"]["trace_format"] == "repro-obs/v1"
    # The fabric is ported: the congestion_feedback pass compiles, and a
    # fabric run conserves bytes on every link.
    from repro_torch.net import cluster_fabric
    design = compile(APPS["stencil"].build_graph(2), fpga_ring_cluster(2),
                     CompileOptions(passes=("normalize_units", "partition",
                                            "congestion_feedback"),
                                    fabric=cluster_fabric(
                                        fpga_ring_cluster(2))))
    assert design.pass_record("congestion_feedback").detail
    res = execute(stencil_design, device="cpu",
                  fabric=cluster_fabric(fpga_ring_cluster(2)))
    assert res.report.agreement()["link_conservation"]
    goodput = res.report.metrics.series("net.link.goodput_bytes")
    assert sum(goodput.values()) == res.report.net_link_bytes > 0
    assert {dict(k)["link"]: v for k, v in goodput.items()} == {
        l.index: l.bytes for l in res.report.congestion.links}
    # The bank model is ported: its pass compiles, and a binding without
    # memory streams runs as before under a bank model.
    from repro_torch.mem import MemConfig
    design = compile(APPS["stencil"].build_graph(2), fpga_ring_cluster(2),
                     CompileOptions(passes=("normalize_units", "partition",
                                            "memory_feedback"),
                                    mem=MemConfig()))
    assert design.bank_map == {"stage0": 0, "stage1": 0}
    res = execute(stencil_design, device="cpu", mem=MemConfig())
    assert res.report.mem_contention is None and not res.report.mem_channels


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) > 30
    assert {"mem", "net", "hbm_blas", "models", "serving", "launch",
            "flash_attention", "obs", "runtime", "optim", "data",
            "ckpt"} <= {
        part for f in files for part in f.parts}
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/obs/{m}.py" for m in
            ("trace", "metrics", "critpath", "attrib", "slo", "diff",
             "smoke")} <= names
    assert {"src/repro_torch/runtime/fault.py",
            "src/repro_torch/runtime/trainer.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/kernels/flash_attention/backward.py",
            "src/repro_torch/exec/snapshot.py",
            "src/repro_torch/exec/smoke.py"} <= names
    assert {f"src/repro_torch/tenants/{m}.py" for m in
            ("server", "recover", "slo", "traffic", "simulate",
             "smoke")} <= names
    assert {f"src/repro_torch/chaos/{m}.py" for m in
            ("scenario", "runner", "smoke")} <= names
    assert {f"src/repro_torch/launch/{m}.py" for m in
            ("mesh", "shardings", "pipeline", "plan", "hlo_analysis",
             "dryrun")} | {"src/repro_torch/models/shardctx.py"} <= names
    assert {f"examples/torch_{m}.py" for m in
            ("quickstart", "multi_fpga_apps", "serve_lm", "train_lm")} | {
        "scripts/torch_decode_step.py", "scripts/torch_flash_ab.py"} <= names
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_port_path_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.apps, repro_torch.compiler, repro_torch.exec\n"
        "import repro_torch.mem, repro_torch.mem.smoke\n"
        "import repro_torch.obs, repro_torch.exec.snapshot\n"
        "import repro_torch.runtime, repro_torch.runtime.fault\n"
        "import repro_torch.obs.smoke, repro_torch.obs.diff\n"
        "import repro_torch.exec.smoke\n"
        "from repro_torch.obs import Tracer\n"
        "import tempfile\n"
        "from repro_torch.apps import APPS\n"
        "from repro_torch.compiler import CompileOptions, compile\n"
        "from repro_torch.core import fpga_ring_cluster\n"
        "d = compile(APPS['stencil'].build_graph(2), fpga_ring_cluster(2),\n"
        "            CompileOptions())\n"
        "r = d.execute({'h': 16, 'w': 16}, device='cpu')\n"
        "assert all(r.report.agreement().values())\n"
        "with tempfile.TemporaryDirectory() as t:\n"
        "    inj = repro_torch.runtime.FailureInjector([3])\n"
        "    try:\n"
        "        d.execute({'h': 16, 'w': 16}, device='cpu', injector=inj,\n"
        "                  checkpoint_dir=t, checkpoint_every=2)\n"
        "    except inj.Injected:\n"
        "        pass\n"
        "    r = repro_torch.exec.resume_execution(\n"
        "        d, t, inputs={'h': 16, 'w': 16}, device='cpu',\n"
        "        tracer=Tracer())\n"
        "assert all(r.report.agreement().values())\n"
        "assert r.report.metrics.total('exec.device.fired') > 0\n"
        "d = compile(APPS['axpy'].build_graph(2), fpga_ring_cluster(2),\n"
        "            CompileOptions(mem=repro_torch.mem.MemConfig()))\n"
        "r = d.execute(device='cpu')\n"
        "assert r.report.agreement()['bank_conservation']\n"
        "import repro_torch.net, repro_torch.net.smoke\n"
        "d = compile(APPS['pagerank'].build_graph(2), fpga_ring_cluster(2),\n"
        "            CompileOptions())\n"
        "r = d.execute({'n_nodes': 64, 'n_edges': 512}, device='cpu')\n"
        "assert all(r.report.agreement().values())\n"
        "f = repro_torch.net.cluster_fabric(fpga_ring_cluster(2))\n"
        "d = compile(APPS['pagerank'].build_graph(2), fpga_ring_cluster(2),\n"
        "            CompileOptions(fabric=f))\n"
        "r = d.execute({'n_nodes': 64, 'n_edges': 512}, device='cpu')\n"
        "assert r.report.agreement()['link_conservation']\n"
        "import repro_torch.tenants, repro_torch.chaos\n"
        "import repro_torch.tenants.smoke, repro_torch.chaos.smoke\n"
        "from repro_torch.tenants import Tenant, TenantServer\n"
        "d = compile(APPS['stencil'].build_graph(2), fpga_ring_cluster(2),\n"
        "            CompileOptions())\n"
        "out = TenantServer(repro_torch.net.cluster_fabric(\n"
        "    fpga_ring_cluster(4)), [Tenant('a', d, [0, 2], inputs={\n"
        "        'h': 16, 'w': 16})], device='cpu').run()\n"
        "assert out.record('a').status == 'done'\n"
        "assert out.conservation['exact']\n"
        "import torch\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "from repro_torch.launch.steps import build_prefill_step\n"
        "cfg = repro_torch.configs.get_arch('qwen3-4b').smoke()\n"
        "p = repro_torch.models.init_params(torch.Generator(), cfg)\n"
        "c = repro_torch.models.init_cache(cfg, 2, 8, device='cpu')\n"
        "c, lg = repro_torch.models.serve_step(\n"
        "    p, cfg, c, torch.zeros(2, 1, dtype=torch.long), 0)\n"
        "assert lg.shape == (2, cfg.vocab)\n"
        "lg = build_prefill_step(cfg, 'cpu')(p, {'tokens': [[1, 2, 3]]})\n"
        "assert lg.shape == (1, cfg.vocab)\n"
        "import repro_torch.optim, repro_torch.ckpt, repro_torch.data\n"
        "import repro_torch.launch.train\n"
        "from repro_torch.launch.steps import (build_train_step,\n"
        "                                      init_train_state)\n"
        "s = init_train_state(cfg, device='cpu')\n"
        "s, m = build_train_step(cfg, device='cpu')(s, {\n"
        "    'tokens': [[1, 2, 3, 4]], 'targets': [[2, 3, 4, 5]],\n"
        "    'weights': [[1.0, 1.0, 1.0, 1.0]]})\n"
        "assert int(s['step']) == 1 and float(m['loss']) > 0\n"
        "import repro_torch.launch.mesh, repro_torch.launch.shardings\n"
        "import repro_torch.launch.pipeline, repro_torch.launch.plan\n"
        "import repro_torch.launch.hlo_analysis, repro_torch.launch.dryrun\n"
        "import repro_torch.models.shardctx\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.run_on_mesh('qwen3-4b', cfg, 'decode_32k', (2, 2),\n"
        "                         ('data', 'model'))\n"
        "assert rec['ok'], rec.get('error')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
