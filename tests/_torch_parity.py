"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Both packages compile the same app graph with the same options; the port
executes on the CPU (``device="cpu"``, the kernels' plain versions) and the
JAX package on its CPU backend, each on the same numpy inputs where the
numerics are compared.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro.apps import APPS as JAX_APPS
from repro.compiler import CompileOptions as JaxCompileOptions
from repro.compiler import compile as jax_compile
from repro.core import fpga_ring_cluster as jax_ring
from repro_torch.apps import APPS as TORCH_APPS
from repro_torch.compiler import CompileOptions as TorchCompileOptions
from repro_torch.compiler import compile as torch_compile
from repro_torch.core import fpga_ring_cluster as torch_ring

# The exec smoke's options.  KNN skips the per-device floorplan (its
# 30 s time-limited MILP could stop at different incumbents in the two
# runs) and partitions 4 devices by recursive bisection to keep the test
# short; the other apps floorplan device 0 to optimality.
OPTIONS = {
    "stencil": dict(balance_kind="LUT", balance_tol=0.8,
                    floorplan_devices=(0,), exact_limit=1500),
    "cnn": dict(balance_kind="LUT", balance_tol=0.8,
                floorplan_devices=(0,), exact_limit=1500),
    "knn": dict(balance_kind="LUT", balance_tol=0.8,
                floorplan_devices=(), exact_limit=200),
    "pagerank": dict(balance_kind="LUT", balance_tol=0.8,
                     floorplan_devices=(0,), exact_limit=1500),
}
# The fabric tests' options (the JAX package's ``tests/test_net.py``): the
# congestion_feedback pass after the partition, no floorplan.  KNN keeps
# its small exact_limit.
NET_PASSES = ("normalize_units", "partition", "congestion_feedback",
              "pipeline_interconnect", "schedule")
NET_OPTIONS = {app: dict(balance_kind="LUT", balance_tol=0.8,
                         exact_limit=200 if app == "knn" else 1500,
                         partition_time_limit=20.0, passes=NET_PASSES)
               for app in ("stencil", "pagerank", "knn", "cnn")}


@functools.lru_cache(maxsize=None)
def designs(app: str, ndev: int):
    """(port design, JAX design) of ``app`` on an ``ndev``-FPGA ring."""
    port = torch_compile(TORCH_APPS[app].build_graph(ndev), torch_ring(ndev),
                         TorchCompileOptions(**OPTIONS[app]))
    ref = jax_compile(JAX_APPS[app].build_graph(ndev), jax_ring(ndev),
                      JaxCompileOptions(**OPTIONS[app]))
    return port, ref


@functools.lru_cache(maxsize=None)
def fabric_designs(app: str, ndev: int):
    """(port design, JAX design) of ``app`` on an ``ndev``-FPGA ring,
    compiled with the ring's fabric (so ``congestion_feedback`` runs)."""
    from repro.net import cluster_fabric as jax_fabric
    from repro_torch.net import cluster_fabric as torch_fabric

    port_cl, ref_cl = torch_ring(ndev), jax_ring(ndev)
    port = torch_compile(TORCH_APPS[app].build_graph(ndev), port_cl,
                         TorchCompileOptions(**NET_OPTIONS[app],
                                             fabric=torch_fabric(port_cl)))
    ref = jax_compile(JAX_APPS[app].build_graph(ndev), ref_cl,
                      JaxCompileOptions(**NET_OPTIONS[app],
                                        fabric=jax_fabric(ref_cl)))
    return port, ref


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def scaled_err(got, want) -> float:
    """Max absolute error over the output's scale (at least 1)."""
    want = np.asarray(want, np.float64)
    return max_abs(got, want) / max(1.0, float(np.max(np.abs(want))))


def channel_bytes(report):
    return [(c.src, c.dst, c.inter_device, c.tokens, c.measured_bytes)
            for c in report.channels]


def np_tree(tree):
    """A JAX parameter tree as nested dicts of float32 numpy arrays (numpy
    has no bfloat16; ``params_from_jax`` casts back)."""
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def torch_model_config(jcfg):
    """The port's ModelConfig with every field of the JAX one ``jcfg``
    (the nested MLA, MoE and recurrent configs as the port's
    dataclasses)."""
    import jax.numpy as jnp
    import torch

    from repro_torch.models import (LayerSpec, MLAConfig, MLSTMConfig,
                                    ModelConfig, MoEConfig, RGLRUConfig,
                                    SLSTMConfig)

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for key in ("pattern", "extra_layers"):
        kw[key] = tuple(LayerSpec(**dataclasses.asdict(s)) for s in kw[key])
    for key, cls in (("mla", MLAConfig), ("moe", MoEConfig),
                     ("rglru", RGLRUConfig), ("mlstm", MLSTMConfig),
                     ("slstm", SLSTMConfig)):
        if kw[key] is not None:
            kw[key] = cls(**dataclasses.asdict(kw[key]))
    for key in ("dtype", "param_dtype"):
        kw[key] = getattr(torch, jnp.dtype(kw[key]).name)
    return ModelConfig(**kw)
