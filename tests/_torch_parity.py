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
}


@functools.lru_cache(maxsize=None)
def designs(app: str, ndev: int):
    """(port design, JAX design) of ``app`` on an ``ndev``-FPGA ring."""
    port = torch_compile(TORCH_APPS[app].build_graph(ndev), torch_ring(ndev),
                         TorchCompileOptions(**OPTIONS[app]))
    ref = jax_compile(JAX_APPS[app].build_graph(ndev), jax_ring(ndev),
                      JaxCompileOptions(**OPTIONS[app]))
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
    """The port's ModelConfig with every field of the JAX one ``jcfg``."""
    import jax.numpy as jnp
    import torch

    from repro_torch.models import LayerSpec, ModelConfig

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for key in ("pattern", "extra_layers"):
        kw[key] = tuple(LayerSpec(**dataclasses.asdict(s)) for s in kw[key])
    for key in ("dtype", "param_dtype"):
        kw[key] = getattr(torch, jnp.dtype(kw[key]).name)
    return ModelConfig(**kw)
