"""The port's sharding rules against the JAX package's, leaf by leaf, for
all ten archs' ``full()`` configs on ``AbstractMesh`` (16, 16),
(2, 16, 16) and (2, 2, 2) (no devices, no process group):

- ``param_specs`` (train and ``serve=True``), ``state_shardings`` (AdamW
  and Adafactor), ``cache_shardings`` (each supported decode cell) and
  ``input_shardings``.  JAX stacks a super-block pattern's layers on a
  leading axis its specs leave unsharded; the port's layer leaf takes
  JAX's spec without that entry.  One exception: JAX's Adafactor factors
  a stacked vector ([L, D], a norm scale) across the super-blocks
  (``vr``/``vc``) where the port keeps one unfactored ``v`` per layer
  (ROADMAP, differences by design); those leaves are named by
  ``_renamed_adafactor`` and held to JAX's rule evaluated on the port's
  own leaf (JAX's ``state_shardings`` over a state with that leaf).
- ``shardctx._resolve`` against JAX's on a grid of axes, dims and mesh
  shapes.
- ``input_specs`` and ``synthetic_batch_specs``: JAX's shapes and dtypes
  for every arch × supported shape (a decode cache leaf by leaf, the
  port's per-layer leaf JAX's without the stacked axis).
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jax_configs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import synthetic_batch_specs as j_batch_specs
from repro.launch import shardings as jsh
from repro.launch import steps as jsteps
from repro.models import init_params as j_init_params
from repro.models import shardctx as jctx
from repro_torch import configs
from repro_torch.data import DataConfig, synthetic_batch_specs
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.models import shardctx

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
ARCHS = list(configs.ALL_ARCHS)


def _mesh(i):
    shape, axes = MESHES[i]
    return AbstractMesh(shape, axes)


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries, a one-axis tuple as its name."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def _keys(path):
    return tuple(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", str(k)))) for k in path)


def _port_keys(cfg, keys):
    """The port's key paths of the JAX leaf at ``keys`` and whether JAX
    stacks it: a stacked layer leaf is every super-block's layer."""
    for pre in range(len(keys)):
        if keys[pre] in ("blocks", "enc_blocks", "extra"):
            break
    else:
        return [keys], False
    head, rest = keys[:pre], keys[pre + 2:]
    name, sub = keys[pre], keys[pre + 1]
    if name == "extra":
        n_sb = cfg.num_superblocks * len(cfg.pattern)
        return [head + ("blocks", n_sb + int(sub[1:])) + rest], False
    pattern, superblocks = ((cfg.pattern, cfg.num_superblocks)
                            if name == "blocks"
                            else (cfg.enc_pattern, cfg.enc_superblocks))
    i = int(sub[1:])
    return [head + (name, sb * len(pattern) + i) + rest
            for sb in range(superblocks)], True


def _expect(jcfg, jtree_specs, jtree_shapes):
    """{port keys: normalised JAX spec} of a JAX tree of specs."""
    flat_s = jax.tree_util.tree_flatten_with_path(
        jtree_specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.NamedSharding))[0]
    shapes = {_keys(p): l.shape for p, l in
              jax.tree_util.tree_flatten_with_path(jtree_shapes)[0]}
    out = {}
    for path, s in flat_s:
        keys = _keys(path)
        ndim = len(shapes[keys])
        spec = _norm(s.spec, ndim)
        ports, stacked = _port_keys(jcfg, keys)
        for pk in ports:
            out[pk] = spec[1:] if stacked else spec
    return out


def _got(tree, shapes):
    flat_shapes = dict(sh.flat_specs(torch.utils._pytree.tree_map(
        lambda t: tuple(t.shape), shapes)))
    return {k: _norm(v, len(flat_shapes[k])) for k, v in sh.flat_specs(tree)}


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch):
    jcfg = jax_configs.get_arch(arch).full()
    return jcfg, jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _port_state_shape(arch, optimizer):
    return steps.state_shape(configs.get_arch(arch).full(), optimizer)


def _sizes(mesh):
    return dict(mesh.shape)


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("serve", [False, True])
def test_param_specs_match_jax(arch, mesh_i, serve):
    jcfg, jshape = _jax_params_shape(arch)
    mesh = _mesh(mesh_i)
    want = _expect(jcfg, jsh.param_shardings(jshape, mesh, serve=serve),
                   jshape)
    cfg = configs.get_arch(arch).full()
    shapes = _port_state_shape(arch, "adamw")["params"]
    got = _got(sh.param_specs(shapes, cfg, _sizes(mesh), serve=serve),
               shapes)
    assert set(got) == set(want)
    bad = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
    assert not bad, bad[:5]


def _renamed_adafactor(jshape_opt):
    """The JAX Adafactor leaves {vr, vc} of a stacked vector [L, D] (the
    port keeps {v} per layer): their param key paths."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jshape_opt)[0]:
        keys = _keys(path)
        if keys[-1] == "vr" and len(leaf.shape) == 1 and any(
                k in ("blocks", "enc_blocks") for k in keys):
            out.append(keys[:-1])
    return out


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_shardings_match_jax(arch, mesh_i, optimizer, monkeypatch):
    jcfg, _ = _jax_params_shape(arch)
    mesh = _mesh(mesh_i)
    jshape = jsteps.state_shape(jcfg, optimizer)
    renamed = _renamed_adafactor(jshape["opt"]) \
        if optimizer == "adafactor" else []
    if renamed:
        # JAX's rule on the port's leaf: its state with each renamed pair
        # replaced by the unfactored {v} of one layer's vector.
        opt = jax.tree_util.tree_map(lambda x: x, jshape["opt"])
        for keys in renamed:
            node = opt
            for k in keys[:-1]:
                node = node[k]
            D = node[keys[-1]]["vc"].shape[-1]
            node[keys[-1]] = {"v": jax.ShapeDtypeStruct((1, D),
                                                        jnp.float32)}
        jshape = dict(jshape, opt=opt)
        monkeypatch.setattr(jsteps, "state_shape",
                            lambda cfg, optimizer="adamw": jshape)
    jspecs = jsteps.state_shardings(jcfg, mesh, optimizer)
    want = _expect(jcfg, {"params": jspecs["params"], "opt": jspecs["opt"]},
                   {"params": jshape["params"], "opt": jshape["opt"]})
    cfg = configs.get_arch(arch).full()
    shapes = _port_state_shape(arch, optimizer)
    specs = steps.state_shardings(cfg, _sizes(mesh), optimizer, shapes)
    assert specs["step"] == () and _norm(jspecs["step"].spec, 0) == ()
    got = _got({"params": specs["params"], "opt": specs["opt"]},
               {"params": shapes["params"], "opt": shapes["opt"]})
    assert set(got) == set(want)
    bad = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
    assert not bad, bad[:5]
    if optimizer == "adafactor" and jcfg.num_superblocks > 1:
        assert renamed              # the stacked norm scales at least


def _decode_shapes(arch):
    mod = configs.get_arch(arch)
    return [s for s in configs.supported_shapes(mod)
            if configs.SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_shardings_match_jax(arch, mesh_i):
    jcfg, _ = _jax_params_shape(arch)
    cfg = configs.get_arch(arch).full()
    mesh = _mesh(mesh_i)
    for shape in configs.supported_shapes(configs.get_arch(arch)):
        jspecs = jax_configs.input_specs(jcfg, shape)
        specs = configs.input_specs(cfg, shape)
        flat = {k: v for k, v in jspecs.items() if k not in ("cache",
                                                               "pos")}
        jin = jsh.input_shardings(flat, mesh)
        pin = sh.input_shardings({k: specs[k] for k in flat}, _sizes(mesh))
        for k in flat:
            nd = len(flat[k].shape)
            assert _norm(pin[k], nd) == _norm(jin[k].spec, nd), (shape, k)
        if "cache" not in jspecs:
            continue
        want = _expect(jcfg, {"cache": jsh.cache_shardings(
            jspecs["cache"], mesh)}, {"cache": jspecs["cache"]})
        got = _got({"cache": sh.cache_shardings(specs["cache"], cfg,
                                                _sizes(mesh))},
                   {"cache": specs["cache"]})
        assert set(got) == set(want)
        bad = [(k, got[k], want[k]) for k in want if got[k] != want[k]]
        assert not bad, (shape, bad[:5])


def test_every_arch_has_a_decode_cell_checked():
    assert all(_decode_shapes(a) for a in ARCHS)
    assert {"decode_32k", "long_500k"} <= {s for a in ARCHS
                                          for s in _decode_shapes(a)}


AXES = [None, "data", "model", "pod", "batch", ("model", "data"),
        ("pod", "data"), "nope"]
DIMS = [1, 2, 4, 6, 16, 32, 160, 256]


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")])
def test_resolve_matches_jax(mesh_i, batch_axes):
    mesh = _mesh(mesh_i)
    for axis, dim in itertools.product(AXES, DIMS):
        with jctx.use_mesh(mesh, batch_axes):
            want = jctx._resolve(axis, mesh, dim)
        with shardctx.use_mesh(None, batch_axes):
            got = shardctx._resolve(axis, _sizes(mesh), dim)
        assert got == want, (axis, dim)


_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    jcfg, _ = _jax_params_shape(arch)
    cfg = configs.get_arch(arch).full()
    for shape in configs.supported_shapes(configs.get_arch(arch)):
        jspecs = jax_configs.input_specs(jcfg, shape)
        specs = configs.input_specs(cfg, shape)
        assert set(specs) == set(jspecs)
        for k, v in jspecs.items():
            if k == "cache":
                continue
            assert specs[k].device.type == "meta"
            assert tuple(specs[k].shape) == tuple(v.shape), (shape, k)
            assert specs[k].dtype == _DTYPES[jnp.dtype(v.dtype)], (shape, k)
        if "cache" not in jspecs:
            continue
        got = dict(sh.flat_specs(torch.utils._pytree.tree_map(
            lambda t: (tuple(t.shape), t.dtype), specs["cache"])))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jspecs["cache"])[0]:
            ports, stacked = _port_keys(jcfg, _keys(path))
            for pk in ports:
                shape_, dtype = got.pop(pk)
                assert shape_ == tuple(leaf.shape[1:] if stacked
                                       else leaf.shape), pk
                assert dtype == _DTYPES[jnp.dtype(leaf.dtype)], pk
        assert not got, list(got)[:3]


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_specs_match_jax(arch):
    cfg = configs.get_arch(arch).full()
    kw = dict(global_batch=8, seq_len=4096, vocab=cfg.vocab,
              frontend_tokens=cfg.frontend_tokens
              if cfg.frontend == "vision" else 0, d_model=cfg.d_model,
              enc_len=1024 if cfg.arch == "encdec" else 0)
    want = j_batch_specs(JDataConfig(**kw))
    got = synthetic_batch_specs(DataConfig(**kw))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].dtype == _DTYPES[jnp.dtype(v.dtype)], k
