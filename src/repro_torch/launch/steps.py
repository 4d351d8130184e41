"""Steps: train_step / prefill_step / serve_step for a given arch config,
on one device or on a mesh, and the ``lower_*`` functions the dry run
runs.

These are the functions the training and serving CLIs execute, for every
arch of ``configs`` (the recurrent ones train too).  Each step runs on
``device``: ``cuda`` unless the caller names the CPU.

With ``mesh=`` (a ``DeviceMesh`` with JAX's axis names) a step is FSDP
over JAX's placements: the state's leaves are DTensors placed by
:func:`state_shardings` (the counterpart of JAX's ``in_shardings``),
each rank computes on its slice of the batch (``shardings.batch_slice``,
pod-major), and the model code gathers each weight whole where it uses
it (``models.shardctx.gather``), inside its super-block's recompute, so
its gradient comes back to the parameter's placements as a
reduce-scatter.  The products are not split over 'model' as GSPMD
splits them (ROADMAP, differences by design).  ``mesh=None`` is the
one-device path.

``lower_train``, ``lower_prefill`` and ``lower_serve`` build the state
and the inputs as fake tensors (``FakeTensorMode``) placed on a mesh
over any process group (the dry run's ``"fake"`` one) and return a
:class:`Lowered` whose ``compile()`` runs the step once under the FLOP
counter, the collective recorder and the memory tracker
(``hlo_analysis``).  Nothing is allocated and no kernel runs: the flash
op takes its plain version on the fake CPU tensors.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..exec.programs import resolve_device
from ..models import ModelConfig, init_params, serve_step
from ..models import layers
from ..models import shardctx
from ..models import transformer as T
from ..optim import (AdafactorConfig, AdamWConfig, adafactor_init,
                     adafactor_update, adamw_init, adamw_update)
from . import shardings as sh

OPTIMIZERS = ("adamw", "adafactor")


# -- train --------------------------------------------------------------------

def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r} is not one of "
                         f"{OPTIMIZERS}")


def init_train_state(cfg: ModelConfig, optimizer: str = "adamw",
                     gen: torch.Generator = None, device=None) -> dict:
    """``{"params", "opt", "step"}``: params drawn from ``gen`` (seed 0 on
    ``device`` when None), the optimizer's fresh state and step 0 (int32),
    all on ``device`` (``cuda`` unless the caller names another)."""
    _check_optimizer(optimizer)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    if not T.same_device(gen.device, dev):
        raise ValueError(f"the generator lies on {gen.device}, not {dev}")
    params = init_params(gen, cfg)
    opt = (adamw_init(params) if optimizer == "adamw"
           else adafactor_init(params))
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def batch_to_device(cfg: ModelConfig, batch: Dict, dev: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A training batch (numpy arrays or tensors) on ``dev``: tokens and
    targets as int64, the other leaves (weights, frontend, src) fp32."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value, device=dev)
        out[key] = t.long() if key in ("tokens", "targets") else t.float()
    return out


# -- state on a mesh ------------------------------------------------------------

def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def params_shape(cfg: ModelConfig) -> dict:
    """``init_params``' tree as meta tensors (no allocation), as nested
    dicts and lists (``layers.tree_map``'s form).  The layers of one spec
    have one shape, so the tree is drawn (on fake tensors) for one
    super-block of each stack and its layers repeated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    one = dataclasses.replace(cfg, num_superblocks=1,
                              enc_superblocks=min(cfg.enc_superblocks, 1))
    with FakeTensorMode():
        tree = layers.tree_map(_meta, init_params(torch.Generator(), one))

    def repeat(blocks, n_pattern, superblocks):
        return ([blocks[l % n_pattern] for l in range(
            superblocks * n_pattern)] + blocks[n_pattern:])
    tree["blocks"] = repeat(tree["blocks"], len(cfg.pattern),
                            cfg.num_superblocks)
    if "enc_blocks" in tree:
        tree["enc_blocks"] = repeat(tree["enc_blocks"], len(cfg.enc_pattern),
                                    cfg.enc_superblocks)
    return tree


def state_shape(cfg: ModelConfig, optimizer: str = "adamw") -> dict:
    """The train state's leaves as meta tensors (no allocation): the
    params (:func:`params_shape`), the optimizer state and the step."""
    _check_optimizer(optimizer)
    params = params_shape(cfg)
    return {"params": params,
            "opt": (adamw_init(params) if optimizer == "adamw"
                    else adafactor_init(params)),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _opt_spec(cfg: ModelConfig, mesh, keys, shape) -> sh.Spec:
    """JAX's rule for an optimizer leaf at ``keys`` (``("mu", ...)``,
    ``("v", ..., name, "vr")`` or ``("count",)``)."""
    name = keys[-1]
    if name == "count":
        return ()
    if name in ("vr", "vc", "v") and len(keys) >= 2:
        # JAX derives a factored rule for a matrix's vr/vc (and a 'v' of a
        # leaf whose rule has two or more entries) and then falls through
        # to P(): every Adafactor moment is replicated, a 1-D param's with
        # an explicit None per dim.
        rule = sh.PARAM_RULES.get(keys[-2])
        if rule is not None and len(rule) < 2:
            return (None,) * len(shape)
        return ()
    # mu/nu (adamw) mirror the param tree — leaf name IS the param name.
    return sh.param_spec(keys[1:], shape, mesh, tied=cfg.tie_embeddings,
                         stack=sh._stack(cfg, keys[1:]))


def state_shardings(cfg: ModelConfig, mesh, optimizer: str = "adamw",
                    shapes: dict = None) -> dict:
    """The spec of every leaf of the train state (JAX's ``in_shardings``
    rules): the params by ``shardings.param_spec``, AdamW's moments as
    their params, Adafactor's moments replicated, the counts replicated.
    ``shapes``: :func:`state_shape`'s tree (built when None)."""
    if shapes is None:
        shapes = state_shape(cfg, optimizer)
    return {"params": sh.param_specs(shapes["params"], cfg, mesh),
            "opt": layers.tree_map_with_keys(
                lambda k, leaf: _opt_spec(cfg, mesh, k, leaf.shape),
                shapes["opt"]),
            "step": ()}


def _place(t: torch.Tensor, spec: sh.Spec, mesh: DeviceMesh) -> DTensor:
    return distribute_tensor(t.detach(), mesh, sh.placements(spec, mesh))


def shard_params(params, cfg: ModelConfig, mesh: DeviceMesh,
                 serve: bool = False) -> layers.ParamTree:
    """A parameter tree (the same on every rank) as a tree of DTensors
    placed by ``shardings.param_specs`` (the serving layout with
    ``serve=True``)."""
    specs = dict(sh.flat_specs(sh.param_specs(params, cfg, mesh, serve=serve)))
    return layers.ParamTree(layers.tree_map_with_keys(
        lambda k, t: _place(t, specs[k], mesh), params))


def _replace_leaves(tree, fn, keys=()) -> None:
    """Replace each tensor leaf of ``tree`` (a ParamTree, nested dicts and
    lists) by ``fn(keys, leaf)``, in place, so the old leaf can be freed
    before the next is placed."""
    if isinstance(tree, layers.ParamTree):
        for name in list(tree._parameters):
            tree._parameters[name] = torch.nn.Parameter(
                fn(keys + (name,), tree._parameters[name]),
                requires_grad=False)
        for name, child in tree._modules.items():
            _replace_leaves(child, fn, keys + (name,))
        return
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in list(items):
        if isinstance(v, torch.Tensor):
            tree[k] = fn(keys + (k,), v)
        else:
            _replace_leaves(v, fn, keys + (k,))


def shard_state(state: dict, cfg: ModelConfig, mesh: DeviceMesh,
                optimizer: str = "adamw") -> dict:
    """A train state (the same on every rank, from
    :func:`init_train_state`) with its params and moments as DTensors
    placed by :func:`state_shardings`; ``count`` and ``step`` stay plain
    (replicated) tensors.  The state is converted in place, leaf by leaf
    (a leaf that ``distribute_tensor`` copies is freed before the next is
    placed, so the state is never held twice), and returned."""
    _check_optimizer(optimizer)
    specs = dict(sh.flat_specs(state_shardings(
        cfg, mesh, optimizer, {"params": state["params"],
                               "opt": state["opt"]})))

    def place(keys, t):
        if keys == ("opt", "count"):
            return t
        return _place(t, specs[keys], mesh)
    _replace_leaves(state["params"], lambda k, t: place(("params",) + k, t))
    _replace_leaves(state["opt"], lambda k, t: place(("opt",) + k, t))
    return state


def full_state(tree):
    """``tree`` with every DTensor leaf whole (``full_tensor``, a
    collective: every rank calls it), as nested dicts and lists."""
    return layers.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


# -- the step -----------------------------------------------------------------

def _gathered_view(params) -> dict:
    """The parameter tree with its top-level leaves (embedding, norms,
    unembedding, the MTP head) gathered whole; the layer lists stay
    sharded, and ``apply_layer`` gathers each layer where it runs."""
    return {k: (params[k] if k in ("blocks", "enc_blocks")
                else shardctx.gather(params[k])) for k in params.keys()}


def _batch_of(mesh: Optional[DeviceMesh], x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a batch leaf; the leaf must split evenly over
    the batch axes (a replicated batch would add its gradient once per
    slice)."""
    if mesh is None:
        return x
    n = sh.batch_shards(mesh)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over the mesh's {n} batch slices")
    return sh.batch_slice(x, mesh)


def _gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                 split: bool) -> torch.Tensor:
    """Every rank's rows of a split batch output, whole (pod-major)."""
    if not split:
        return x
    batch = sh.batch_axes(mesh)
    plc = [Shard(0) if n in batch else Replicate()
           for n in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, plc, run_check=False).full_tensor()


def build_train_step(cfg: ModelConfig, optimizer: str = "adamw",
                     microbatches: int = 1, device=None,
                     mesh: Optional[DeviceMesh] = None) -> Callable:
    """``step(state, batch) -> (state, {"loss"})``: the JAX package's
    ``build_train_step``.  The gradient of ``train_loss`` comes from
    ``torch.autograd``; with ``microbatches > 1`` the batch is split
    along its leading axis and the gradients accumulated (fp32 with
    AdamW, bf16 with Adafactor, as JAX chose for state size) and
    averaged.  The optimizer (JAX's default config) updates the params
    and moments in place; the returned state drops AdamW's ``grad_norm``.
    The flash kernel runs ``transformer.train_flash_launches(cfg)`` times
    a microbatch.

    With ``mesh`` the state comes from :func:`shard_state` and ``batch``
    is the global batch (every rank passes the same): each rank computes
    its rows of each microbatch (JAX's microbatch m is rows
    ``[m·B/M, (m+1)·B/M)`` of the global batch), the loss's weight sum is
    the whole microbatch's, and the returned loss is the sum over the
    batch slices (every rank holds it)."""
    _check_optimizer(optimizer)
    T.check_supported(cfg)
    dev = resolve_device(device)
    opt_cfg = AdamWConfig() if optimizer == "adamw" else AdafactorConfig()
    acc_dtype = torch.float32 if optimizer == "adamw" else torch.bfloat16
    ba = sh.batch_axes(mesh)

    def value_and_grad(params, leaves, batch):
        view = _gathered_view(params) if mesh is not None else params
        loss = T.train_loss(view, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss does not reach (the router's bias, which only
        # selects experts) has a zero gradient, as under jax.grad.
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def step(state, batch):
        params = state["params"]
        T.check_on(params, dev)
        batch = batch_to_device(cfg, batch, dev)
        leaves = layers.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with shardctx.use_mesh(mesh, ba):
            if microbatches > 1:
                B = batch["tokens"].shape[0]
                if B % microbatches:
                    raise ValueError(f"batch {B} is not a multiple of "
                                     f"{microbatches} microbatches")
                mb = B // microbatches
                acc = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(microbatches):
                    part = {k: _batch_of(mesh, v[i * mb:(i + 1) * mb])
                            for k, v in batch.items()}
                    l, g = value_and_grad(params, leaves, part)
                    for a, gi in zip(acc, g):
                        a.add_(gi.to(acc_dtype))
                    loss = loss + l
                    del g
                grads = [a / microbatches for a in acc]
                loss = loss / microbatches
            else:
                part = {k: _batch_of(mesh, v) for k, v in batch.items()}
                loss, grads = value_and_grad(params, leaves, part)
            loss = shardctx.batch_sum(loss)
        it = iter(grads)
        grads = layers.tree_map(lambda _: next(it), params)
        if optimizer == "adamw":
            new_p, new_opt = adamw_update(params, grads, state["opt"],
                                          opt_cfg)
            new_opt = {k: new_opt[k] for k in ("mu", "nu", "count")}
        else:
            new_p, new_opt = adafactor_update(params, grads, state["opt"],
                                              opt_cfg)
        return ({"params": new_p, "opt": new_opt,
                 "step": state["step"] + 1}, {"loss": loss})
    return step


# -- prefill and decode -------------------------------------------------------


@torch.no_grad()
def encode(params, cfg: ModelConfig, src: torch.Tensor) -> torch.Tensor:
    """An enc-dec config's encoder output [B,Senc,D] over frame embeddings
    ``src`` [B,Senc,D] (cast to ``cfg.dtype``) at positions
    ``arange(Senc)``: what the prefill step's decoder attends to, and what
    ``build_serve_step``'s ``enc_out`` takes."""
    B, E = src.shape[:2]
    return T._run_encoder(params, cfg, src.to(cfg.dtype), torch.arange(
        E, device=src.device).expand(B, E))


def build_prefill_step(cfg: ModelConfig, device=None,
                       mesh: Optional[DeviceMesh] = None) -> Callable:
    """``prefill(params, batch) -> logits [B,V]`` (fp32) of the last
    position, through the full-sequence stack: ``batch["tokens"]`` [B,St];
    for the vision frontend also ``batch["frontend"]`` [B,P,D], patch
    embeddings prepended to the tokens; for an enc-dec config also
    ``batch["src"]`` [B,Senc,D], frame embeddings the encoder runs over
    (positions ``arange(Senc)``) before the decoder attends to its output.
    Each float input is cast to ``cfg.dtype``.  The flash kernel runs
    :func:`~repro_torch.models.transformer.prefill_flash_launches` times.

    With ``mesh`` the params are DTensors (:func:`shard_params`, either
    layout) and each rank runs its slice of the batch where the batch
    axes split it (``shardings.input_spec``; else the whole batch); the
    logits are gathered whole on every rank."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    ba = sh.batch_axes(mesh)

    def as_float(a) -> torch.Tensor:
        return torch.as_tensor(a, device=dev).to(cfg.dtype)

    @torch.no_grad()
    def prefill(params, batch) -> torch.Tensor:
        T.check_on(params, dev)
        split = mesh is not None and bool(
            sh.input_spec(tuple(batch["tokens"].shape), mesh))
        rows = (lambda x: sh.batch_slice(x, mesh)) if split \
            else (lambda x: x)
        inputs = {"tokens": rows(torch.as_tensor(batch["tokens"],
                                                 device=dev).long())}
        if cfg.frontend == "vision":
            inputs["frontend"] = rows(as_float(batch["frontend"]))
        with shardctx.use_mesh(mesh, ba):
            view = _gathered_view(params) if mesh is not None else params
            x = T._embed_inputs(view, cfg, inputs)
            B, S, _ = x.shape
            positions = torch.arange(S, device=dev).expand(B, S)
            enc_out = None
            if cfg.arch == "encdec":
                enc_out = encode(view, cfg, rows(torch.as_tensor(
                    batch["src"], device=dev)))
            x, _ = T._run_stack(view, cfg, x, positions, enc_out)
            x = layers.rmsnorm(view["final_norm"], x[:, -1:, :],
                               zero_centered=cfg.zero_centered_norm)
            logits = layers.unembed(T._unembed_table(view, cfg), x[:, 0, :])
            logits = layers.softcap(logits, cfg.final_softcap)
        if mesh is not None:
            logits = _gather_rows(logits, mesh, split)
        return logits
    return prefill


def shard_cache(cache: dict, cfg: ModelConfig, mesh: DeviceMesh) -> dict:
    """A decode cache (``models.init_cache``'s tree, the same on every
    rank) as DTensors placed by ``shardings.cache_shardings``."""
    specs = dict(sh.flat_specs(sh.cache_shardings(cache, cfg, mesh)))
    return layers.tree_map_with_keys(
        lambda k, t: _place(t, specs[k], mesh), cache)


def _cache_target(mesh: DeviceMesh, split: bool) -> list:
    """The placements a cache leaf is computed in: its batch dim split as
    the tokens are, every other dim whole."""
    batch = sh.batch_axes(mesh) if split else ()
    return [Shard(0) if n in batch else Replicate()
            for n in mesh.mesh_dim_names]


def build_serve_step(cfg: ModelConfig, device=None,
                     mesh: Optional[DeviceMesh] = None) -> Callable:
    """``step(params, cache, tokens, pos, enc_out=None) -> (cache,
    logits)``: one decode step (:func:`repro_torch.models.serve_step`);
    an enc-dec config's cross blocks attend to ``enc_out`` [B,Senc,D].

    With ``mesh`` the params are DTensors (:func:`shard_params`, the
    serving layout with ``serve=True``) and the cache comes from
    :func:`shard_cache`; ``tokens`` and ``enc_out`` are the global batch.
    Each rank runs its rows where the batch axes split the tokens.  A
    cache leaf held in those placements is updated in place; one split
    otherwise (over sequence, heads or state, or over 'data' alone) is
    gathered at use and the rank's block of the updated leaf is written
    back.  The logits are gathered whole on every rank."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    ba = sh.batch_axes(mesh)

    @torch.no_grad()
    def step(params, cache, tokens, pos, enc_out=None):
        T.check_on(params, dev)
        tokens = torch.as_tensor(tokens, device=dev).long()
        if mesh is None:
            return serve_step(params, cfg, cache, tokens, pos,
                              enc_out=enc_out)
        split = bool(sh.input_spec(tuple(tokens.shape), mesh))
        if split:
            tokens = sh.batch_slice(tokens, mesh)
            if enc_out is not None:
                enc_out = sh.batch_slice(enc_out, mesh)
        local = {"blocks": []}
        for layer in cache["blocks"]:
            ours = {}
            for k, leaf in layer.items():
                target = _cache_target(mesh, split)
                if list(leaf.placements) == target:
                    ours[k] = leaf.to_local()
                else:
                    ours[k] = leaf.redistribute(mesh, target).to_local()
            local["blocks"].append(ours)
        with shardctx.use_mesh(mesh, ba):
            _, logits = serve_step(_gathered_view(params), cfg, local,
                                   tokens, pos, enc_out=enc_out)
        for layer, ours in zip(cache["blocks"], local["blocks"]):
            for k, leaf in layer.items():
                new, mine = ours[k], leaf.to_local()
                if new is mine:
                    continue          # updated in place
                target = _cache_target(mesh, split)
                new = DTensor.from_local(new, mesh, target, run_check=False)
                mine.copy_(new.redistribute(mesh, leaf.placements)
                           .to_local())
        return cache, _gather_rows(logits, mesh, split)
    return step


# -- the dry run's lowering ---------------------------------------------------

def _fake_leaf(meta: torch.Tensor, spec: sh.Spec, mesh: DeviceMesh):
    """A DTensor whose local block is a fake tensor (the ambient
    ``FakeTensorMode``) of the shape ``spec`` gives this rank."""
    shape = tuple(meta.shape)
    local = torch.empty(sh.local_shape(spec, shape, mesh), dtype=meta.dtype)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, sh.placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _fake_tree(shapes, specs, mesh: DeviceMesh):
    flat = dict(sh.flat_specs(specs))
    return layers.tree_map_with_keys(
        lambda k, t: _fake_leaf(t, flat[k], mesh), shapes)


def _fake_inputs(specs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, dtype=v.dtype) for k, v in specs.items()}


@dataclasses.dataclass
class Lowered:
    """A step and its fake arguments, ready to be run once under the
    counters (:meth:`compile`)."""
    fn: Callable
    args: tuple
    fake_mode: Any
    lower_s: float

    def compile(self):
        from . import hlo_analysis
        return hlo_analysis.run_traced(self.fn, self.args, self.fake_mode)


def _lowering(build: Callable) -> Lowered:
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fn, args = build()
    return Lowered(fn, args, mode, time.perf_counter() - t0)


def lower_train(cfg: ModelConfig, mesh: DeviceMesh, batch_specs: Dict,
                optimizer: str = "adamw", microbatches: int = 1) -> Lowered:
    """The train step on ``mesh`` over fake state and inputs
    (``batch_specs``: meta tensors of the global batch, as
    ``configs.input_specs`` gives them)."""
    shapes = state_shape(cfg, optimizer)
    specs = state_shardings(cfg, mesh, optimizer, shapes)

    def build():
        params = layers.ParamTree(_fake_tree(shapes["params"],
                                             specs["params"], mesh))
        opt = _fake_tree({k: v for k, v in shapes["opt"].items()
                          if k != "count"},
                         {k: v for k, v in specs["opt"].items()
                          if k != "count"}, mesh)
        opt["count"] = torch.zeros((), dtype=torch.int32)
        state = {"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32)}
        step = build_train_step(cfg, optimizer, microbatches, device="cpu",
                                mesh=mesh)
        return step, (state, _fake_inputs(batch_specs))
    return _lowering(build)


def lower_prefill(cfg: ModelConfig, mesh: DeviceMesh,
                  batch_specs: Dict) -> Lowered:
    """The prefill step on ``mesh`` (train layout) over fake params and
    inputs."""
    shapes = params_shape(cfg)
    specs = sh.param_specs(shapes, cfg, mesh)

    def build():
        params = layers.ParamTree(_fake_tree(shapes, specs, mesh))
        step = build_prefill_step(cfg, device="cpu", mesh=mesh)
        return step, (params, _fake_inputs(batch_specs))
    return _lowering(build)


def lower_serve(cfg: ModelConfig, mesh: DeviceMesh, specs: Dict) -> Lowered:
    """One decode step on ``mesh`` (serving layout) over fake params, the
    fake cache of ``specs["cache"]`` and its inputs, at position 0 (a
    step attends over the whole cache whatever the position)."""
    shapes = params_shape(cfg)
    p_specs = sh.param_specs(shapes, cfg, mesh, serve=True)
    c_specs = sh.cache_shardings(specs["cache"], cfg, mesh)

    def build():
        params = layers.ParamTree(_fake_tree(shapes, p_specs, mesh))
        cache = _fake_tree(specs["cache"], c_specs, mesh)
        step = build_serve_step(cfg, device="cpu", mesh=mesh)
        args = [params, cache, torch.empty(specs["tokens"].shape,
                                           dtype=specs["tokens"].dtype),
                0]
        if "enc_out" in specs:
            args.append(torch.empty(specs["enc_out"].shape,
                                    dtype=specs["enc_out"].dtype))
        return step, tuple(args)
    return _lowering(build)
