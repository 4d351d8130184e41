"""Steps: train_step / prefill_step / serve_step for a given arch config,
on one device.

These are the functions the training and serving CLIs execute, for every
arch of ``configs`` (the recurrent ones train too).  Sharding over a mesh
and the ``lower_*`` dry-run functions are not ported yet (ROADMAP Queue 1
item 8); each step runs on ``device``: ``cuda`` unless the caller names
the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..exec.programs import resolve_device
from ..models import ModelConfig, init_params, serve_step
from ..models import layers
from ..models import transformer as T
from ..optim import (AdafactorConfig, AdamWConfig, adafactor_init,
                     adafactor_update, adamw_init, adamw_update)

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


def build_train_step(cfg: ModelConfig, optimizer: str = "adamw",
                     microbatches: int = 1, device=None) -> Callable:
    """``step(state, batch) -> (state, {"loss"})``: the JAX package's
    ``build_train_step`` with no mesh.  The gradient of ``train_loss``
    comes from ``torch.autograd``; with ``microbatches > 1`` the batch is
    split along its leading axis and the gradients accumulated (fp32 with
    AdamW, bf16 with Adafactor, as JAX chose for state size) and
    averaged.  The optimizer (JAX's default config) updates the params
    and moments in place; the returned state drops AdamW's ``grad_norm``.
    The flash kernel runs ``transformer.train_flash_launches(cfg)`` times
    a microbatch."""
    _check_optimizer(optimizer)
    T.check_supported(cfg)
    dev = resolve_device(device)
    opt_cfg = AdamWConfig() if optimizer == "adamw" else AdafactorConfig()
    acc_dtype = torch.float32 if optimizer == "adamw" else torch.bfloat16

    def value_and_grad(params, leaves, batch):
        loss = T.train_loss(params, cfg, batch)
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
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=dev)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = value_and_grad(params, leaves, part)
                for a, gi in zip(acc, g):
                    a.add_(gi.to(acc_dtype))
                loss = loss + l
                del g
            grads = [a / microbatches for a in acc]
            loss = loss / microbatches
        else:
            loss, grads = value_and_grad(params, leaves, batch)
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


def build_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill(params, batch) -> logits [B,V]`` (fp32) of the last
    position, through the full-sequence stack: ``batch["tokens"]`` [B,St];
    for the vision frontend also ``batch["frontend"]`` [B,P,D], patch
    embeddings prepended to the tokens; for an enc-dec config also
    ``batch["src"]`` [B,Senc,D], frame embeddings the encoder runs over
    (positions ``arange(Senc)``) before the decoder attends to its output.
    Each float input is cast to ``cfg.dtype``.  The flash kernel runs
    :func:`~repro_torch.models.transformer.prefill_flash_launches` times."""
    T.check_supported(cfg)
    dev = resolve_device(device)

    def as_float(a) -> torch.Tensor:
        return torch.as_tensor(a, device=dev).to(cfg.dtype)

    @torch.no_grad()
    def prefill(params, batch) -> torch.Tensor:
        T.check_on(params, dev)
        inputs = {"tokens": torch.as_tensor(batch["tokens"],
                                            device=dev).long()}
        if cfg.frontend == "vision":
            inputs["frontend"] = as_float(batch["frontend"])
        x = T._embed_inputs(params, cfg, inputs)
        B, S, _ = x.shape
        positions = torch.arange(S, device=dev).expand(B, S)
        enc_out = None
        if cfg.arch == "encdec":
            enc_out = encode(params, cfg, torch.as_tensor(batch["src"],
                                                          device=dev))
        x, _ = T._run_stack(params, cfg, x, positions, enc_out)
        x = layers.rmsnorm(params["final_norm"], x[:, -1:, :],
                           zero_centered=cfg.zero_centered_norm)
        logits = layers.unembed(T._unembed_table(params, cfg), x[:, 0, :])
        return layers.softcap(logits, cfg.final_softcap)
    return prefill


def build_serve_step(cfg: ModelConfig, device=None) -> Callable:
    """``step(params, cache, tokens, pos, enc_out=None) -> (cache,
    logits)``: one decode step (:func:`repro_torch.models.serve_step`);
    an enc-dec config's cross blocks attend to ``enc_out`` [B,Senc,D]."""
    T.check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, cache, tokens, pos, enc_out=None):
        T.check_on(params, dev)
        return serve_step(params, cfg, cache,
                          torch.as_tensor(tokens, device=dev).long(), pos,
                          enc_out=enc_out)
    return step
