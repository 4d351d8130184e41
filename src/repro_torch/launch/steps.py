"""Steps: prefill_step / serve_step for a given arch config, on
one device.

These are the functions the serving CLI executes.  Sharding over a mesh,
the train step and the ``lower_*`` dry-run functions are not ported yet
(ROADMAP); each step runs on ``device``: ``cuda`` unless the caller names
the CPU.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..exec.programs import resolve_device
from ..models import ModelConfig, serve_step
from ..models import layers
from ..models import transformer as T


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
