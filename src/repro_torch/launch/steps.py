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


def build_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill(params, batch) -> logits [B,V]`` (fp32) of the last token
    of ``batch["tokens"]`` [B,S], through the full-sequence stack: one
    flash attention call per attention layer."""
    T.check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, batch) -> torch.Tensor:
        T.check_on(params, dev)
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        x = T._embed_inputs(params, cfg, {"tokens": tokens})
        B, S, _ = x.shape
        positions = torch.arange(S, device=dev).expand(B, S)
        x, _ = T._run_stack(params, cfg, x, positions)
        x = layers.rmsnorm(params["final_norm"], x[:, -1:, :],
                           zero_centered=cfg.zero_centered_norm)
        logits = layers.unembed(T._unembed_table(params, cfg), x[:, 0, :])
        return layers.softcap(logits, cfg.final_softcap)
    return prefill


def build_serve_step(cfg: ModelConfig, device=None) -> Callable:
    """``step(params, cache, tokens, pos) -> (cache, logits)``: one decode
    step (:func:`repro_torch.models.serve_step`)."""
    T.check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        T.check_on(params, dev)
        return serve_step(params, cfg, cache,
                          torch.as_tensor(tokens, device=dev).long(), pos)
    return step
