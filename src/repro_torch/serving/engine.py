"""Batched serving engine: prefill + decode over the shared model defs.

Continuous-batching-lite: requests are admitted into fixed slots of a
[batch, max_len] KV cache; prefill teacher-forces the prompt through
``serve_step`` one token at a time, and decode steps advance all slots
together.  The full-sequence prefill on the flash kernel is
``launch.steps.build_prefill_step``.

Like the JAX engine, whose jitted step is ``serve_step(p, cfg, c, t, pos)``
with no encoder output, this engine passes ``serve_step`` no ``enc_out``
and sees no frontend: it serves an enc-dec config (seamless-m4t-large-v2)
with every cross-attention block skipped, and a vision config
(llava-next-34b) on text tokens alone (ROADMAP reference caveat 7).  The
encoder and the patches reach the model through ``build_prefill_step``
and through ``build_serve_step``'s ``enc_out``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..exec.programs import resolve_device
from ..models import ModelConfig, init_cache, serve_step
from ..models.transformer import check_on


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 1024
    temperature: float = 0.0       # 0 → greedy


class ServingEngine:
    """Serves ``params`` (a :class:`~repro_torch.models.layers.ParamTree`
    on ``device``: ``cuda`` unless the caller names the CPU)."""

    def __init__(self, params, model_cfg: ModelConfig, cfg: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        check_on(params, self.device)
        self.params = params
        self.mcfg = model_cfg
        self.cfg = cfg
        self.cache = init_cache(model_cfg, cfg.batch_slots, cfg.max_len,
                                self.device)

    def _step(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        self.cache, logits = serve_step(self.params, self.mcfg, self.cache,
                                        tokens, pos)
        return logits

    @torch.no_grad()
    def prefill(self, prompts: np.ndarray) -> Tuple[torch.Tensor, int]:
        """prompts: [batch_slots, P] int.  Sequentially decodes the prompt
        into the cache (teacher forcing); returns the logits after the last
        token and P."""
        toks = torch.as_tensor(np.asarray(prompts, np.int64),
                               device=self.device)
        P = toks.shape[1]
        logits = None
        for t in range(P):
            logits = self._step(toks[:, t:t + 1], t)
        return logits, P

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int = 32,
                 gen: Optional[torch.Generator] = None) -> np.ndarray:
        """[batch_slots, max_new] int32 tokens after ``prompts``: greedy at
        temperature 0 or without ``gen``, else sampled from ``gen``."""
        logits, pos = self.prefill(prompts)
        outs: List[torch.Tensor] = []
        tok = self._sample(logits, gen)
        for i in range(max_new):
            outs.append(tok)
            logits = self._step(tok[:, None].long(), pos + i)
            tok = self._sample(logits, gen)
        return torch.stack(outs, dim=1).cpu().numpy()

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        if self.cfg.temperature <= 0.0 or gen is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)
