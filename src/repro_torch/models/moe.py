"""Mixture-of-Experts FFN — DeepSeek-V2/V3 style: fine-grained routed experts
(top-k, optionally aux-loss-free bias routing) + shared experts.

Dispatch is capacity-based, as in JAX: each group (a batch row) gives each
expert ``C = max(1, int(S·k/E·capacity_factor))`` slots, filled in token
order (a stable sort on the expert id ranks the slots), and the slots past
``C`` are dropped and add nothing.  Activations move by a gather into an
[E, G·C, D] buffer and back by a gather of each token's k slots, summed
in fp32 in a fixed order (``combine``: the CPU's ``index_add_`` bits, on
every run on the card too, which a scatter-add's atomics do not give); no
[T, E, C] one-hot is built.
The buffer is laid out expert-major, so the expert products are one
batched matmul each (JAX computes them outside any Pallas kernel too).
The router is fp32 whatever the model's dtype.

``update_router_bias`` (aux-loss-free balancing) runs in training and waits
for it (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import layers
from .ffn import FFNConfig, ffn_forward, init_ffn

#: The leaves the router keeps in fp32 whatever ``param_dtype`` is.
FP32_LEAVES = frozenset({"router_de", "router_bias_e"})


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    num_experts: int
    top_k: int
    num_shared: int = 1               # shared experts (DeepSeek)
    capacity_factor: float = 1.25
    activation: str = "silu"
    aux_loss_free: bool = True        # DeepSeek-V3 bias-based balancing
    router_softcap: Optional[float] = None
    aux_loss_weight: float = 0.001


def _shared_cfg(cfg: MoEConfig) -> FFNConfig:
    return FFNConfig(cfg.d_model, cfg.d_ff_expert * cfg.num_shared,
                     cfg.activation)


def _expert_init(gen: torch.Generator, E: int, i: int, o: int,
                 dtype) -> torch.Tensor:
    """[E, i, o] of N(0, 1/i), drawn one expert at a time in fp32 so that
    no fp32 copy of the whole stack exists (deepseek-v3's is 3.76 G
    elements a tensor)."""
    out = torch.empty((E, i, o), dtype=dtype, device=gen.device)
    scale = 1.0 / math.sqrt(i)
    for e in range(E):
        out[e] = torch.randn((i, o), generator=gen, device=gen.device) * scale
    return out


def init_moe(gen: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router_de": layers.dense_init(gen, D, E, torch.float32),
        "router_bias_e": torch.zeros((E,), dtype=torch.float32,
                                     device=gen.device),
        "wi_edf": _expert_init(gen, E, D, F, dtype),
        "wg_edf": _expert_init(gen, E, D, F, dtype),
        "wo_efd": _expert_init(gen, E, F, D, dtype),
    }
    if cfg.num_shared:
        p["shared"] = init_ffn(gen, _shared_cfg(cfg), dtype)
    return p


def param_count(cfg: MoEConfig) -> int:
    """Leaves of :func:`init_moe`'s tree."""
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    return D * E + E + 3 * E * D * F + 3 * D * F * cfg.num_shared


def capacity(cfg: MoEConfig, S: int) -> int:
    """Slots per (group, expert) for groups of ``S`` tokens."""
    return max(1, int(S * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))


def _route(params, cfg: MoEConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (top-k expert ids [G,S,k], combine weights [G,S,k] in x's
    dtype, aux loss).  Ties go to the lower expert id, as
    ``jax.lax.top_k`` breaks them."""
    logits = torch.einsum("gsd,de->gse", x.float(),
                          params["router_de"].float())
    logits = layers.softcap(logits, cfg.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    select = logits + params["router_bias_e"] if cfg.aux_loss_free \
        else logits
    idx = torch.sort(select, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.top_k]     # [G,S,k]
    w = torch.gather(probs, -1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss (kept in aux-free mode as a
    # monitored metric); ce from a histogram of the choices.
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros(cfg.num_experts, dtype=torch.float32,
                         device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    aux = cfg.num_experts * torch.sum(me * counts / idx.numel())
    return idx, w.to(x.dtype), aux


def slot_positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Position of each slot [G, S·k] (token-major, then choice) in its
    expert's queue: the number of earlier slots of the group with the same
    expert, from a stable sort on the expert id."""
    G, n = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(dim=1) - counts
    pos_sorted = (torch.arange(n, device=flat_e.device)[None, :]
                  - torch.gather(starts, 1, sorted_e))
    return torch.empty_like(flat_e).scatter_(1, order, pos_sorted)


def combine(contrib: torch.Tensor, slot_of: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """y [G, S, D]: each token's kept slots (``slot_of`` [G, S, k], rows of
    ``contrib`` [E·G·C, D]; a dropped slot's E·G·C reads a zero row) added
    to an fp32 zero in ascending expert id (``idx`` [G, S, k]), rounded
    once to ``contrib``'s dtype.  That is the order and the rounding of the
    CPU's ``index_add_`` over the expert-major buffer, so its bits; the
    card's ``index_add_`` adds by atomics, in an order that changes from
    run to run."""
    G, S, k = idx.shape
    D = contrib.shape[-1]
    rows = torch.cat([contrib, contrib.new_zeros((1, D))])
    slots = torch.gather(slot_of, 2, torch.argsort(idx, dim=-1))
    y = torch.zeros((G, S, D), dtype=torch.float32, device=contrib.device)
    for j in range(k):
        y += rows[slots[..., j]]
    return y.to(contrib.dtype)


def moe_forward(params, cfg: MoEConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, S, D] (G = token groups: the batch rows).  Returns
    (y, aux_loss)."""
    G, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    dev = x.device
    idx, w, aux = _route(params, cfg, x)

    flat_e = idx.reshape(G, S * k)
    pos = slot_positions(flat_e, E)
    keep = pos < C                                        # capacity drops
    g = torch.arange(G, device=dev)[:, None].expand(G, S * k)
    # Rows of x_pad [G·(S+1), D]: token s of group g at g·(S+1) + s, the
    # group's zero pad row at g·(S+1) + S.
    src = g * (S + 1) + torch.arange(S * k, device=dev)[None, :] // k
    # Each slot's place in the [E, G, C] buffer, flat; a dropped slot's is
    # E·G·C, which the combine reads as a zero row.
    slot_of = torch.where(keep, (flat_e * G + g) * C + pos, E * G * C)
    dest = slot_of[keep]
    slot = torch.arange(E * G * C, device=dev)
    buf_src = (slot // C % G) * (S + 1) + S               # empty: the pad row
    buf_src[dest] = src[keep]
    w_buf = torch.zeros(E * G * C, dtype=torch.float32, device=dev)
    w_buf[dest] = w.reshape(G, S * k)[keep].float()

    x_pad = torch.cat([x, x.new_zeros((G, 1, D))], dim=1).reshape(-1, D)
    xe = x_pad[buf_src].view(E, G * C, D)
    h = torch.bmm(xe, params["wi_edf"])
    h = layers.act_fn(cfg.activation)(torch.bmm(xe, params["wg_edf"])) * h
    ye = torch.bmm(h, params["wo_efd"])                   # [E, G·C, D]
    contrib = ye * w_buf.view(E, G * C, 1).to(ye.dtype)
    y = combine(contrib.view(-1, D), slot_of.view(G, S, k), idx)

    if cfg.num_shared:
        y = y + ffn_forward(params["shared"], _shared_cfg(cfg), x)
    return y.to(x.dtype), aux
