"""Recurrent / linear-attention blocks: Griffin RG-LRU (recurrentgemma) and
xLSTM's mLSTM / sLSTM cells.

The JAX package computes all three in ``jnp`` (no Pallas kernel), so the
port is plain PyTorch with the same names, parameter keys and dtypes:

- RG-LRU is an elementwise linear recurrence.  The prefill runs it as a
  log-depth doubling scan (``ceil(log2 S)`` passes; JAX's
  ``associative_scan``), differentiable through a
  ``torch.autograd.Function`` whose backward is the same scan run in
  reverse; decode runs the explicit step loop (``rglru_scan_ref``).
- mLSTM has a matrix state with scalar gates: the prefill runs the
  chunked-parallel form (quadratic within a chunk, a scan carrying
  (C, n, m) across chunks), decode the recurrent step.
- sLSTM's gates read x alone, so its recurrence is per element: decode
  runs the step loop; the prefill runs the stabilizer's loop (two
  operations a step, a ``torch.autograd.Function``) and then the cell and
  normalizer states as one doubling scan.

Where JAX asks an einsum for ``preferred_element_type=float32`` on bf16
operands, the port multiplies the fp32 copies (products of bf16 values are
exact in fp32); where it does not, the product stays in the operands'
dtype.  The recurrent states are fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers

#: The leaves JAX keeps in fp32 whatever the model's dtype.
FP32_LEAVES = frozenset({"lambda_r", "w_if_ih", "wi_dd", "wf_dd"})


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) without ``F.softplus``'s linear
    cut-over past 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


# =============================================================================
# Griffin RG-LRU recurrent block (arXiv:2402.19427 §2.4)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int            # recurrence width (Griffin: ~4/3 d_model -> here d)
    conv_width: int = 4
    c_const: float = 8.0


def init_rglru(gen: torch.Generator, cfg: RGLRUConfig,
               dtype=torch.float32) -> dict:
    D, R, dev = cfg.d_model, cfg.d_rnn, gen.device
    # Λ init so that a = exp(-c·softplus(Λ)·σ(r)) starts near 0.9..0.999.
    lam = torch.rand((R,), generator=gen, device=dev) * 0.8 + 0.1
    lam = torch.log(torch.expm1(-torch.log(lam) / cfg.c_const))
    return {
        "wx_dr": layers.dense_init(gen, D, R, dtype),
        "wgate_dr": layers.dense_init(gen, D, R, dtype),
        "conv_wr": (torch.randn((cfg.conv_width, R), generator=gen,
                                device=dev)
                    / math.sqrt(cfg.conv_width)).to(dtype),
        "w_input_gate_rr": layers.dense_init(gen, R, R, dtype),
        "w_rec_gate_rr": layers.dense_init(gen, R, R, dtype),
        "lambda_r": lam,
        "wo_rd": layers.dense_init(gen, R, D, dtype),
    }


def rglru_param_count(cfg: RGLRUConfig) -> int:
    """Leaves of :func:`init_rglru`'s tree."""
    D, R = cfg.d_model, cfg.d_rnn
    return 3 * D * R + cfg.conv_width * R + 2 * R * R + R


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: [B,S,R]; w: [W,R].  Returns (y, new_state)
    where state is the last W-1 inputs for streaming decode.  Sums in JAX's
    order, each term and partial sum in x's dtype."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S, :] * w[i]
    return y, xp[:, -(W - 1):, :] if W > 1 else state


def _doubling_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + bx_t (h_0 = 0) along axis 1: ceil(log2 S)
    passes over clones of the operands, each combining every position with
    the one ``off`` before it and updating positions ``off..S-1`` in place
    from a product taken before the write."""
    S = a.shape[1]
    a, h = a.clone(), bx.clone()
    off = 1
    while off < S:
        h[:, off:] += a[:, off:] * h[:, :-off]
        if 2 * off < S:
            a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return h


class RGLRUScanFn(torch.autograd.Function):
    """The doubling scan under autograd.  The forward records no graph and
    keeps only ``a`` and ``h``.  The backward of h_t = a_t h_{t-1} + bx_t
    is the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}: the same
    doubling scan over the time-reversed dh and a shifted by one step.
    Then d bx = g and d a_t = g_t h_{t-1} (h_{-1} = 0)."""

    @staticmethod
    def forward(ctx, a, bx):
        h = _doubling_scan(a, bx)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = _doubling_scan(a_next.flip(1), dh.flip(1)).flip(1)
        da = None
        if ctx.needs_input_grad[0]:
            da = g * torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return da, g if ctx.needs_input_grad[1] else None


def rglru_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + bx_t (h_0 = 0) along axis 1, as a log-depth
    doubling scan (JAX's ``associative_scan``); differentiable through
    :class:`RGLRUScanFn`."""
    return RGLRUScanFn.apply(a, bx)


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`rglru_scan`: the step loop from ``h0``
    (zeros when None), under ordinary autograd.  Decode runs it too.  It
    steps over ``unbind`` views, whose backward stacks the steps'
    gradients once; indexing ``[:, t]`` would add a full-size gradient at
    every step (O(S²) traffic)."""
    h = torch.zeros_like(bx[:, 0]) if h0 is None else h0
    hs = []
    for a_t, b_t in zip(a.unbind(1), bx.unbind(1)):
        h = a_t * h + b_t
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_forward(params, cfg: RGLRUConfig, x: torch.Tensor,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Griffin recurrent block body.  x: [B,S,D] → [B,S,D].

    state (decode): {"conv": [B,W-1,R], "h": [B,R]} or None (prefill).
    """
    gate = layers.act_fn("gelu")(x @ params["wgate_dr"])
    u = x @ params["wx_dr"]
    conv_state = state["conv"] if state else None
    u, new_conv = _causal_conv1d(u, params["conv_wr"], conv_state)

    r = torch.sigmoid(u @ params["w_rec_gate_rr"])
    i = torch.sigmoid(u @ params["w_input_gate_rr"])
    # The recurrence runs in fp32; the output is cast back to x's dtype.
    log_a = -cfg.c_const * softplus(params["lambda_r"]) * r.float()
    a = torch.exp(log_a)
    gated_x = (u * i).float()
    # sqrt(1-a^2) input normalization (Griffin eq. 4), fp32 for stability.
    bx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)
                    ) * gated_x
    if state is not None:
        h = rglru_scan_ref(a, bx, state["h"].float())
        new_state = {"conv": new_conv.to(state["conv"].dtype),
                     "h": h[:, -1].to(state["h"].dtype)}
    else:
        h = rglru_scan(a, bx)
        new_state = None
    y = (h * gate.float()).to(x.dtype) @ params["wo_rd"]
    return y, new_state


def init_rglru_state(cfg: RGLRUConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.d_rnn), dtype=dtype, device=device)}


# =============================================================================
# xLSTM mLSTM — matrix-memory cell with exponential gating
# (arXiv:2405.04517 §2.3), chunked-parallel prefill form.
# =============================================================================

@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    num_heads: int
    proj_factor: float = 2.0
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.num_heads


def init_mlstm(gen: torch.Generator, cfg: MLSTMConfig,
               dtype=torch.float32) -> dict:
    D, DI, H, hd = cfg.d_model, cfg.d_inner, cfg.num_heads, cfg.head_dim

    # q/k/v are BLOCK-DIAGONAL per head (xLSTM §4: di²/H params each).
    def bd():
        return torch.stack([layers.dense_init(gen, hd, hd, dtype)
                            for _ in range(H)])
    return {
        "w_up_di": layers.dense_init(gen, D, DI, dtype),
        "w_gate_di": layers.dense_init(gen, D, DI, dtype),
        "wq_hkk": bd(),            # [H, hd, hd]
        "wk_hkk": bd(),
        "wv_hkk": bd(),
        "w_if_ih": layers.dense_init(gen, DI, 2 * H, torch.float32),
        "norm": layers.rmsnorm_init(DI, dtype, gen.device),
        "w_down_id": layers.dense_init(gen, DI, D, dtype),
    }


def mlstm_param_count(cfg: MLSTMConfig) -> int:
    """Leaves of :func:`init_mlstm`'s tree."""
    D, DI, H, hd = cfg.d_model, cfg.d_inner, cfg.num_heads, cfg.head_dim
    return 3 * D * DI + 3 * H * hd * hd + 2 * H * DI + DI


def _mlstm_attention_chunk(q, k, v, log_f, log_i):
    """Stabilized intra-chunk quadratic mLSTM (matrix D form).

    q,k,v: [B,H,C,hd]; log_f/log_i: [B,H,C] (log forget/input gates).
    Returns numerator [B,H,C,hd], denominator [B,H,C], the stabilizer
    [B,H,C] and the cumulative log forget gate [B,H,C].
    """
    C = q.shape[2]
    cum_f = torch.cumsum(log_f, dim=-1)                     # [B,H,C]
    # D[t,s] = exp(cum_f[t]-cum_f[s] + log_i[s]) for s<=t
    dmat = (cum_f[..., :, None] - cum_f[..., None, :]
            + log_i[..., None, :])
    mask = torch.ones((C, C), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~mask, float("-inf"))
    m = torch.clamp_min(dmat.amax(dim=-1, keepdim=True), -1e30)
    dexp = torch.exp(dmat - m)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = s * dexp
    num = w.to(v.dtype).float() @ v.float()
    den = w.sum(dim=-1)              # [B,H,C] — signed; abs after combine
    return num, den, m[..., 0], cum_f


def _mlstm_chunk_step(carry, qc, kc, vc, lic, lfc, scale):
    """One chunk of the prefill scan: the outputs of its positions and the
    carried (C, n, m) at its end."""
    Cc, nc, mc = carry
    num_i, den_i, m_i, cum_f = _mlstm_attention_chunk(qc, kc, vc, lfc, lic)
    # Inter-chunk: contribution of the carried state to each position.
    m_comb = torch.maximum(m_i, cum_f + mc[..., None])      # [B,H,C]
    w_prev = torch.exp(cum_f + mc[..., None] - m_comb)
    w_intra = torch.exp(m_i - m_comb)
    qs = (qc * scale).float()
    num_prev = qs @ Cc.transpose(-1, -2)
    den_prev = (qs * nc[..., None, :]).sum(dim=-1)
    num = w_prev[..., None] * num_prev + w_intra[..., None] * num_i
    den = torch.abs(w_prev * den_prev + w_intra * den_i)
    h = num / torch.maximum(den, torch.exp(-m_comb))[..., None]
    # The carried state at the chunk's end.
    tot_f = cum_f[..., -1:]                                 # [B,H,1]
    m_new = torch.maximum(tot_f[..., 0] + mc,
                          (tot_f - cum_f + lic).amax(dim=-1))
    decay_old = torch.exp(tot_f[..., 0] + mc - m_new)[..., None]
    wk = torch.exp(tot_f - cum_f + lic - m_new[..., None])  # [B,H,C]
    wkk = wk[..., None] * kc.float()                        # [B,H,C,hd]
    Cn = (decay_old[..., None] * Cc
          + vc.float().transpose(-1, -2) @ wkk)
    nn_ = decay_old * nc + wkk.sum(dim=-2)
    return (Cn, nn_, m_new), h


def mlstm_forward(params, cfg: MLSTMConfig, x: torch.Tensor,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B,S,D].  Prefill: chunked parallel over S; decode: recurrent."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    up = x @ params["w_up_di"]
    gate = F.silu(x @ params["w_gate_di"])
    up_h = up.view(B, S, H, hd)
    q = torch.einsum("bshk,hkq->bhsq", up_h, params["wq_hkk"])
    k = torch.einsum("bshk,hkq->bhsq", up_h, params["wk_hkk"])
    v = torch.einsum("bshk,hkq->bhsq", up_h, params["wv_hkk"])
    if_gates = up.float() @ params["w_if_ih"]
    log_i = if_gates[..., :H].transpose(1, 2)               # [B,H,S]
    log_f = F.logsigmoid(if_gates[..., H:]).transpose(1, 2)
    scale = 1.0 / math.sqrt(hd)

    if state is not None:
        # Recurrent decode: C_t = f C + i v k^T ; n_t = f n + i k.
        Cc, nc, mc = state["C"], state["n"], state["m"]
        hs = []
        for t in range(S):
            q_t, k_t, v_t = q[:, :, t], k[:, :, t], v[:, :, t]
            li, lf = log_i[..., t], log_f[..., t]
            m_new = torch.maximum(lf + mc, li)
            fg = torch.exp(lf + mc - m_new)[..., None]
            ig = torch.exp(li - m_new)[..., None]
            Cc = fg[..., None] * Cc + ig[..., None] * (
                v_t[..., :, None] * k_t[..., None, :])
            nc = fg * nc + ig * k_t
            qs = (q_t * scale).float()
            num = (Cc @ qs[..., None])[..., 0]
            den = torch.abs((nc * qs).sum(dim=-1))
            hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
            mc = m_new
        h = torch.stack(hs, dim=2)                          # [B,H,S,hd]
        new_state = {"C": Cc, "n": nc, "m": mc}
    else:
        Cch = min(cfg.chunk, S)
        if S % Cch:
            raise ValueError(f"mlstm_forward: the sequence length {S} is "
                             f"not a multiple of the chunk {Cch}")
        carry = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=x.device),
                 torch.zeros((B, H, hd), dtype=torch.float32,
                             device=x.device),
                 torch.full((B, H), -1e30, dtype=torch.float32,
                            device=x.device))
        hs = []
        for c0 in range(0, S, Cch):
            cs = slice(c0, c0 + Cch)
            carry, h_c = _mlstm_chunk_step(
                carry, q[:, :, cs], k[:, :, cs], v[:, :, cs],
                log_i[..., cs], log_f[..., cs], scale)
            hs.append(h_c)
        h = torch.cat(hs, dim=2)                            # [B,H,S,hd]
        new_state = None
    h = h.transpose(1, 2).reshape(B, S, cfg.d_inner).to(x.dtype)
    h = layers.rmsnorm(params["norm"], h) * gate
    return h @ params["w_down_id"], new_state


def init_mlstm_state(cfg: MLSTMConfig, batch: int, device=None) -> dict:
    H, hd = cfg.num_heads, cfg.head_dim
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, H), -1e30, dtype=torch.float32,
                            device=device)}


# =============================================================================
# xLSTM sLSTM — scalar-memory cell with normalizer recurrence
# (arXiv:2405.04517 §2.2): the stabilizer's loop, then a linear scan
# =============================================================================

@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    num_heads: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def init_slstm(gen: torch.Generator, cfg: SLSTMConfig,
               dtype=torch.float32) -> dict:
    D = cfg.d_model
    return {
        "wz_dd": layers.dense_init(gen, D, D, dtype),
        "wi_dd": layers.dense_init(gen, D, D, torch.float32),
        "wf_dd": layers.dense_init(gen, D, D, torch.float32),
        "wo_dd": layers.dense_init(gen, D, D, dtype),
        "norm": layers.rmsnorm_init(D, dtype, gen.device),
        "w_out_dd": layers.dense_init(gen, D, D, dtype),
    }


def slstm_param_count(cfg: SLSTMConfig) -> int:
    """Leaves of :func:`init_slstm`'s tree."""
    return 5 * cfg.d_model ** 2 + cfg.d_model


class SLSTMStabilizerFn(torch.autograd.Function):
    """sLSTM's stabilizer m_t = max(lf_t + m_{t-1}, li_t) from ``m0``,
    along axis 1 ([B,S,D] → [B,S,D]).  The forward is the step loop with
    no graph recorded (two operations a step, the loop's bits); it keeps
    w_t = ∂m_t/∂m_{t-1} = ∂m_t/∂lf_t, which is 1 where the forget path
    wins, 0 where the input gate does and ½ on a tie (``torch.maximum``'s
    and ``jnp.maximum``'s gradient).  The backward is the reverse scan
    G_t = dm_t + w_{t+1} G_{t+1}, then d lf = w G, d li = (1 − w) G and
    d m0 = w_0 G_0."""

    @staticmethod
    def forward(ctx, log_f, log_i, m0):
        m, ms = m0, []
        for lf, li in zip(log_f.unbind(1), log_i.unbind(1)):
            m = torch.maximum(lf + m, li)
            ms.append(m)
        m_all = torch.stack(ms, dim=1)
        fm = log_f + torch.cat([m0[:, None], m_all[:, :-1]], dim=1)
        w = (fm > log_i).to(fm.dtype) + 0.5 * (fm == log_i).to(fm.dtype)
        ctx.save_for_backward(w)
        return m_all

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dm):
        (w,) = ctx.saved_tensors
        w_next = torch.cat([w[:, 1:], torch.zeros_like(w[:, :1])], dim=1)
        g = _doubling_scan(w_next.flip(1), dm.flip(1)).flip(1)
        return w * g, (1 - w) * g, w[:, 0] * g[:, 0]


def slstm_forward(params, cfg: SLSTMConfig, x: torch.Tensor,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B,S,D].  The gates read x alone, so the recurrence is per
    element.  Decode (``state``) runs the step loop.  The prefill runs
    the stabilizer m's loop (:class:`SLSTMStabilizerFn`) and then, from
    the gates fg_t = exp(lf_t + m_{t-1} − m_t) and ig_t = exp(li_t − m_t)
    that it fixes (the loop's bits), the two linear recurrences
    c_t = fg_t c_{t-1} + ig_t z_t and n_t = fg_t n_{t-1} + ig_t as one
    doubling scan (:func:`rglru_scan`): two operations a time step in
    place of the loop's thirteen, and none under autograd."""
    B, _, D = x.shape
    z = torch.tanh(x @ params["wz_dd"]).float()
    o = torch.sigmoid(x @ params["wo_dd"])
    x32 = x.float()
    log_i = x32 @ params["wi_dd"]
    log_f = F.logsigmoid(x32 @ params["wf_dd"])

    if state is None:
        m0 = torch.full((B, D), -1e30, dtype=torch.float32, device=x.device)
        m = SLSTMStabilizerFn.apply(log_f, log_i, m0)
        fg = torch.exp(log_f + torch.cat([m0[:, None], m[:, :-1]], dim=1)
                       - m)
        ig = torch.exp(log_i - m)
        cn = rglru_scan(torch.cat([fg, fg]), torch.cat([ig * z, ig]))
        c, n = cn[:B], cn[B:]
        h = c / torch.clamp_min(n, 1.0)
        new_state = None
    else:
        c, n, m = state["c"], state["n"], state["m"]
        hs = []
        for li, lf, zt in zip(log_i.unbind(1), log_f.unbind(1),
                              z.unbind(1)):
            fm = lf + m
            m_new = torch.maximum(fm, li)
            fg = torch.exp(fm - m_new)
            ig = torch.exp(li - m_new)
            c = fg * c + ig * zt
            n = fg * n + ig
            hs.append(c / torch.clamp_min(n, 1.0))
            m = m_new
        h = torch.stack(hs, dim=1)
        new_state = {"c": c, "n": n, "m": m}
    h = layers.rmsnorm(params["norm"], h.to(x.dtype) * o)
    return h @ params["w_out_dd"], new_state


def init_slstm_state(cfg: SLSTMConfig, batch: int, device=None) -> dict:
    D = cfg.d_model
    return {"c": torch.zeros((batch, D), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, D), dtype=torch.float32, device=device),
            "m": torch.full((batch, D), -1e30, dtype=torch.float32,
                            device=device)}
