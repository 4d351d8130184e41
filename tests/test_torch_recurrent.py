"""The port's recurrent mixers (``repro_torch.models.recurrent``: Griffin's
RG-LRU, xLSTM's mLSTM and sLSTM) against the JAX package's on the CPU, on
the same numpy inputs and the same weights (JAX's initialisers carried
over by ``tree_from_numpy``, which keeps ``recurrent.FP32_LEAVES`` fp32).

In fp32 every output and every recurrent state is held within 1e-5 of
its largest magnitude (at least 1): the prefill form (RG-LRU's doubling
scan against JAX's ``associative_scan``, mLSTM's chunk scan at S below
one chunk, one chunk and four chunks, sLSTM's loop) and the decode form
over several steps from ``init_*_state``.

Under autograd (training): RG-LRU's scan (``RGLRUScanFn``: the doubling
scan forward, the reverse scan backward) against ``jax.vjp`` of JAX's
``associative_scan`` and against autograd of the step loop
(``rglru_scan_ref``), and by ``gradcheck`` in fp64; each mixer's
prefill-path gradient with respect to x and to every leaf against
``jax.grad`` (mLSTM over four chunks): x's within 1e-5 of its scale,
each leaf within 1e-4 of its norm.  sLSTM's prefill form (the
stabilizer's Function, then the scan) against its decode loop, forward
and gradient, and the stabilizer's gradient on planted ties against
autograd of its loop.

One bf16 case per cell holds the port's bf16 output (prefill, and a decode
step with its fp32 state) to JAX's within ``BF16_TOL`` of the output's
scale.  Both round at the same places, but XLA's bf16 products on the
CPU and torch's land one bf16 step apart in about 60% of the elements,
so that case reads about 6e-3 whatever the products' rounding.  The
rounding that JAX's ``preferred_element_type=float32`` asks for (fp32
sums of exact products of bf16 values) is held where it shows: mLSTM's
chunk on the same bf16 q, k, v within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch.models import recurrent as rec
from repro_torch.models.convert import tree_from_numpy

from _torch_parity import np_tree, scaled_err

TOL = 1e-5
LEAF_TOL = 1e-4
#: bf16 outputs: a few bf16 steps (2^-8 relative) of the output's scale.
BF16_TOL = 2e-2
D, B = 32, 2


def _rand(*shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * scale


def _params(init, jcfg, seed, dtype=jnp.float32):
    jp = init(jax.random.PRNGKey(seed), jcfg, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jp, tree_from_numpy(np_tree(jp), tdt, device="cpu")


def _state_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == torch.float32, key
        assert got[key].shape == tuple(want[key].shape), key
    return max(scaled_err(got[key], want[key]) for key in got)


# -- RG-LRU -------------------------------------------------------------------

RG = dict(d_model=D, d_rnn=24)


@pytest.mark.parametrize("S", [13, 16, 1])
def test_rglru_scan_matches_jax(S):
    """The doubling scan (ceil(log2 S) passes) against JAX's associative
    scan, at an S that is not a power of two, one that is, and 1."""
    a = np.random.default_rng(0).uniform(0.5, 1.0, (B, S, 24)).astype(
        np.float32)
    bx = _rand(B, S, 24, seed=1)
    want = jrec.rglru_scan(jnp.asarray(a), jnp.asarray(bx))
    got = rec.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    assert scaled_err(got, want) <= TOL
    # And the recurrence itself, step by step.
    h, ref = np.zeros((B, 24), np.float32), []
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        ref.append(h)
    assert scaled_err(got, np.stack(ref, 1)) <= TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    x, w = _rand(B, 7, 24), _rand(4, 24, seed=1)
    state = _rand(B, 3, 24, seed=2) if with_state else None
    jy, jst = jrec._causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    y, st = rec._causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if state is None else torch.from_numpy(state))
    assert scaled_err(y, jy) <= TOL
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


def test_rglru_prefill_matches_jax():
    jcfg, cfg = jrec.RGLRUConfig(**RG), rec.RGLRUConfig(**RG)
    jp, p = _params(jrec.init_rglru, jcfg, 1)
    x = _rand(B, 13, D, seed=3)
    want, jst = jrec.rglru_forward(jp, jcfg, jnp.asarray(x))
    got, st = rec.rglru_forward(p, cfg, torch.from_numpy(x))
    assert jst is None and st is None
    assert got.shape == (B, 13, D)
    assert scaled_err(got, want) <= TOL


def test_rglru_decode_matches_jax():
    """Six one-token steps, then one of three tokens, from
    ``init_rglru_state``: outputs and (conv, h) equal to JAX's."""
    jcfg, cfg = jrec.RGLRUConfig(**RG), rec.RGLRUConfig(**RG)
    jp, p = _params(jrec.init_rglru, jcfg, 2)
    jst = jrec.init_rglru_state(jcfg, B)
    st = rec.init_rglru_state(cfg, B)
    assert _state_err(st, jst) == 0.0
    xs = _rand(9, B, 1, D, seed=4)
    for t0, t1 in [(t, t + 1) for t in range(6)] + [(6, 9)]:
        x = np.concatenate(list(xs[t0:t1]), axis=1)
        want, jst = jrec.rglru_forward(jp, jcfg, jnp.asarray(x), jst)
        got, st = rec.rglru_forward(p, cfg, torch.from_numpy(x), st)
        assert scaled_err(got, want) <= TOL
        assert _state_err(st, jst) <= TOL


def test_rglru_prefill_equals_decode():
    """The doubling scan and the step loop give one recurrence."""
    cfg = rec.RGLRUConfig(**RG)
    p = rec.init_rglru(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_rand(B, 11, D, seed=5))
    full, _ = rec.rglru_forward(p, cfg, x)
    stepped, _ = rec.rglru_forward(p, cfg, x, rec.init_rglru_state(cfg, B))
    assert scaled_err(stepped, full.numpy()) <= TOL


# -- mLSTM --------------------------------------------------------------------

ML = dict(d_model=D, num_heads=4, proj_factor=2.0, chunk=8)


@pytest.mark.parametrize("S", [8, 32, 5])
def test_mlstm_prefill_matches_jax(S):
    """S of one chunk, of four (the (C, n, m) carry crosses three chunk
    boundaries) and below one chunk."""
    jcfg, cfg = jrec.MLSTMConfig(**ML), rec.MLSTMConfig(**ML)
    jp, p = _params(jrec.init_mlstm, jcfg, 1)
    x = _rand(B, S, D, seed=3)
    want, _ = jrec.mlstm_forward(jp, jcfg, jnp.asarray(x))
    got, st = rec.mlstm_forward(p, cfg, torch.from_numpy(x))
    assert st is None and got.shape == (B, S, D)
    assert scaled_err(got, want) <= TOL


def test_mlstm_refuses_a_ragged_last_chunk():
    """JAX asserts ``S % chunk == 0`` for S past one chunk; the port
    raises."""
    cfg = rec.MLSTMConfig(**ML)
    p = rec.init_mlstm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        rec.mlstm_forward(p, cfg, torch.zeros(B, 12, D))


def test_mlstm_decode_matches_jax():
    """Six one-token steps, then one of three tokens, from
    ``init_mlstm_state``: outputs and (C, n, m) equal to JAX's."""
    jcfg, cfg = jrec.MLSTMConfig(**ML), rec.MLSTMConfig(**ML)
    jp, p = _params(jrec.init_mlstm, jcfg, 2)
    jst = jrec.init_mlstm_state(jcfg, B)
    st = rec.init_mlstm_state(cfg, B)
    assert _state_err(st, jst) == 0.0
    xs = _rand(9, B, 1, D, seed=4)
    for t0, t1 in [(t, t + 1) for t in range(6)] + [(6, 9)]:
        x = np.concatenate(list(xs[t0:t1]), axis=1)
        want, jst = jrec.mlstm_forward(jp, jcfg, jnp.asarray(x), jst)
        got, st = rec.mlstm_forward(p, cfg, torch.from_numpy(x), st)
        assert scaled_err(got, want) <= TOL
        assert _state_err(st, jst) <= TOL


def test_mlstm_prefill_equals_decode():
    """The chunked-parallel form over two chunks and the recurrent step
    give one cell."""
    cfg = rec.MLSTMConfig(**ML)
    p = rec.init_mlstm(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_rand(B, 16, D, seed=5))
    full, _ = rec.mlstm_forward(p, cfg, x)
    stepped, _ = rec.mlstm_forward(p, cfg, x, rec.init_mlstm_state(cfg, B))
    assert scaled_err(stepped, full.numpy()) <= TOL


# -- sLSTM --------------------------------------------------------------------

SL = dict(d_model=D, num_heads=4)


def test_slstm_prefill_matches_jax():
    jcfg, cfg = jrec.SLSTMConfig(**SL), rec.SLSTMConfig(**SL)
    jp, p = _params(jrec.init_slstm, jcfg, 1)
    x = _rand(B, 13, D, seed=3)
    want, _ = jrec.slstm_forward(jp, jcfg, jnp.asarray(x))
    got, st = rec.slstm_forward(p, cfg, torch.from_numpy(x))
    assert st is None and got.shape == (B, 13, D)
    assert scaled_err(got, want) <= TOL


def test_slstm_prefill_equals_decode():
    """The prefill form (the stabilizer's loop and the scan of c and n)
    and the decode loop from a fresh state give one cell, and one
    gradient with respect to x and every leaf."""
    cfg = rec.SLSTMConfig(**SL)
    p = rec.init_slstm(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_rand(B, 33, D, seed=5)).requires_grad_(True)
    w = torch.from_numpy(_rand(B, 33, D, seed=6))
    leaves = [t.requires_grad_(True) for _, t in _leaves(p)]
    full, _ = rec.slstm_forward(p, cfg, x)
    stepped, _ = rec.slstm_forward(p, cfg, x, rec.init_slstm_state(cfg, B))
    assert scaled_err(full.detach(), stepped.detach().numpy()) <= TOL
    got = torch.autograd.grad((full * w).sum(), (x, *leaves))
    want = torch.autograd.grad((stepped * w).sum(), (x, *leaves))
    for g, r in zip(got, want):
        assert float((g - r).norm()) <= LEAF_TOL * float(r.norm())


def _stabilizer_loop(log_f, log_i, m0):
    m, ms = m0, []
    for t in range(log_f.shape[1]):
        m = torch.maximum(log_f[:, t] + m, log_i[:, t])
        ms.append(m)
    return torch.stack(ms, dim=1)


def test_slstm_stabilizer_gradcheck_fp64():
    rng = np.random.default_rng(9)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (
        np.log(rng.uniform(0.3, 0.99, (B, 9, 5))),
        rng.standard_normal((B, 9, 5)), rng.standard_normal((B, 5)))]
    assert torch.autograd.gradcheck(rec.SLSTMStabilizerFn.apply, ts)


def test_slstm_stabilizer_matches_the_loop_on_ties():
    """m_t = max(lf_t + m_{t-1}, li_t) with ties planted (li equal to
    lf + m_{t-1} in exact arithmetic) and the forget path losing and
    winning: the Function's forward bits and its gradients equal autograd
    of the step loop's, whose ``torch.maximum`` splits a tie's gradient
    in halves, as ``jnp.maximum``'s does."""
    lf = torch.tensor([[[-0.5, -0.25], [-0.5, -1.0], [-0.25, -0.5],
                        [-2.0, -0.125]]], dtype=torch.float64)
    li = torch.tensor([[[0.0, 1.0], [-0.5, -1.0], [-0.75, 3.0],
                        [-2.75, 2.875]]], dtype=torch.float64)
    m0 = torch.tensor([[0.5, -8.0]], dtype=torch.float64)
    dm = torch.from_numpy(_rand(1, 4, 2, seed=3).astype(np.float64))
    args = [t.clone().requires_grad_(True) for t in (lf, li, m0)]
    ref = [t.clone().requires_grad_(True) for t in (lf, li, m0)]
    got = rec.SLSTMStabilizerFn.apply(*args)
    want = _stabilizer_loop(*ref)
    assert torch.equal(got.detach(), want.detach())
    fm = lf + torch.cat([m0[:, None], want.detach()[:, :-1]], dim=1)
    assert int((fm == li).sum()) >= 3 and bool((fm > li).any())
    for g, r in zip(torch.autograd.grad(got, args, dm),
                    torch.autograd.grad(want, ref, dm)):
        assert torch.allclose(g, r, rtol=0, atol=1e-15)


def test_slstm_decode_matches_jax():
    """Six one-token steps, then one of three tokens, from
    ``init_slstm_state``: outputs and (c, n, m) equal to JAX's."""
    jcfg, cfg = jrec.SLSTMConfig(**SL), rec.SLSTMConfig(**SL)
    jp, p = _params(jrec.init_slstm, jcfg, 2)
    jst = jrec.init_slstm_state(jcfg, B)
    st = rec.init_slstm_state(cfg, B)
    assert _state_err(st, jst) == 0.0
    xs = _rand(9, B, 1, D, seed=4)
    for t0, t1 in [(t, t + 1) for t in range(6)] + [(6, 9)]:
        x = np.concatenate(list(xs[t0:t1]), axis=1)
        want, jst = jrec.slstm_forward(jp, jcfg, jnp.asarray(x), jst)
        got, st = rec.slstm_forward(p, cfg, torch.from_numpy(x), st)
        assert scaled_err(got, want) <= TOL
        assert _state_err(st, jst) <= TOL


# -- parameters and bf16 ------------------------------------------------------

CELLS = {
    "rglru": (jrec.init_rglru, jrec.rglru_forward, jrec.RGLRUConfig,
              rec.rglru_forward, rec.RGLRUConfig, RG,
              rec.rglru_param_count),
    "mlstm": (jrec.init_mlstm, jrec.mlstm_forward, jrec.MLSTMConfig,
              rec.mlstm_forward, rec.MLSTMConfig, ML,
              rec.mlstm_param_count),
    "slstm": (jrec.init_slstm, jrec.slstm_forward, jrec.SLSTMConfig,
              rec.slstm_forward, rec.SLSTMConfig, SL,
              rec.slstm_param_count),
}
PORT_INIT = {"rglru": rec.init_rglru, "mlstm": rec.init_mlstm,
             "slstm": rec.init_slstm}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_init_matches_jax_leaves(cell):
    """The port's initialiser gives JAX's keys, shapes and dtypes (bf16
    model: the fp32 leaves stay fp32), and its count is the leaves'."""
    jinit, _, jcls, _, cls, kw, count = CELLS[cell]
    jp = jinit(jax.random.PRNGKey(0), jcls(**kw), jnp.bfloat16)
    p = PORT_INIT[cell](torch.Generator().manual_seed(0), cls(**kw),
                        torch.bfloat16)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    want = {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
            for k, v in flat(jp)}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat(p)}
    assert got == want
    assert count(cls(**kw)) == sum(int(np.prod(s)) for s, _ in want.values())
    fp32 = {k.split("/")[-1] for k, (_, dt) in want.items()
            if dt == "float32"}
    assert fp32 <= rec.FP32_LEAVES


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bf16_matches_jax(cell):
    """bf16 weights and input (JAX's bf16 initialiser, carried over),
    prefill and one decode step from a fresh state: within BF16_TOL of
    the bf16 output's scale."""
    jinit, jfwd, jcls, fwd, cls, kw, _ = CELLS[cell]
    jcfg, cfg = jcls(**kw), cls(**kw)
    jp, p = _params(jinit, jcfg, 3, jnp.bfloat16)
    x = _rand(B, 16, D, seed=6)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = jfwd(jp, jcfg, jx)
    got, _ = fwd(p, cfg, tx)
    assert got.dtype == torch.bfloat16
    assert scaled_err(got.float(), np.asarray(want, np.float32)) <= BF16_TOL
    init_state = {"rglru": (jrec.init_rglru_state, rec.init_rglru_state),
                  "mlstm": (jrec.init_mlstm_state, rec.init_mlstm_state),
                  "slstm": (jrec.init_slstm_state, rec.init_slstm_state)}
    jinit_st, init_st = init_state[cell]
    want, jst = jfwd(jp, jcfg, jx[:, :1], jinit_st(jcfg, B))
    got, st = fwd(p, cfg, tx[:, :1], init_st(cfg, B))
    assert scaled_err(got.float(), np.asarray(want, np.float32)) <= BF16_TOL
    assert _state_err(st, jst) <= BF16_TOL


def test_mlstm_chunk_takes_fp32_products_of_bf16_values():
    """``_mlstm_attention_chunk`` on the same bf16 q, k, v and fp32 gates:
    JAX's einsums ask for fp32 results (``preferred_element_type``), so
    the scores and the numerator are fp32 sums of exact products, and the
    port's match within 1e-5 of their scale.  Products rounded to bf16
    (``q @ k.T`` on bf16 tensors) miss by about 2^-9 of it."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((B, 4, 8, 8), dtype=np.float32)
               for _ in range(3))
    log_f = np.log(rng.uniform(0.5, 1.0, (B, 4, 8))).astype(np.float32)
    log_i = rng.standard_normal((B, 4, 8), dtype=np.float32)
    want = jrec._mlstm_attention_chunk(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(log_f), jnp.asarray(log_i))
    got = rec._mlstm_attention_chunk(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(log_f), torch.from_numpy(log_i))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert scaled_err(g, w) <= TOL


# -- gradients (training) -----------------------------------------------------

def _scan_inputs(S, dtype=np.float32):
    rng = np.random.default_rng(S)
    return (rng.uniform(0.5, 1.0, (B, S, 24)).astype(dtype),
            rng.standard_normal((B, S, 24)).astype(dtype),
            rng.standard_normal((B, S, 24)).astype(dtype))


@pytest.mark.parametrize("S", [1, 5, 16, 33])
def test_rglru_scan_gradient_matches_jax(S):
    """d a and d bx of the scan Function against ``jax.vjp`` of JAX's
    ``associative_scan`` and against autograd of ``rglru_scan_ref``; its
    forward bits are the doubling scan's, with or without a graph."""
    a, bx, dh = _scan_inputs(S)
    _, vjp = jax.vjp(jrec.rglru_scan, jnp.asarray(a), jnp.asarray(bx))
    want = vjp(jnp.asarray(dh))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, bx)]
    h = rec.rglru_scan(*ts)
    assert type(h.grad_fn).__name__ == "RGLRUScanFnBackward"
    with torch.no_grad():
        assert torch.equal(rec.rglru_scan(*ts), h.detach())
    got = torch.autograd.grad(h, ts, torch.from_numpy(dh))
    plain = torch.autograd.grad(rec.rglru_scan_ref(*ts), ts,
                                torch.from_numpy(dh))
    for g, w, r in zip(got, want, plain):
        assert scaled_err(g, w) <= TOL
        assert scaled_err(g, r.numpy()) <= TOL


@pytest.mark.parametrize("S", [1, 5, 16, 33])
def test_rglru_scan_gradcheck_fp64(S):
    a, bx, _ = _scan_inputs(S, np.float64)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, bx)]
    assert torch.autograd.gradcheck(rec.rglru_scan, ts)


def test_rglru_scan_gradient_of_one_operand():
    """Only bx asks for a gradient (a is a constant): the Function returns
    none for a and the same d bx."""
    a, bx, dh = _scan_inputs(9)
    t = torch.from_numpy(bx).requires_grad_(True)
    (got,) = torch.autograd.grad(rec.rglru_scan(torch.from_numpy(a), t), t,
                                 torch.from_numpy(dh))
    (want,) = torch.autograd.grad(rec.rglru_scan_ref(torch.from_numpy(a), t),
                                  t, torch.from_numpy(dh))
    assert scaled_err(got, want.numpy()) <= TOL


def _leaves(tree, prefix=""):
    """(path, leaf) of a parameter tree or a nested dict, by sorted key."""
    for k in sorted(tree.keys()):
        if isinstance(tree[k], (torch.Tensor, np.ndarray)):
            yield prefix + k, tree[k]
        else:
            yield from _leaves(tree[k], prefix + k + "/")


@pytest.mark.parametrize("cell,S", [("rglru", 13), ("mlstm", 32),
                                    ("slstm", 13)])
def test_mixer_gradients_match_jax(cell, S):
    """The prefill path's gradient of ⟨y, w⟩ with respect to x and every
    parameter leaf against ``jax.grad`` on the same weights and inputs
    (mLSTM over four 8-position chunks, the carry under autograd)."""
    jinit, jfwd, jcls, fwd, cls, kw, _ = CELLS[cell]
    jcfg, cfg = jcls(**kw), cls(**kw)
    jp, p = _params(jinit, jcfg, 4)
    x, w = _rand(B, S, D, seed=7), _rand(B, S, D, seed=8)

    def jloss(params, xx):
        return jnp.sum(jfwd(params, jcfg, xx)[0] * jnp.asarray(w))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    names, leaves = zip(*_leaves(p))
    leaves = [t.requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = fwd(p, cfg, xt)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                              (xt, *leaves))
    assert scaled_err(got[0], jgx) <= TOL
    want = dict(_leaves(np_tree(jgp)))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, got[1:]):
        ref = want[name]
        err = float(np.linalg.norm(g.numpy() - ref))
        assert err <= LEAF_TOL * float(np.linalg.norm(ref)), (name, err)
