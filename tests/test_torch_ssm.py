"""The port's SSM cells (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU, at the shapes of
``tests/test_ssm_cells.py``.

Each cell takes the same numpy inputs in both packages. Beside the parity
checks, the port's chunked forms are held to its own step forms (the
reference's property tests, with its tolerances), its carried state to one
long run, and its extreme gates and sLSTM to finiteness.

Tolerances against JAX. The causal conv and the sLSTM step do the same
float32 operations in the same order as the reference, so they agree to a
few ulps. The chunked forms sum each output entry of the intra-chunk term
over at most ``chunk`` products, in another order than XLA's einsum paths
(the port writes its contraction order out), and the carried state adds
one more such sum per chunk; each reordered sum of Q terms moves the result
by at most about Q float32 ulps of the largest term. So the chunked outputs
and states are held to ``chunk * 2^-23`` times their largest entry
(:func:`_close_by_chunk`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as J
from repro_torch.models import ssm as T

EPS32 = 2.0 ** -23
TOL_OP = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_by_chunk(got, want, chunk):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=chunk * EPS32 * float(np.abs(want).max()))


def _ssd_inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, P)).astype(np.float32), rng.uniform(0.01, 0.5, size=(B, L, H)).astype(np.float32),
            -rng.uniform(0.1, 1.0, size=(H,)).astype(np.float32), rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32))


def _mlstm_inputs(seed, B, L, H, DK, DV, f_shift=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, DK)).astype(np.float32), rng.normal(size=(B, L, H, DK)).astype(np.float32),
            rng.normal(size=(B, L, H, DV)).astype(np.float32), rng.normal(size=(B, L, H)).astype(np.float32),
            rng.normal(size=(B, L, H)).astype(np.float32) + f_shift)


def test_causal_conv_matches_jax_and_streams():
    rng = np.random.default_rng(0)
    B, L, C, K = 2, 12, 5, 4
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    y_full, state = T.causal_conv1d(_t(x), _t(w))
    want_y, want_state = J.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y_full.numpy(), np.asarray(want_y), **TOL_OP)
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))
    st = torch.zeros((B, K - 1, C))
    ys = []
    for t in range(L):
        want_t, _ = J.causal_conv1d_step(jnp.asarray(x[:, t:t + 1]), jnp.asarray(w), jnp.asarray(st.numpy()))
        y_t, st = T.causal_conv1d_step(_t(x[:, t:t + 1]), _t(w), st)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(want_t), **TOL_OP)
        ys.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, dim=1).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), st.numpy(), rtol=1e-5)
    # a carried state equals one long run
    y1, s1 = T.causal_conv1d(_t(x[:, :5]), _t(w))
    y2, s2 = T.causal_conv1d(_t(x[:, 5:]), _t(w), s1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), y_full.numpy(), **TOL_OP)
    np.testing.assert_array_equal(s2.numpy(), state.numpy())


def test_segsum_matches_jax():
    a = np.random.default_rng(9).normal(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(T._segsum(_t(a)).numpy(), np.asarray(J._segsum(jnp.asarray(a))), **TOL_OP)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax_and_the_step_form(chunk):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 2, 16, 3, 4, 5)
    y, st = T.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk)
    want_y, want_st = J.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close_by_chunk(y, want_y, chunk)
    _close_by_chunk(st, want_st, chunk)

    s = torch.zeros((2, 3, 4, 5))
    ys = []
    for t in range(16):
        y_t, s_new = T.ssd_step(_t(x[:, t]), _t(dt[:, t]), _t(A), _t(Bm[:, t]), _t(Cm[:, t]), s)
        want_t, want_s = J.ssd_step(*map(jnp.asarray, (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], s.numpy())))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(want_t), **TOL_OP)
        np.testing.assert_allclose(s_new.numpy(), np.asarray(want_s), **TOL_OP)
        ys.append(y_t)
        s = s_new
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, dim=1).numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), s.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_state_carry():
    """Two chunked segments with the state carried equal one long run, in
    the port and against JAX's carried run."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, 1, 16, 2, 3, 4)
    args = tuple(map(_t, (x, dt, A, Bm, Cm)))
    y_all, st_all = T.ssd_chunked(*args, chunk=8)
    y1, st1 = T.ssd_chunked(*(a[:, :8] for a in args[:2]), args[2], *(a[:, :8] for a in args[3:]), chunk=8)
    y2, st2 = T.ssd_chunked(*(a[:, 8:] for a in args[:2]), args[2], *(a[:, 8:] for a in args[3:]), chunk=8, state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_all.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st2.numpy(), st_all.numpy(), rtol=2e-4, atol=2e-4)
    want_y2, want_st2 = J.ssd_chunked(*map(jnp.asarray, (x[:, 8:], dt[:, 8:], A, Bm[:, 8:], Cm[:, 8:])), chunk=8,
                                      state=jnp.asarray(st1.numpy()))
    _close_by_chunk(y2, want_y2, 8)
    _close_by_chunk(st2, want_st2, 8)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunked_matches_jax_and_the_step_form(chunk):
    q, k, v, i_pre, f_pre = _mlstm_inputs(3, 2, 16, 2, 4, 6)
    h, (S, n, m) = T.mlstm_chunked(*map(_t, (q, k, v, i_pre, f_pre)), chunk=chunk)
    want_h, (want_S, want_n, want_m) = J.mlstm_chunked(*map(jnp.asarray, (q, k, v, i_pre, f_pre)), chunk=chunk)
    for got, want in ((h, want_h), (S, want_S), (n, want_n), (m, want_m)):
        _close_by_chunk(got, want, chunk)

    state = (torch.zeros((2, 2, 4, 6)), torch.zeros((2, 2, 4)), torch.full((2, 2), -1e30))
    hs = []
    for t in range(16):
        step_in = (q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        h_t, new = T.mlstm_step(*map(_t, step_in), state)
        want_t, want_new = J.mlstm_step(*map(jnp.asarray, step_in), tuple(jnp.asarray(s.numpy()) for s in state))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-5)
        for a, b in zip(new, want_new):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        hs.append(h_t)
        state = new
    np.testing.assert_allclose(h.numpy(), torch.stack(hs, dim=1).numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(S.numpy(), state[0].numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(m.numpy(), state[2].numpy(), rtol=3e-4, atol=3e-4)


def test_mlstm_state_carry():
    q, k, v, i_pre, f_pre = map(_t, _mlstm_inputs(6, 1, 16, 2, 4, 6))
    h_all, st_all = T.mlstm_chunked(q, k, v, i_pre, f_pre, chunk=8)
    h1, st1 = T.mlstm_chunked(q[:, :8], k[:, :8], v[:, :8], i_pre[:, :8], f_pre[:, :8], chunk=8)
    h2, st2 = T.mlstm_chunked(q[:, 8:], k[:, 8:], v[:, 8:], i_pre[:, 8:], f_pre[:, 8:], chunk=8, state=st1)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), h_all.numpy(), rtol=3e-4, atol=3e-4)
    for a, b in zip(st2, st_all):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("i_val, f_val", [(30.0, -30.0), (-40.0, 40.0)])
def test_mlstm_no_nan_extreme_gates(i_val, f_val):
    rng = np.random.default_rng(4)
    B, L, H, DK, DV = 1, 32, 1, 4, 4
    q = rng.normal(size=(B, L, H, DK)).astype(np.float32)
    v = rng.normal(size=(B, L, H, DV)).astype(np.float32)
    i_pre = np.full((B, L, H), i_val, np.float32)  # extreme exponential input gate
    f_pre = np.full((B, L, H), f_val, np.float32)
    h, _ = T.mlstm_chunked(_t(q), _t(q), _t(v), _t(i_pre), _t(f_pre), chunk=8)
    assert torch.isfinite(h).all()
    want, _ = J.mlstm_chunked(*map(jnp.asarray, (q, q, v, i_pre, f_pre)), chunk=8)
    _close_by_chunk(h, want, 8)


def _slstm_inputs(seed, B=2, L=10, H=2, D=4):
    rng = np.random.default_rng(seed)
    gates = [rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(4)]
    r = {name: rng.normal(size=(H, D, D)).astype(np.float32) * 0.1 for name in ("rz", "ri", "rf", "ro")}
    return gates, r


def test_slstm_scan_matches_jax_and_its_steps():
    gates, r = _slstm_inputs(5)
    h, final = T.slstm_scan(*map(_t, gates), {k: _t(w) for k, w in r.items()})
    assert h.shape == (2, 10, 2, 4) and torch.isfinite(h).all()
    want_h, want_final = J.slstm_scan(*map(jnp.asarray, gates), {k: jnp.asarray(w) for k, w in r.items()})
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL_OP)
    for a, b in zip(final, want_final):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_OP)
    # the scan is slstm_step with each gate's recurrent product added, step by step
    z = torch.zeros((2, 2, 4))
    c, n, m, hp = z, z, torch.full((2, 2, 4), -1e30), z
    for t in range(10):
        pre = [_t(g[:, t]) + torch.einsum("bhd,hde->bhe", hp, _t(r[k])) for g, k in zip(gates, ("rz", "ri", "rf", "ro"))]
        want_t, _ = J.slstm_step(*(jnp.asarray(p.numpy()) for p in pre), tuple(jnp.asarray(s.numpy()) for s in (c, n, m)))
        hp, (c, n, m) = T.slstm_step(*pre, (c, n, m))
        np.testing.assert_allclose(hp.numpy(), np.asarray(want_t), **TOL_OP)
        np.testing.assert_allclose(hp.numpy(), h[:, t].numpy(), **TOL_OP)
    np.testing.assert_allclose(final[0].numpy(), c.numpy(), **TOL_OP)


def test_slstm_scan_keeps_float32_state_under_bfloat16_inputs():
    """bfloat16 pre-activations and recurrent weights (as at FULL) meet the
    float32 state: the weights are widened, so ``h`` and the state stay
    float32, as ``jnp.einsum``'s promotion gives in the reference."""
    gates, r = _slstm_inputs(7)
    h, final = T.slstm_scan(*(_t(g).bfloat16() for g in gates), {k: _t(w).bfloat16() for k, w in r.items()})
    assert h.dtype == torch.float32 and all(s.dtype == torch.float32 for s in final)
    want_h, _ = J.slstm_scan(*(jnp.asarray(g, jnp.bfloat16) for g in gates),
                             {k: jnp.asarray(w, jnp.bfloat16) for k, w in r.items()})
    assert want_h.dtype == jnp.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["ssd", "mlstm", "slstm"])
def test_cell_gradients_match_jax(cell):
    """Gradients of a fixed projection of each cell's output, through the
    per-chunk checkpoint (grad mode on) and the sLSTM's loop, against
    ``jax.grad``. Held to the gradient tolerance of the model tests."""
    if cell == "ssd":
        inputs = _ssd_inputs(11, 2, 16, 3, 4, 5)
        fns = (lambda *a: J.ssd_chunked(*a, chunk=4)[0], lambda *a: T.ssd_chunked(*a, chunk=4)[0])
    elif cell == "mlstm":
        inputs = _mlstm_inputs(12, 2, 16, 2, 4, 6)
        fns = (lambda *a: J.mlstm_chunked(*a, chunk=8)[0], lambda *a: T.mlstm_chunked(*a, chunk=8)[0])
    else:
        gates, r = _slstm_inputs(13)
        inputs = tuple(gates) + tuple(r[k] for k in ("rz", "ri", "rf", "ro"))
        names = ("rz", "ri", "rf", "ro")
        fns = (lambda *a: J.slstm_scan(*a[:4], dict(zip(names, a[4:])))[0],
               lambda *a: T.slstm_scan(*a[:4], dict(zip(names, a[4:])))[0])
    proj = np.random.default_rng(14).normal(size=np.shape(fns[0](*map(jnp.asarray, inputs)))).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(fns[0](*a) * proj), argnums=tuple(range(len(inputs)))))(
        *map(jnp.asarray, inputs))
    xs = [_t(a).requires_grad_() for a in inputs]
    got = torch.autograd.grad((fns[1](*xs) * _t(proj)).sum(), xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-5)
