"""The port's flash-attention backward against the JAX package, on the CPU.

On CPU tensors ``flash_attention_bwd`` runs its plain version,
``flash_attention_bwd_ref``, and ``flash_attention``'s autograd Function
routes its backward there. These tests hold both against the reference's
``_bwd`` (the Pallas dQ and dK/dV kernels in interpret mode) on the gradient
cases of ``tests/test_flash_attention.py``, at that file's gradient tolerance
(rtol 3e-4, atol 3e-5), and against the reference's XLA-route gradients at
ragged lengths, where its Pallas route is wrong (ROADMAP.md Queue 3). Inputs
come from numpy seeds and go to both packages as the same arrays. The Hopper
kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd, _fwd
from repro.models.layers import attention as jax_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import attention

CSRC = Path(fa.__file__).resolve().parent / "csrc" / "flash_bwd.cu"
TOL_GRAD = dict(rtol=3e-4, atol=3e-5)  # tests/test_flash_attention.py's gradient tolerance

# (B, H, Hkv, S, D, kind, window, softcap, Bq, Bk): tests/test_flash_attention.py CASES[:4] + CASES[5:]
GRAD_CASES = [
    (2, 4, 4, 128, 32, "causal", 0, 0.0, 32, 32),
    (1, 4, 1, 128, 32, "causal", 0, 0.0, 64, 32),  # MQA
    (2, 8, 2, 64, 16, "causal", 0, 0.0, 16, 16),  # GQA 4
    (1, 2, 2, 128, 32, "sliding", 48, 0.0, 32, 32),
    (1, 2, 1, 128, 32, "causal", 0, 30.0, 32, 64),  # softcap + GQA
]


def make_qkv(rng, B, H, Hkv, S, D):
    q = (rng.normal(size=(B, H, S, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, S, D)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, Hkv, S, D)) * 0.5).astype(np.float32)
    return q, k, v


def _t(*arrays, requires_grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(requires_grad) for a in arrays]


@pytest.mark.parametrize("B,H,Hkv,S,D,kind,window,softcap,Bq,Bk", GRAD_CASES)
def test_backward_matches_reference_bwd(B, H, Hkv, S, D, kind, window, softcap, Bq, Bk):
    """The plain backward on the reference's own ``o`` and ``lse``, and the
    autograd Function end to end, against ``_bwd`` in interpret mode."""
    rng = np.random.default_rng(B * 37 + S)
    q, k, v = make_qkv(rng, B, H, Hkv, S, D)
    do = rng.normal(size=q.shape).astype(np.float32)
    scale = D ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o_j, lse_j = _fwd(jq, jk, jv, kind, window, softcap, scale, Bq, Bk, True)
    want = [np.asarray(g) for g in _bwd(jq, jk, jv, o_j, lse_j, jdo, kind, window, softcap, scale, Bq, Bk, True)]

    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    got = fa.flash_attention_bwd(*_t(q, k, v, o_j, lse_j, do), kind, window, softcap, scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL_GRAD, err_msg=f"plain {name}")

    tq, tk, tv = _t(q, k, v, requires_grad=True)
    o, lse = fa.flash_attention(tq, tk, tv, kind, window, softcap)
    assert o.requires_grad and not lse.requires_grad
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, **TOL_GRAD, err_msg=f"Function {name}")
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before  # CPU: plain versions, no launch


@pytest.mark.parametrize("kind,window,softcap", [("causal", 0, 0.0), ("sliding", 37, 50.0)])
def test_bf16_io_rounds_the_float32_gradients_once(kind, window, softcap):
    """bfloat16 inputs: the plain backward widens them to float32, so its
    outputs are its float32 outputs on the widened inputs, rounded once
    (within half a bfloat16 ulp, 2^-8 relative)."""
    rng = np.random.default_rng(11)
    q, k, v = _t(*make_qkv(rng, 1, 4, 2, 200, 32))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    ob, lse = fa.flash_attention(qb, kb, vb, kind, window, softcap)
    got = fa.flash_attention_bwd(qb, kb, vb, ob, lse, dob, kind, window, softcap)
    want = fa.flash_attention_bwd(*(x.float() for x in (qb, kb, vb, ob)), lse, dob.float(), kind, window, softcap)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=2.0 ** -8, atol=0.0)


def _plain_route_grads(q, k, v, do, kind, window, softcap):
    """Autograd through ``attention(impl="plain")`` on (B, H, S, D) tensors."""
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    S = q.shape[2]
    o = attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), q_pos=torch.arange(S),
                  kv_pos=torch.arange(S), kind=kind, window=window, attn_softcap=softcap, impl="plain")
    return torch.autograd.grad(o.transpose(1, 2), (tq, tk, tv), do)


@pytest.mark.parametrize("S,kind,window,softcap,H,Hkv", [
    (200, "causal", 0, 0.0, 4, 2),
    (200, "sliding", 37, 50.0, 4, 1),
    (640, "causal", 0, 20.0, 2, 2),
    (640, "sliding", 100, 50.0, 4, 2),
    (640, "bidirectional", 0, 0.0, 4, 1),
])
def test_flash_route_gradients_match_plain_route_at_ragged_lengths(S, kind, window, softcap, H, Hkv):
    """``attention(impl="flash")`` carries the Function's gradients, and they
    are the plain route's at lengths that are no multiple of any tile."""
    rng = np.random.default_rng(S + H)
    q, k, v = _t(*make_qkv(rng, 1, H, Hkv, S, 16))
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    o = attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), q_pos=torch.arange(S),
                  kv_pos=torch.arange(S), kind=kind, window=window, attn_softcap=softcap, impl="flash")
    got = torch.autograd.grad(o.transpose(1, 2), (tq, tk, tv), do)
    want = _plain_route_grads(q, k, v, do, kind, window, softcap)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, **TOL_GRAD, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("kind,window,softcap", [("causal", 0, 0.0), ("sliding", 100, 50.0)])
def test_gradients_match_reference_xla_route_at_640(kind, window, softcap):
    """At S = 640 the reference's Pallas backward walks whole 512-row blocks:
    dq rows >= 512 come out NaN and dk, dv are wrong everywhere (ROADMAP.md
    Queue 3). The port is held to the reference's XLA-route ``jax.grad``."""
    B, H, Hkv, S, D = 1, 2, 1, 640, 16
    rng = np.random.default_rng(0)
    q, k, v = make_qkv(rng, B, H, Hkv, S, D)

    def loss(q, k, v):
        out = jax_attention(jnp.moveaxis(q, 1, 2), jnp.moveaxis(k, 1, 2), jnp.moveaxis(v, 1, 2),
                            q_pos=jnp.arange(S), kv_pos=jnp.arange(S), kind=kind, window=window,
                            attn_softcap=softcap, impl="xla")
        return jnp.sum(jnp.sin(out))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = _t(q, k, v, requires_grad=True)
    o, _ = fa.flash_attention(tq, tk, tv, kind, window, softcap)
    got = torch.autograd.grad(torch.sin(o).sum(), (tq, tk, tv))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_GRAD, err_msg=name)


def test_backward_tile_choice_fits_shared_memory():
    for D in fa.HEAD_DIMS:
        assert fa.flash_bwd_tile_sizes(D) == (fa.BWD_BLOCK_Q, fa.BWD_BLOCK_K) == (64, 32)
        assert max(fa.flash_bwd_smem_bytes(D)) <= fa.SMEM_OPTIN_BYTES
    assert fa.flash_bwd_smem_bytes(256) == (205_824, 214_784)
    for D in (8, 48, 512):
        with pytest.raises(ValueError):
            fa.flash_bwd_tile_sizes(D)
    with pytest.raises(ValueError):
        fa.flash_bwd_tile_sizes(256, smem_budget=210_000)  # the dQ block fits, the dK/dV block does not
    # the Python side's constants are the CUDA source's
    src = CSRC.read_text()
    assert re.search(rf"constexpr int kBQ = {fa.BWD_BLOCK_Q};", src)
    assert re.search(rf"constexpr int kBK = {fa.BWD_BLOCK_K};", src)
    assert re.search(r"constexpr int kThreads = 256;", src)
    assert tuple(int(d) for d in re.findall(r"FLASH_BWD_CASE\((\d+)\)", src)) == fa.HEAD_DIMS
    assert "atomicAdd" not in src  # GQA sums in a fixed order


def test_backward_rejects_bad_inputs():
    rng = np.random.default_rng(1)
    q, k, v = _t(*make_qkv(rng, 1, 4, 2, 16, 16))
    o, lse = fa.flash_attention(q, k, v, "causal")
    do = torch.ones_like(o)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse[..., :8], do)
    with pytest.raises(ValueError, match="do"):
        fa.flash_attention_bwd(q, k, v, o, lse, do.double())
    with pytest.raises(ValueError, match="o must"):
        fa.flash_attention_bwd(q, k, v, o[:, :2], lse, do)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, do, "prefix")


def test_no_gradient_without_grad_mode():
    q, k, v = (torch.zeros(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, "causal")
    assert not o.requires_grad and not lse.requires_grad
