"""The bfloat16 tensor-core route of the flash kernels, on the CPU.

The Hopper kernels of that route (``csrc/flash_tc.cuh``, the forward in
``csrc/flash_fwd.cu``, dQ and dK/dV in ``csrc/flash_bwd.cu``) run only on the
card, where ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them
against the plain versions. Here the parts around them are checked: the tile
and shared-memory choice against the CUDA sources' constants, the check of
what TMA can read, and the limits the card's check applies. For the limits,
an emulation of each kernel's arithmetic (its tiles and tile range, the
online softmax in float32, P rounded to bfloat16 once before P.V; dS, and in
dK/dV also P, carried to the tensor cores as two bfloat16 parts) lies within
them on small grid cases, an emulation with one tile dropped breaks the
forward's lse limit, each single rounding the backward kernels avoid breaks
their limit, and the emulations agree with the JAX package's ``_fwd`` and
``_bwd`` (Pallas in interpret mode) on the same inputs from numpy seeds.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd, _fwd
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path(fa.__file__).resolve().parent / "csrc"
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def make_qkv(rng, B, H, Hkv, S, D):
    """q (B, H, S, D), k and v (B, Hkv, S, D), entries N(0, 0.25), in
    bfloat16 (as float32 arrays that are exactly bfloat16 values)."""
    return tuple(torch.from_numpy((rng.normal(size=(B, h, S, D)) * 0.5).astype(np.float32)).bfloat16().float()
                 for h in (H, Hkv, Hkv))


def fwd_tile_range(q0, q1, Sk, kind, window, BK):
    """The K/V tiles ``[lo, hi)`` the forward kernels visit for q rows
    ``[q0, q1)`` (csrc/flash_fwd.cu, both routes)."""
    nk = -(-Sk // BK)
    lo, hi = 0, nk
    if kind != "bidirectional":
        hi = min((q1 - 1) // BK + 1, nk)
        if kind == "sliding":
            if window < 1 or q1 - 1 > Sk + window - 2:
                hi = nk
            else:
                lo = max(0, q0 - window + 1) // BK
    return lo, hi


def tc_forward(q, k, v, kind, window, softcap, drop=None):
    """The tensor-core forward's arithmetic on float32 tensors holding
    bfloat16 values: per TC_BLOCK_Q-row q tile, the TC_BLOCK_K-key tiles of
    its range, online softmax in float32, P rounded to bfloat16 before P.V.
    ``drop`` = (q tile, key tile) leaves that one tile out. Returns (o in
    bfloat16, lse)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf, vf = (x.repeat_interleave(H // Hkv, dim=1) for x in (k, v))
    BQ, BK, scale = fa.TC_BLOCK_Q, fa.TC_BLOCK_K, D ** -0.5
    o = torch.empty(B, H, Sq, D)
    lse = torch.empty(B, H, Sq)
    mask = fa.flash_mask(Sq, Sk, kind, window)
    for q0 in range(0, Sq, BQ):
        q1 = min(q0 + BQ, Sq)
        m = torch.full((B, H, q1 - q0), fa.NEG_INF)
        l = torch.zeros(B, H, q1 - q0)
        acc = torch.zeros(B, H, q1 - q0, D)
        lo, hi = fwd_tile_range(q0, q1, Sk, kind, window, BK)
        for kt in range(lo, hi):
            if drop == (q0 // BQ, kt):
                continue
            k0, k1 = kt * BK, min(kt * BK + BK, Sk)  # keys past Sk score -inf: p = 0 exactly
            s = (q[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
            if softcap:
                s = softcap * torch.tanh(s * (1.0 / softcap))
            s = torch.where(mask[q0:q1, k0:k1], s, fa.NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k1]
            m = mx
        ls = l.clamp_min(1e-30)
        o[:, :, q0:q1] = acc / ls[..., None]
        lse[:, :, q0:q1] = m + torch.log(ls)
    return o.bfloat16(), lse


def tc_dq(q, k, v, o, lse, do, kind, window, softcap, split=True):
    """The tensor-core dQ kernel's arithmetic on float32 tensors holding
    bfloat16 values: per DQ_TC_BLOCK_Q-row q tile, the DQ_TC_BLOCK_K-key
    tiles from the window's first to the diagonal, p and dS in float32 as
    ``pair_grad`` forms them, dS.K with dS as hi + lo bfloat16 parts (or, with
    ``split=False``, rounded to bfloat16 once). Returns dq in float32, before
    the output's rounding."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf, vf = (x.repeat_interleave(H // Hkv, dim=1) for x in (k, v))
    BQ, BK, scale = fa.DQ_TC_BLOCK_Q, fa.DQ_TC_BLOCK_K, D ** -0.5
    delta = (do * o).sum(-1)
    mask = fa.flash_mask(Sq, Sk, kind, window)
    dq = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, BQ):
        q1 = min(q0 + BQ, Sq)
        lo, hi = 0, -(-Sk // BK)
        if kind != "bidirectional":
            hi = min((q1 - 1) // BK + 1, hi)
            if kind == "sliding":
                lo = max(0, q0 - window + 1) // BK
        for kt in range(lo, hi):
            k0, k1 = kt * BK, min(kt * BK + BK, Sk)
            s = (q[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
            dcap = 1.0
            if softcap:
                t = torch.tanh(s / softcap)
                s, dcap = softcap * t, 1 - t * t
            keep = mask[q0:q1, k0:k1]
            p = torch.exp(torch.where(keep, s, fa.NEG_INF) - lse[:, :, q0:q1, None])
            dp = do[:, :, q0:q1] @ vf[:, :, k0:k1].transpose(-1, -2)
            ds = torch.where(keep, p * (dp - delta[:, :, q0:q1, None]) * dcap, 0.0)
            hi_ = ds.bfloat16().float()
            parts = (hi_, (ds - hi_).bfloat16().float()) if split else (hi_,)
            for part in parts:
                dq[:, :, q0:q1] += part @ kf[:, :, k0:k1]
    return dq * scale


def dkv_tile_range(k0, k1, Sq, Sk, kind, window, BQ):
    """The q tiles ``[lo, hi)`` the dK/dV kernels visit for keys ``[k0, k1)``
    (csrc/flash_bwd.cu, both routes): from the causal diagonal to the
    window's last row, or every tile where a sliding row sees no key."""
    nq = -(-Sq // BQ)
    lo, hi = 0, nq
    if kind != "bidirectional":
        lo = k0 // BQ
        if kind == "sliding":
            if window < 1 or Sq - 1 > Sk + window - 2:
                lo = 0
            else:
                hi = min(nq, (k1 + window - 2) // BQ + 1)
    return lo, hi


def _parts(x, split):
    """x as the tensor cores take it: bfloat16 hi, and with ``split`` also
    the bfloat16 lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def tc_dkv(q, k, v, o, lse, do, kind, window, softcap, split_p=True, split_ds=True):
    """The tensor-core dK/dV kernel's arithmetic on float32 tensors holding
    bfloat16 values: per DKV_TC_BLOCK_K-key tile, the DKV_TC_BLOCK_Q-row q
    tiles of its range, S^T and dP^T in float32, p and p (1 - tanh^2) as
    ``pair_grad`` forms them (0 where masked), dS^T = p (1 - tanh^2)
    (dP^T - delta); P^T.dO and dS^T.Q with P and dS as hi + lo bfloat16 parts
    (or, with ``split_p`` / ``split_ds`` False, rounded to bfloat16 once),
    summed over the GQA group; q's scale in float32 on S^T and on dk. Returns
    (dk, dv) in float32, before the output's rounding."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    BQ, BK, scale = fa.DKV_TC_BLOCK_Q, fa.DKV_TC_BLOCK_K, D ** -0.5
    q5, do5 = (x.reshape(B, Hkv, G, Sq, D) for x in (q, do))
    lse5 = lse.reshape(B, Hkv, G, Sq)
    delta5 = (do * o).sum(-1).reshape(B, Hkv, G, Sq)
    mask = fa.flash_mask(Sq, Sk, kind, window)
    dk, dv = torch.zeros(B, Hkv, Sk, D), torch.zeros(B, Hkv, Sk, D)
    for k0 in range(0, Sk, BK):
        k1 = min(k0 + BK, Sk)
        kt, vt = k[:, :, None, k0:k1], v[:, :, None, k0:k1]
        lo, hi = dkv_tile_range(k0, k1, Sq, Sk, kind, window, BQ)
        for it in range(lo, hi):
            q0, q1 = it * BQ, min(it * BQ + BQ, Sq)
            s = (kt @ q5[..., q0:q1, :].transpose(-1, -2)) * scale  # (B, Hkv, G, keys, q rows)
            dcap = 1.0
            if softcap:
                t = torch.tanh(s / softcap)
                s, dcap = softcap * t, 1 - t * t
            keep = mask[q0:q1, k0:k1].T
            p = torch.exp(torch.where(keep, s, fa.NEG_INF) - lse5[..., None, q0:q1])
            ds = torch.where(keep, p * dcap, 0.0) * (vt @ do5[..., q0:q1, :].transpose(-1, -2)
                                                     - delta5[..., None, q0:q1])
            for part in _parts(p, split_p):
                dv[:, :, k0:k1] += (part @ do5[..., q0:q1, :]).sum(2)
            for part in _parts(ds, split_ds):
                dk[:, :, k0:k1] += (part @ q5[..., q0:q1, :]).sum(2)
    return dk * scale, dv


# (B, H, Hkv, S, D, kind, window, softcap): ragged and whole lengths, every
# mask kind, softcap 0 and 50, G in {1, 2, 4}
GRID = [(1, 4, 4 // G, S, D, kind, window, softcap)
        for S, D, G in ((200, 32, 1), (640, 16, 2), (640, 32, 4))
        for kind, window in (("causal", 0), ("sliding", 37), ("bidirectional", 0))
        for softcap in (0.0, 50.0)]


@pytest.mark.parametrize("B,H,Hkv,S,D,kind,window,softcap", GRID)
def test_tc_forward_rounding_is_within_the_chip_limit(B, H, Hkv, S, D, kind, window, softcap):
    """P rounded to bfloat16 once, as the tensor-core forward does, keeps o
    within chip_smoke's derived limit (2^-8 |o32| + 2^-8 (P|V|)/l + F32_TOL)
    and lse within F32_TOL of the plain version."""
    q, k, v = make_qkv(np.random.default_rng(S + D + len(kind)), B, H, Hkv, S, D)
    got = tc_forward(q, k, v, kind, window, softcap)
    ok, *errs = chip_smoke.flash_err(fa, got, q.bfloat16(), k.bfloat16(), v.bfloat16(), kind, window, softcap)
    assert ok, errs


@pytest.mark.parametrize("kind,window,S", [("causal", 0, 640), ("sliding", 100, 640)])
def test_dropping_a_diagonal_tile_breaks_the_lse_limit(kind, window, S):
    """The lse limit catches a skipped tile: the forward without the last
    (diagonal) key tile of one q tile fails the check."""
    q, k, v = make_qkv(np.random.default_rng(5), 1, 2, 1, S, 32)
    qt = 2
    _, hi = fwd_tile_range(qt * fa.TC_BLOCK_Q, (qt + 1) * fa.TC_BLOCK_Q, S, kind, window, fa.TC_BLOCK_K)
    bf = (q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert chip_smoke.flash_err(fa, tc_forward(q, k, v, kind, window, 50.0), *bf, kind, window, 50.0)[0]
    ok, _, _, dlse = chip_smoke.flash_err(fa, tc_forward(q, k, v, kind, window, 50.0, drop=(qt, hi - 1)), *bf, kind,
                                          window, 50.0)
    assert not ok and dlse > 100 * chip_smoke.F32_TOL


def test_tc_forward_matches_reference_fwd_bf16():
    """The emulated tensor-core forward against the reference's ``_fwd`` on
    the same bfloat16 inputs, at the reference's bfloat16 tolerance."""
    q, k, v = make_qkv(np.random.default_rng(0), 1, 4, 2, 256, 32)
    jb = [jnp.asarray(x.numpy()).astype(jnp.bfloat16) for x in (q, k, v)]
    o_ref, lse_ref = _fwd(*jb, "causal", 0, 30.0, 32 ** -0.5, 128, 64, True)
    o, lse = tc_forward(q, k, v, "causal", 0, 30.0)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_ref, np.float32), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-2, atol=2e-2)


def _bwd_case(seed, H, Hkv, S, D, kind, window, softcap):
    rng = np.random.default_rng(seed)
    q, k, v = make_qkv(rng, 1, H, Hkv, S, D)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).bfloat16().float()
    o, lse = fa.flash_attention_ref(q, k, v, kind, window, softcap)
    return q, k, v, o.bfloat16().float(), lse, do


@pytest.mark.parametrize("S,D,G,kind,window,softcap", [
    (200, 32, 2, "causal", 0, 50.0), (640, 16, 4, "sliding", 37, 50.0), (640, 32, 1, "bidirectional", 0, 0.0),
])
def test_tc_dq_split_rounding_is_within_the_chip_limit(S, D, G, kind, window, softcap):
    """dS as hi + lo bfloat16 parts keeps dq within chip_smoke's unchanged
    limit (2^-8 relative + 1e-5 of the largest entry) of the plain version's
    float32 gradient, and so does the output's one rounding on top; dS
    rounded once would not, which is why the kernel splits it."""
    q, k, v, o, lse, do = _bwd_case(S + D, 4, 4 // G, S, D, kind, window, softcap)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, kind, window, softcap)[0]
    rtol, atol = chip_smoke.bwd_limits(want, torch.bfloat16)

    def within(dq):
        return bool(((dq - want).abs() <= atol + rtol * want.abs()).all())

    dq = tc_dq(q, k, v, o, lse, do, kind, window, softcap)
    assert within(dq) and within(dq.bfloat16().float())
    assert not within(tc_dq(q, k, v, o, lse, do, kind, window, softcap, split=False))


def test_tc_dq_matches_reference_bwd():
    """The emulated tensor-core dQ against the reference's ``_bwd`` (dq) on
    the same inputs and the reference's own ``o`` and ``lse``, at the
    reference's gradient tolerance."""
    rng = np.random.default_rng(3)
    q, k, v = make_qkv(rng, 1, 4, 2, 256, 32)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    scale = 32 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    o_j, lse_j = _fwd(jq, jk, jv, "sliding", 100, 30.0, scale, 128, 64, True)
    want = np.asarray(_bwd(jq, jk, jv, o_j, lse_j, jdo, "sliding", 100, 30.0, scale, 128, 64, True)[0])
    got = tc_dq(q, k, v, torch.from_numpy(np.array(o_j)), torch.from_numpy(np.array(lse_j)), do, "sliding",
                100, 30.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-5)


def _within(got, want):
    rtol, atol = chip_smoke.bwd_limits(want, torch.bfloat16)
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.parametrize("B,H,Hkv,S,D,kind,window,softcap", GRID)
def test_tc_dkv_split_rounding_is_within_the_chip_limit(B, H, Hkv, S, D, kind, window, softcap):
    """P and dS as hi + lo bfloat16 parts keep dk and dv within chip_smoke's
    unchanged limit (2^-8 relative + 1e-5 of the largest entry) of the plain
    version's float32 gradients, and so does the outputs' one rounding on
    top."""
    q, k, v, o, lse, do = _bwd_case(S + D, H, Hkv, S, D, kind, window, softcap)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, kind, window, softcap)[1:]
    for got, w in zip(tc_dkv(q, k, v, o, lse, do, kind, window, softcap), want):
        assert _within(got, w) and _within(got.bfloat16().float(), w)


@pytest.mark.parametrize("S,D,G,kind,window,softcap", [
    (200, 32, 2, "causal", 0, 50.0), (640, 16, 4, "sliding", 37, 50.0), (640, 32, 1, "bidirectional", 0, 0.0),
])
@pytest.mark.parametrize("rounded_once", ["p", "ds"])
def test_tc_dkv_single_rounding_breaks_the_chip_limit(S, D, G, kind, window, softcap, rounded_once):
    """P rounded to bfloat16 once breaks dv's limit and dS rounded once
    breaks dk's, where the sums over q cancel (dO and dS take both signs);
    the other gradient stays within its limit. This is why the kernel
    splits both."""
    q, k, v, o, lse, do = _bwd_case(S + D, 4, 4 // G, S, D, kind, window, softcap)
    want_dk, want_dv = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, kind, window, softcap)[1:]
    dk, dv = tc_dkv(q, k, v, o, lse, do, kind, window, softcap, split_p=rounded_once != "p",
                    split_ds=rounded_once != "ds")
    broken, kept = ((dv, want_dv), (dk, want_dk)) if rounded_once == "p" else ((dk, want_dk), (dv, want_dv))
    assert not _within(*broken) and _within(*kept)


def test_tc_dkv_matches_reference_bwd():
    """The emulated tensor-core dK/dV against the reference's ``_bwd`` (dk,
    dv) on the same inputs and the reference's own ``o`` and ``lse``, at the
    reference's gradient tolerance."""
    rng = np.random.default_rng(4)
    q, k, v = make_qkv(rng, 1, 4, 2, 256, 32)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    scale = 32 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    o_j, lse_j = _fwd(jq, jk, jv, "sliding", 100, 30.0, scale, 128, 64, True)
    want = _bwd(jq, jk, jv, o_j, lse_j, jdo, "sliding", 100, 30.0, scale, 128, 64, True)[1:]
    got = tc_dkv(q, k, v, torch.from_numpy(np.array(o_j)), torch.from_numpy(np.array(lse_j)), do, "sliding", 100,
                 30.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4, atol=3e-5)


def test_tc_tile_choice_fits_shared_memory():
    for D in fa.HEAD_DIMS:
        assert fa.flash_tc_tile_sizes(D) == (fa.TC_BLOCK_Q, fa.TC_BLOCK_K) == (128, 64)
        assert fa.flash_dq_tc_tile_sizes(D) == (fa.DQ_TC_BLOCK_Q, fa.DQ_TC_BLOCK_K) == (128, 32)
        assert fa.flash_dkv_tc_tile_sizes(D) == (fa.DKV_TC_BLOCK_Q, fa.DKV_TC_BLOCK_K) == (64, 64)
        assert fa.flash_tc_smem_bytes(D) <= fa.SMEM_OPTIN_BYTES
        assert fa.flash_dq_tc_smem_bytes(D) <= fa.SMEM_OPTIN_BYTES
        assert fa.flash_dkv_tc_smem_bytes(D) <= fa.SMEM_OPTIN_BYTES
    assert fa.flash_tc_smem_bytes(256) == fa.flash_dq_tc_smem_bytes(256) == 197_760
    # K, V, 2 stages of Q and dO, 2 float32 64 x 64 exchange tiles, 2 stages of lse and delta
    assert fa.flash_dkv_tc_smem_bytes(256) == 1024 + 2 * 32_768 + 2 * 2 * 32_768 + 2 * 16_384 + 2 * 512 + 128
    assert fa.flash_dkv_tc_smem_bytes(256) == 231_552
    assert fa.flash_tc_smem_bytes(16) == 1024 + 16_384 + 2 * 2 * 8_192 + 128  # D < 64 takes a whole 64-column chunk
    for D in (8, 48, 512):
        for tiles in (fa.flash_tc_tile_sizes, fa.flash_dq_tc_tile_sizes, fa.flash_dkv_tc_tile_sizes):
            with pytest.raises(ValueError):
                tiles(D)
    for tiles, fits in ((fa.flash_tc_tile_sizes, 128), (fa.flash_dq_tc_tile_sizes, 128),
                        (fa.flash_dkv_tc_tile_sizes, 64)):
        with pytest.raises(ValueError, match="budget"):
            tiles(256, smem_budget=190_000)
        assert tiles(fits, smem_budget=100_000)


def test_tc_constants_are_the_cuda_sources():
    hdr = (CSRC / "flash_tc.cuh").read_text()
    fwd = (CSRC / "flash_fwd.cu").read_text()
    bwd = (CSRC / "flash_bwd.cu").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr (?:int|long long) (k\w+) = (\d+);", hdr)}
    assert const["kStages"] == fa.TC_STAGES
    assert const["kSmemAlign"] == fa.TC_SMEM_ALIGN
    assert const["kBarrierBytes"] == fa.TC_BARRIER_BYTES >= 8 * (1 + 4 * fa.TC_STAGES)
    assert const["kChunkCols"] == 64 and const["kThreads"] == 256
    assert re.search(rf"constexpr int kTcBQ = {fa.TC_BLOCK_Q};", fwd)
    assert re.search(rf"constexpr int kTcBK = {fa.TC_BLOCK_K};", fwd)
    assert re.search(rf"constexpr int kDqTcBQ = {fa.DQ_TC_BLOCK_Q};", bwd)
    assert re.search(rf"constexpr int kDqTcBK = {fa.DQ_TC_BLOCK_K};", bwd)
    assert re.search(rf"constexpr int kDkvTcBQ = {fa.DKV_TC_BLOCK_Q};", bwd)
    assert re.search(rf"constexpr int kDkvTcBK = {fa.DKV_TC_BLOCK_K};", bwd)
    # lse and delta rows as _tma_rows lays them out: Sq rounded up to a multiple of 4
    assert "constexpr int tma_rows(int Sq) { return (Sq + 3) & ~3; }" in bwd
    # every head dimension has a tensor-core instance, so no bfloat16 case takes the float32 kernel
    assert tuple(int(d) for d in re.findall(r"FLASH_TC_CASE\((\d+)\)", fwd)) == fa.HEAD_DIMS
    assert tuple(int(d) for d in re.findall(r"FLASH_DQ_TC_CASE\((\d+)\)", bwd)) == fa.HEAD_DIMS
    assert tuple(int(d) for d in re.findall(r"FLASH_DKV_TC_CASE\((\d+)\)", bwd)) == fa.HEAD_DIMS
    assert "dtype == 1)\n    return launch_tc_dim(" in fwd
    assert "which == kDq ? launch_dq_tc_dim(D, a, st) : launch_dkv_tc_dim(D, a, st)" in bwd
    for src in (hdr, fwd, bwd):  # built from the repo's sources alone, IEEE tanh
        assert "#include <cute" not in src and "#include <cutlass" not in src and "tanh.approx" not in src


def test_tma_check_rejects_what_tma_cannot_read():
    n = 2 * 8 * 16
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    assert base.data_ptr() % fa.TMA_ALIGN == 0
    fa._check_tma(base[:n].view(1, 2, 8, 16), "q")
    with pytest.raises(ValueError, match="base address"):
        fa._check_tma(base[1:n + 1].view(1, 2, 8, 16), "q")
    with pytest.raises(ValueError, match="stride of axis 2 is 40 bytes"):
        fa._check_tma(torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16)[..., :16], "k")
    # (B, S, H, D) storage seen as (B, H, S, D), as the model passes it
    fa._check_tma(torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16).transpose(1, 2), "v")
    # an axis of one entry has no stride that matters; the launch gets a contiguous one
    odd = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16).as_strided((1, 2, 8, 16), (3, 128, 16, 1))
    fa._check_tma(odd, "q")
    assert fa._strides(odd) == [256, 128, 16]


@pytest.mark.parametrize("Sq", [8, 200, 333, 334, 150])
def test_tma_rows_give_every_q_tile_an_aligned_start(Sq):
    """lse and delta as the bfloat16 dK/dV kernel reads them with TMA: rows
    padded to a multiple of 4, so the 64 values of every q tile of every
    head start 16-byte aligned (TMA refuses other starts); values kept, no
    copy where none is needed, and a misaligned base copied."""
    x = torch.arange(2 * 3 * Sq, dtype=torch.float32).reshape(2, 3, Sq)
    y = fa._tma_rows(x)
    Sr = y.shape[-1]
    assert y.shape == (2, 3, Sr) and Sr % 4 == 0 and Sr - Sq < 4 and y.is_contiguous()
    assert torch.equal(y[..., :Sq], x) and (y is x) == (Sr == Sq)
    starts = [(b * 3 + h) * Sr + q0 for b in range(2) for h in range(3) for q0 in range(0, Sq, fa.DKV_TC_BLOCK_Q)]
    assert all(y.data_ptr() % fa.TMA_ALIGN == 0 and 4 * r % fa.TMA_ALIGN == 0 for r in starts)
    shifted = torch.cat([torch.zeros(1), torch.arange(2 * 3 * 8, dtype=torch.float32)])[1:].view(2, 3, 8)
    assert shifted.data_ptr() % fa.TMA_ALIGN and fa._tma_rows(shifted).data_ptr() % fa.TMA_ALIGN == 0
    assert torch.equal(fa._tma_rows(shifted), shifted)


def test_bf16_launch_checks_tma_before_the_card():
    """``_check_launch`` raises on a bfloat16 view TMA cannot read, after the
    device check: a CPU tensor never reaches the kernel."""
    q = torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa._check_launch(q, q, q, 0)
    assert fa._tma_error(q) is not None and fa._tma_error(q.contiguous()) is None


def test_tc_launch_counters_exist_and_stay_on_the_cpu():
    q, k, v = make_qkv(np.random.default_rng(2), 1, 2, 1, 64, 16)
    before = (fa.launches, fa.launches_fwd_tc, fa.launches_dq, fa.launches_dq_tc, fa.launches_dkv, fa.launches_dkv_tc)
    o, lse = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), "causal")
    fa.flash_attention_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), o, lse, torch.ones_like(o), "causal")
    assert (fa.launches, fa.launches_fwd_tc, fa.launches_dq, fa.launches_dq_tc, fa.launches_dkv,
            fa.launches_dkv_tc) == before
    assert "launches_dkv_tc" in fa.__all__
    assert math.isfinite(float(lse.sum()))
