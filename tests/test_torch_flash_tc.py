"""The bfloat16 tensor-core route of the flash kernels, on the CPU.

The Hopper kernels of that route (``csrc/flash_tc.cuh``, the forward in
``csrc/flash_fwd.cu`` and dQ in ``csrc/flash_bwd.cu``) run only on the card,
where ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them against the
plain versions. Here the parts around them are checked: the tile and
shared-memory choice against the CUDA sources' constants, the check of what
TMA can read, and the limits the card's check applies. For the limits, an
emulation of each kernel's arithmetic (its tiles and tile range, the online
softmax in float32, P rounded to bfloat16 once before P.V; dS carried to the
tensor cores as two bfloat16 parts) lies within them on small grid cases,
an emulation with one tile dropped breaks the forward's lse limit, and the
emulations agree with the JAX package's ``_fwd`` and ``_bwd`` (Pallas in
interpret mode) on the same inputs from numpy seeds.
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


def test_tc_tile_choice_fits_shared_memory():
    for D in fa.HEAD_DIMS:
        assert fa.flash_tc_tile_sizes(D) == (fa.TC_BLOCK_Q, fa.TC_BLOCK_K) == (128, 64)
        assert fa.flash_dq_tc_tile_sizes(D) == (fa.DQ_TC_BLOCK_Q, fa.DQ_TC_BLOCK_K) == (128, 32)
        assert fa.flash_tc_smem_bytes(D) <= fa.SMEM_OPTIN_BYTES
        assert fa.flash_dq_tc_smem_bytes(D) <= fa.SMEM_OPTIN_BYTES
    assert fa.flash_tc_smem_bytes(256) == fa.flash_dq_tc_smem_bytes(256) == 197_760
    assert fa.flash_tc_smem_bytes(16) == 1024 + 16_384 + 2 * 2 * 8_192 + 128  # D < 64 takes a whole 64-column chunk
    for D in (8, 48, 512):
        for tiles in (fa.flash_tc_tile_sizes, fa.flash_dq_tc_tile_sizes):
            with pytest.raises(ValueError):
                tiles(D)
    for tiles in (fa.flash_tc_tile_sizes, fa.flash_dq_tc_tile_sizes):
        with pytest.raises(ValueError, match="budget"):
            tiles(256, smem_budget=190_000)
        assert tiles(128, smem_budget=100_000)


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
    # every head dimension has a tensor-core instance, so no bfloat16 case takes the float32 kernel
    assert tuple(int(d) for d in re.findall(r"FLASH_TC_CASE\((\d+)\)", fwd)) == fa.HEAD_DIMS
    assert tuple(int(d) for d in re.findall(r"FLASH_DQ_TC_CASE\((\d+)\)", bwd)) == fa.HEAD_DIMS
    assert "dtype == 1)\n    return launch_tc_dim(" in fwd
    assert "which == kDq ? launch_dq_tc_dim(" in bwd
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


def test_bf16_launch_checks_tma_before_the_card():
    """``_check_launch`` raises on a bfloat16 view TMA cannot read, after the
    device check: a CPU tensor never reaches the kernel."""
    q = torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa._check_launch(q, q, q, 0)
    assert fa._tma_error(q) is not None and fa._tma_error(q.contiguous()) is None


def test_tc_launch_counters_exist_and_stay_on_the_cpu():
    q, k, v = make_qkv(np.random.default_rng(2), 1, 2, 1, 64, 16)
    before = (fa.launches, fa.launches_fwd_tc, fa.launches_dq, fa.launches_dq_tc)
    o, lse = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), "causal")
    fa.flash_attention_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), o, lse, torch.ones_like(o), "causal")
    assert (fa.launches, fa.launches_fwd_tc, fa.launches_dq, fa.launches_dq_tc) == before
    assert math.isfinite(float(lse.sum()))
