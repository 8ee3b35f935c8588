"""The port's flash-attention forward against the JAX package, on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention.flash_attention`` runs
its plain version; these tests hold that against the reference's ``_fwd``
(the Pallas kernel in interpret mode) on the cases of
``tests/test_flash_attention.py``, at that file's forward tolerance
(rtol = atol = 2e-5 on ``o`` and on ``lse``; 2e-2 for bfloat16 I/O), and the
port's ``attention`` on the kernel route against the reference's XLA path.
Inputs come from numpy seeds and go to both packages as the same arrays. The
Hopper kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _fwd
from repro.models.layers import attention as jax_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import attention

CSRC = Path(fa.__file__).resolve().parent / "csrc" / "flash_fwd.cu"

# (B, H, Hkv, S, D, kind, window, softcap, Bq, Bk): tests/test_flash_attention.py CASES
CASES = [
    (2, 4, 4, 128, 32, "causal", 0, 0.0, 32, 32),
    (1, 4, 1, 128, 32, "causal", 0, 0.0, 64, 32),  # MQA
    (2, 8, 2, 64, 16, "causal", 0, 0.0, 16, 16),  # GQA 4
    (1, 2, 2, 128, 32, "sliding", 48, 0.0, 32, 32),
    (1, 2, 2, 96, 16, "bidirectional", 0, 0.0, 32, 32),
    (1, 2, 1, 128, 32, "causal", 0, 30.0, 32, 64),  # softcap + GQA
]


def make_qkv(rng, B, H, Hkv, Sq, D, Sk=None):
    Sk = Sq if Sk is None else Sk
    q = (rng.normal(size=(B, H, Sq, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, Sk, D)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, Hkv, Sk, D)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,Hkv,S,D,kind,window,softcap,Bq,Bk", CASES)
def test_flash_forward_matches_reference_fwd(B, H, Hkv, S, D, kind, window, softcap, Bq, Bk):
    q, k, v = make_qkv(np.random.default_rng(B * 100 + S), B, H, Hkv, S, D)
    scale = D ** -0.5
    o_ref, lse_ref = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kind, window, softcap,
                          scale, Bq, Bk, True)
    o, lse = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                kind, window, softcap, scale)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-5, atol=2e-5)


def test_flash_bf16_io_matches_reference_fwd():
    q, k, v = make_qkv(np.random.default_rng(0), 1, 4, 4, 128, 32)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    o_ref, lse_ref = _fwd(*jb, "causal", 0, 0.0, 32 ** -0.5, 32, 32, True)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    o, lse = fa.flash_attention(*tb, "causal")
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_ref, np.float32), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-2, atol=2e-2)


def _jax_xla(q, k, v, kind, window, softcap):
    """The reference's XLA attention on (B, H, S, D) arrays, positions
    0..Sq-1 and 0..Sk-1."""
    out = jax_attention(
        jnp.moveaxis(jnp.asarray(q), 1, 2), jnp.moveaxis(jnp.asarray(k), 1, 2),
        jnp.moveaxis(jnp.asarray(v), 1, 2), q_pos=jnp.arange(q.shape[2]), kv_pos=jnp.arange(k.shape[2]),
        kind=kind, window=window, attn_softcap=softcap, impl="xla",
    )
    return np.moveaxis(np.asarray(out), 2, 1)


@pytest.mark.parametrize("Sq,Sk,kind,window", [
    (200, 200, "causal", 0),       # ragged: not a multiple of any tile
    (200, 200, "sliding", 37),
    (72, 200, "causal", 0),        # fewer queries than keys
    (150, 40, "sliding", 16),      # rows 55.. have no key in their window
    (150, 40, "sliding", 0),       # window 0: every row is fully masked
])
def test_flash_plain_version_matches_xla_at_ragged_lengths(Sq, Sk, kind, window):
    q, k, v = make_qkv(np.random.default_rng(Sq + Sk), 1, 4, 2, Sq, 16, Sk=Sk)
    o, _ = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kind, window, 20.0)
    np.testing.assert_allclose(o.numpy(), _jax_xla(q, k, v, kind, window, 20.0), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,kind,window,softcap,H,Hkv", [
    (128, "causal", 0, 0.0, 4, 4),
    (640, "causal", 0, 0.0, 2, 2),
    (640, "sliding", 100, 50.0, 4, 2),
    (640, "bidirectional", 0, 0.0, 4, 1),
])
def test_attention_flash_route_matches_xla(S, kind, window, softcap, H, Hkv):
    """At S = 640 the reference's own Pallas route is wrong: it gives the
    kernel 512-row blocks and a grid of S // 512, so rows 512..639 are never
    written and come out NaN (reference fault, ROADMAP.md Queue 3). The
    port must match the reference's XLA path there instead."""
    D = 16
    q, k, v = make_qkv(np.random.default_rng(S + H), 1, H, Hkv, S, D)
    want = _jax_xla(q, k, v, kind, window, softcap)
    before = fa.launches
    got = attention(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), q_pos=torch.arange(S), kv_pos=torch.arange(S),
        kind=kind, window=window, attn_softcap=softcap, impl="flash",
    )
    assert fa.launches == before  # CPU tensors: the plain version, no launch
    assert got.shape == (1, S, H, D)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=2e-5, atol=2e-5)


def _route_calls(monkeypatch):
    """Counts the calls ``attention`` makes to the flash wrapper."""
    from repro_torch.models import layers

    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return fa.flash_attention(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("S", [1, 72, 200, 640])
def test_attention_takes_the_flash_route_at_every_length(monkeypatch, S):
    """The reference's ``Sq >= 128`` and ``Sq % 128 == 0`` gate is not kept:
    the kernel masks ragged tiles, so any full self-attention goes to it."""
    calls = _route_calls(monkeypatch)
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in make_qkv(np.random.default_rng(S), 1, 4, 2, S, 16))
    kw = dict(q_pos=torch.arange(S), kv_pos=torch.arange(S), kind="sliding", window=50, attn_softcap=20.0)
    got = attention(q, k, v, impl="flash", **kw)
    assert calls == [(1, 4, S, 16)]
    torch.testing.assert_close(got, attention(q, k, v, impl="plain", **kw), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["prefix", "kv_valid", "Sq != Sk"])
def test_attention_keeps_the_plain_route_for_what_the_kernel_lacks(monkeypatch, case):
    calls = _route_calls(monkeypatch)
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in make_qkv(np.random.default_rng(9), 1, 4, 2, 64, 16))
    kw = dict(q_pos=torch.arange(64), kv_pos=torch.arange(64), kind="causal")
    if case == "prefix":
        kw.update(kind="prefix", prefix_len=torch.tensor(8))
    elif case == "kv_valid":
        kw.update(kv_valid=torch.ones((1, 64), dtype=torch.bool))
    else:
        q, kw["q_pos"] = q[:, :32], torch.arange(32)
    got = attention(q, k, v, impl="flash", **kw)
    assert calls == []
    torch.testing.assert_close(got, attention(q, k, v, impl="plain", **kw), rtol=0, atol=0)


def test_flash_tile_choice_fits_shared_memory():
    assert fa.SMEM_OPTIN_BYTES == 227 * 1024
    for D in fa.HEAD_DIMS:
        Bq, Bk = fa.flash_tile_sizes(D)
        assert (Bq, Bk) == (fa.BLOCK_Q, fa.BLOCK_K)
        assert fa.flash_smem_bytes(D) <= fa.SMEM_OPTIN_BYTES
    assert fa.flash_smem_bytes(256) == 213_760
    for D in (8, 48, 512):
        with pytest.raises(ValueError):
            fa.flash_tile_sizes(D)
    with pytest.raises(ValueError):
        fa.flash_tile_sizes(256, smem_budget=200_000)
    # the Python side's constants are the CUDA source's
    src = CSRC.read_text()
    assert re.search(rf"constexpr int kBQ = {fa.BLOCK_Q};", src)
    assert re.search(rf"constexpr int kBK = {fa.BLOCK_K};", src)
    assert tuple(int(d) for d in re.findall(r"FLASH_CASE\((\d+)\)", src)) == fa.HEAD_DIMS


def test_flash_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(np.random.default_rng(1), 1, 4, 2, 16, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, "prefix")
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :8], v, "causal")
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :3], k, v, "causal")  # H not a multiple of Hkv
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double(), "causal")


@pytest.fixture
def stand_in_build(monkeypatch, tmp_path):
    """``kernels.build`` with a stand-in compiler (there is no nvcc here),
    a fresh repository root and load cache, ``ctypes.CDLL`` returning the
    path it is given, and a record of compiler starts and waits."""
    import subprocess

    from repro_torch.kernels import build

    events = []

    class Popen(subprocess.Popen):
        def __init__(self, cmd, *a, **kw):
            events.append(("start", Path(cmd[-1]).stem))
            super().__init__(cmd, *a, **kw)

        def communicate(self, *a, **kw):
            events.append(("wait", None))
            return super().communicate(*a, **kw)

    monkeypatch.setattr(build, "_ROOT", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build.subprocess, "Popen", Popen)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    return build, events, monkeypatch


def test_library_builds_every_missing_source_together(stand_in_build):
    """The first ``library`` call starts one compiler per source before it
    waits for any; later calls load from disk and build nothing."""
    build, events, monkeypatch = stand_in_build
    monkeypatch.setattr(build, "_nvcc", lambda: "true")
    assert build.library("minplus") == str(build.build_dir() / "libminplus.so")
    assert events == [("start", "flash_bwd"), ("start", "flash_fwd"), ("start", "minplus")] + [("wait", None)] * 3
    for name in ("flash_bwd", "flash_fwd", "minplus"):
        assert (build.build_dir() / f"lib{name}.so").is_file()
        assert (build.build_dir() / f"{name}.log").is_file()
    events.clear()
    assert build.library("flash_fwd") == str(build.build_dir() / "libflash_fwd.so")
    assert build.library("minplus") == str(build.build_dir() / "libminplus.so")
    assert events == []


def test_library_raises_when_a_build_fails(stand_in_build):
    build, events, monkeypatch = stand_in_build
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed building flash_bwd.cu"):
        build.library("minplus")
    assert len(events) == 6  # every build ran to its end before the raise
    assert sorted(p.name for p in build.build_dir().iterdir()) == ["flash_bwd.log", "flash_fwd.log", "minplus.log"]


def test_time_builds_times_serial_and_parallel_builds(stand_in_build):
    build, events, monkeypatch = stand_in_build
    monkeypatch.setattr(build, "_nvcc", lambda: "true")
    t = build.time_builds()
    assert t["sources"] == ["flash_bwd", "flash_fwd", "minplus"] and t["serial_s"] >= 0 and t["parallel_s"] >= 0
    starts = [e for e in events if e[0] == "start"]
    assert starts == [("start", "flash_bwd"), ("start", "flash_fwd"), ("start", "minplus")] * 2
    assert events[:6] == [("start", "flash_bwd"), ("wait", None), ("start", "flash_fwd"), ("wait", None),
                          ("start", "minplus"), ("wait", None)]
    assert not (build._ROOT / "build" / "repro_torch_kernels" / "timing").exists()
