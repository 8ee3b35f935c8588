"""Model API of the port: family dispatch, decode caches, dummy batches and
parameter/FLOPs accounting, after the JAX package's ``models/model.py``.

The port holds all six families of the reference's zoo: ``dense``,
``moe``, ``ssm`` (xLSTM), ``hybrid`` (Zamba2), ``encoder`` (HuBERT) and
``vlm`` (PaliGemma), each with its forward (prefill), loss (training),
decode cache and step (the encoder has neither: ``init_cache`` returns
``None`` and ``decode_fn`` raises, as in the reference). An unknown family
raises ``ValueError``. ``input_specs`` gives the dry run's stand-ins
(:mod:`repro_torch.launch.dryrun`): fake tensors of :func:`fake_mode`, which
carry shapes, dtypes and devices and allocate nothing.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import InputShape, ModelConfig
from ..core.torch_dp import resolve_device
from ..optim.optimizers import tree_leaves
from . import dense, encoder, hybrid, moe, vlm, xlstm

__all__ = [
    "active_param_count",
    "decode_fn",
    "expert_param_count",
    "fake_mode",
    "init_cache",
    "init_params",
    "input_specs",
    "layer_stacks",
    "loss_fn",
    "make_dummy_batch",
    "model_flops_per_token",
    "param_count",
    "prefill_fn",
    "supports_mode",
]

def init_params(cfg: ModelConfig, gen=0, device="cuda"):
    """Random parameters. ``gen`` is a ``torch.Generator`` (its device is
    used) or an int seed for a new generator on ``device``."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen))
    if cfg.family == "dense":
        return dense.init_dense(cfg, gen)
    if cfg.family == "moe":
        return moe.init_moe_model(cfg, gen)
    if cfg.family == "ssm":
        return xlstm.init_xlstm(cfg, gen)
    if cfg.family == "hybrid":
        return hybrid.init_zamba(cfg, gen)
    if cfg.family == "encoder":
        return encoder.init_hubert(cfg, gen)
    if cfg.family == "vlm":
        return vlm.init_paligemma(cfg, gen)
    raise ValueError(cfg.family)


def loss_fn(params, cfg: ModelConfig, batch):
    """The training objective, a float32 scalar that carries a gradient when
    grad mode is on and a parameter requires one: for the LMs
    (``batch["tokens"]``) the mean next-token cross-entropy (MoE: plus the
    router and MTP terms; vlm: of the text after ``batch["patches"]``), for
    the encoder the masked prediction of ``batch["labels"]`` at
    ``batch["mask"]`` from ``batch["frames"]``."""
    if cfg.family == "dense":
        return dense.dense_loss(params, cfg, batch)
    if cfg.family == "moe":
        return moe.moe_loss(params, cfg, batch)
    if cfg.family == "ssm":
        return xlstm.xlstm_loss(params, cfg, batch)
    if cfg.family == "hybrid":
        return hybrid.zamba_loss(params, cfg, batch)
    if cfg.family == "encoder":
        return encoder.hubert_loss(params, cfg, batch)
    if cfg.family == "vlm":
        return vlm.paligemma_loss(params, cfg, batch)
    raise ValueError(cfg.family)


def _no_autograd(params):
    """``torch.inference_mode``, or ``torch.no_grad`` on DTensor parameters
    (a DTensor view made in inference mode of a tensor made outside it
    fails: it cannot share the version counter)."""
    from torch.distributed.tensor import DTensor

    leaves = tree_leaves(params)
    return torch.no_grad() if leaves and isinstance(leaves[0], DTensor) else torch.inference_mode()


def prefill_fn(params, cfg: ModelConfig, batch):
    """Forward over the full sequence: ``batch["tokens"] (B, S)`` -> float32
    logits ``(B, S, V)`` (encoder: ``batch["frames"] (B, S, F)``, no mask;
    vlm: logits over the text positions after ``batch["patches"]``), on the
    device of the parameters. Runs without autograd (:func:`_no_autograd`)."""
    with _no_autograd(params):
        if cfg.family == "dense":
            return dense.dense_forward(params, cfg, batch["tokens"])[0]
        if cfg.family == "moe":
            return moe.moe_forward(params, cfg, batch["tokens"])[0]
        if cfg.family == "ssm":
            return xlstm.xlstm_forward(params, cfg, batch["tokens"])[0]
        if cfg.family == "hybrid":
            return hybrid.zamba_forward(params, cfg, batch["tokens"])[0]
        if cfg.family == "encoder":
            return encoder.hubert_forward(params, cfg, batch["frames"])
        if cfg.family == "vlm":
            return vlm.paligemma_forward(params, cfg, batch["patches"], batch["tokens"])[0]
    raise ValueError(cfg.family)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """A zero decode cache for ``batch`` sequences of up to ``max_len``
    tokens, on ``device`` (layouts: :mod:`repro_torch.models.dense`,
    :mod:`repro_torch.models.moe`, :mod:`repro_torch.models.xlstm` (a
    recurrent state that ``max_len`` does not size),
    :mod:`repro_torch.models.hybrid`; vlm: the dense cache). The encoder
    has none: ``None``."""
    if cfg.family == "dense":
        return dense.init_dense_cache(cfg, batch, max_len, device)
    if cfg.family == "moe":
        return moe.init_moe_cache(cfg, batch, max_len, device)
    if cfg.family == "ssm":
        return xlstm.init_xlstm_cache(cfg, batch, max_len, device)
    if cfg.family == "hybrid":
        return hybrid.init_zamba_cache(cfg, batch, max_len, device)
    if cfg.family == "vlm":
        return vlm.init_paligemma_cache(cfg, batch, max_len, device)
    if cfg.family == "encoder":
        return None
    raise ValueError(cfg.family)


def decode_fn(params, cfg: ModelConfig, cache, tokens, pos):
    """One decode step: ``tokens (B, 1)`` at position ``pos`` (a Python int
    or a 0-d integer tensor; no host sync) -> ``(logits (B, 1, V), cache)``.
    KV caches are updated in place and returned; recurrent states (xLSTM's,
    Zamba2's conv and SSD states) are returned new. Runs without autograd
    (:func:`_no_autograd`). The encoder has no decode step: ``ValueError``."""
    with _no_autograd(params):
        if cfg.family == "dense":
            return dense.dense_decode_step(params, cfg, cache, tokens, pos)
        if cfg.family == "moe":
            return moe.moe_decode_step(params, cfg, cache, tokens, pos)
        if cfg.family == "ssm":
            return xlstm.xlstm_decode_step(params, cfg, cache, tokens, pos)
        if cfg.family == "hybrid":
            return hybrid.zamba_decode_step(params, cfg, cache, tokens, pos)
        if cfg.family == "vlm":
            return vlm.paligemma_decode_step(params, cfg, cache, tokens, pos)
    raise ValueError(f"{cfg.family} has no decode step")


def supports_mode(cfg: ModelConfig, shape: InputShape) -> tuple:
    """(supported, reason): the documented skips of the reference."""
    if cfg.family == "encoder" and shape.mode == "decode":
        return False, "encoder-only: no autoregressive decode"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.attn_kind == "local_global"
        if not sub_quadratic:
            return False, "full-attention arch: 500k context skipped (quadratic)"
    return True, ""


def layer_stacks(cfg: ModelConfig) -> Dict[str, tuple]:
    """The leading axes the reference stacks each list of layers on: the
    dense stack on ``(n_groups, period)``, the MoE model's lists on
    ``(n,)``, xLSTM's mLSTM blocks on ``(n_groups, period - 1)`` and its
    sLSTM blocks on ``(n_groups,)``, Zamba2's Mamba2 blocks on ``(n_groups,
    period)``; the encoder's and the VLM's layers, like the dense stack, on
    ``(n_groups, period)`` with period 1. Adafactor factors and clips the
    stacked leaves (:func:`repro_torch.optim.adafactor`'s ``stacks``)."""
    if cfg.family == "moe":
        return {"moe_layers": (cfg.num_layers - cfg.dense_prefix_layers,),
                "dense_layers": (cfg.dense_prefix_layers,)}
    if cfg.family == "ssm":
        G = cfg.num_layers // cfg.slstm_every
        return {"mlstm": (G, cfg.slstm_every - 1), "slstm": (G,)}
    if cfg.family == "hybrid":
        return {"mamba": (cfg.num_layers // cfg.shared_attn_every, cfg.shared_attn_every)}
    if cfg.family in ("dense", "encoder", "vlm"):
        period = len(dense.attn_pattern(cfg))
        return {"layers": (cfg.num_layers // period, period)}
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# input specs (fake-tensor stand-ins; no allocation)
# ---------------------------------------------------------------------------

_FAKE_MODE = None


def fake_mode():
    """The process's ``FakeTensorMode`` (one, so that stand-ins made at
    different times meet in one step; real tensors that meet them, such as
    a mesh's, are taken as constants). Tensors made under it carry shape,
    dtype and device and allocate nothing; ops on them compute shapes
    only. ``FakeTensorMode`` is a private torch module, imported here on
    first use."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE_MODE


def _batch_struct(cfg: ModelConfig, B: int, S: int, mode: str, device="cuda") -> Dict[str, Any]:
    """The batch of :func:`make_dummy_batch` as fake tensors on ``device``
    (integers int64, the port's token dtype; the encoder's frames and the
    VLM's patches in the compute dtype, as the reference's stand-ins)."""
    dev = resolve_device(device)
    i64, cd = torch.int64, cfg.cdtype()
    with fake_mode():
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        if cfg.family == "encoder":
            return {"frames": empty((B, S, cfg.frame_dim), cd), "mask": empty((B, S), torch.bool),
                    "labels": empty((B, S), i64)}
        extra = 1 if mode == "train" else 0
        if cfg.family == "vlm":
            S_txt = max(S - cfg.num_patches, 16)
            return {"patches": empty((B, cfg.num_patches, cfg.patch_dim), cd), "tokens": empty((B, S_txt + extra), i64)}
        if cfg.use_mtp and mode == "train":
            extra = 2
        return {"tokens": empty((B, S + extra), i64)}


def input_specs(cfg: ModelConfig, shape: InputShape, device="cuda") -> Dict[str, Any]:
    """Dry-run stand-ins for one (arch, input-shape) pair, as fake tensors on
    ``device`` (:func:`fake_mode`).

    train/prefill: ``{"batch": batch}``. decode: ``{"cache", "tokens" (B,
    1), "pos" ()}``, the cache made by :func:`init_cache` under the fake
    mode, so nothing is allocated at any length (the reference builds a
    concrete cache here); tokens and position int64, the port's dtype."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        return {"batch": _batch_struct(cfg, B, S, shape.mode, device)}
    dev = resolve_device(device)
    with fake_mode():
        return {
            "cache": init_cache(cfg, B, S, dev),
            "tokens": torch.empty((B, 1), dtype=torch.int64, device=dev),
            "pos": torch.empty((), dtype=torch.int64, device=dev),
        }


def make_dummy_batch(cfg: ModelConfig, B: int, S: int, mode: str, rng: np.random.Generator,
                     device="cuda") -> Dict[str, Any]:
    """A random batch from a numpy generator, drawn as the reference draws
    it, on ``device``; integers as int64, floats as float32. LMs: tokens
    ``(B, S)``, plus one target column in ``train`` mode (two with MTP).
    Encoder: ``frames (B, S, frame_dim)``, ``mask (B, S)`` (30% of frames
    masked) and ``labels (B, S)``. vlm: ``patches (B, num_patches,
    patch_dim)`` and ``max(S - num_patches, 16)`` tokens (plus the target
    column in ``train`` mode)."""
    dev = resolve_device(device)

    def ints(a):
        return torch.from_numpy(a.astype(np.int32)).long().to(dev)

    def floats(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    extra = 1 if mode == "train" else 0
    if cfg.family == "encoder":
        frames = floats(rng.normal(size=(B, S, cfg.frame_dim)))
        mask = torch.from_numpy(rng.random((B, S)) < 0.3).to(dev)
        return {"frames": frames, "mask": mask, "labels": ints(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        S_txt = max(S - cfg.num_patches, 16)
        patches = floats(rng.normal(size=(B, cfg.num_patches, cfg.patch_dim)))
        return {"patches": patches, "tokens": ints(rng.integers(0, cfg.vocab_size, (B, S_txt + extra)))}
    if cfg.use_mtp and mode == "train":
        extra = 2
    return {"tokens": ints(rng.integers(0, cfg.vocab_size, (B, S + extra)))}


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))


def expert_param_count(params) -> int:
    """Entries of every leaf under a key named ``experts``."""
    def visit(tree, under):
        if isinstance(tree, dict):
            return sum(visit(x, under or k == "experts") for k, x in tree.items())
        if isinstance(tree, list):
            return sum(visit(x, under) for x in tree)
        return tree.numel() if under else 0

    return int(visit(params, False))


def active_param_count(params, cfg: ModelConfig) -> int:
    """Active parameters per token: routed experts count at ``top_k / E``."""
    total = param_count(params)
    if cfg.num_experts:
        ep = expert_param_count(params)
        total = total - ep + int(ep * cfg.top_k / cfg.num_experts)
    return total


def model_flops_per_token(params, cfg: ModelConfig, seq_len: int, mode: str = "train") -> float:
    """MODEL_FLOPS (6·N·D accounting) per token: 6·N_active for train
    (fwd+bwd), 2·N_active for inference, plus, for the attention families
    (dense, moe, vlm, encoder; not ssm or hybrid), the attention term
    12·L·d_attn·S (train) or 4·L·d_attn·S (inference), halved for
    causality, as the reference counts it."""
    mult = 6.0 if mode == "train" else 2.0
    flops = mult * active_param_count(params, cfg)
    if cfg.family in ("dense", "moe", "vlm", "encoder"):
        attn_mult = 12.0 if mode == "train" else 4.0
        flops += attn_mult * cfg.num_layers * cfg.hd * cfg.num_heads * min(seq_len, 10**9) / 2
    return float(flops)
