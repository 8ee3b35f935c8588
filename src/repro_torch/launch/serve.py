"""Serving launcher, after the JAX package's ``launch/serve.py``: batched
greedy decoding against a decode cache (a KV cache; for xlstm-1.3b a
recurrent state, for zamba2-2.7b both). paligemma-3b serves text only, as
in the reference: the prompts go through its decoder's cache without an
image. hubert-xlarge is refused (encoder-only: no decode).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma2-2b --batch 4 --prompt-len 32 --gen 16

Teacher-forces a batch of synthetic prompts through the decode step (which
fills the cache), then steps the serve loop, one token per sequence per
step. Runs on the card unless ``--device cpu`` is given; MoE configs
dispatch their experts with ``moe_impl="einsum"``, as in the reference.

:func:`generate` is the loop, for callers that bring their own parameters;
:func:`main` draws random weights from ``torch.Generator`` seed ``--seed``
and the prompts from ``np.random.default_rng(--seed)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import INPUT_SHAPES, ModelConfig
from ..core.torch_dp import resolve_device
from ..models import init_cache, init_params, supports_mode
from .steps import build_serve_step

__all__ = ["generate", "main", "parse_args", "serve_config"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="batched greedy decoding with a KV cache")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the model runs")
    return ap.parse_args(argv)


def serve_config(cfg: ModelConfig) -> ModelConfig:
    """The config the serve loop runs: refused where the reference refuses
    ``decode_32k``; MoE experts dispatched by ``einsum``."""
    ok, reason = supports_mode(cfg, INPUT_SHAPES["decode_32k"])
    if not ok:
        raise SystemExit(f"{cfg.arch}: {reason}")
    return cfg.replace(moe_impl="einsum") if cfg.num_experts else cfg


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, gen: int):
    """Teacher-forces ``prompts (B, P)`` through the serve step at positions
    ``0 .. P-1`` (filling a fresh cache of ``P + gen`` slots), then decodes
    ``gen`` greedy tokens at ``P .. P+gen-1``. Tokens stay on the device
    between steps, so the loop does not wait on the card per token.
    Returns ``(tokens (B, gen), cache, (prefill_s, decode_s))``, the times
    on the host clock up to a device sync."""
    B, P = prompts.shape
    dev = prompts.device
    cache = init_cache(cfg, B, P + gen, device=dev)
    step = build_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    nxt = prompts[:, :1]
    for t in range(P):
        nxt, cache = step(params, cache, prompts[:, t:t + 1], t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    tok = nxt
    t0 = time.perf_counter()
    for t in range(P, P + gen):
        generated.append(tok)
        tok, cache = step(params, cache, tok, t)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    out = torch.cat(generated, dim=1) if generated else prompts[:, :0]
    return out, cache, (t_prefill, t_gen)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = serve_config(get_config(args.arch, smoke=args.smoke))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).long().to(dev)

    out, _, (t_prefill, t_gen) = generate(params, cfg, prompts, G)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"arch={cfg.arch} batch={B} prompt={P} gen={G}")
    print(f"prefill {t_prefill:.2f}s | decode {t_gen:.2f}s ({B * G / max(t_gen, 1e-9):.1f} tok/s on {where})")
    out = out.cpu().numpy()
    for b in range(min(B, 2)):
        print(f"  seq{b}: {out[b][:12].tolist()} ...")


if __name__ == "__main__":
    main()
