"""The flash backward kernels on a model's own gradients: the first dQ and
dK/dV launch of each kind (causal, sliding) in gemma2-2b FULL's train step
at ``chip_smoke.py`` phase 10's shape (B = 1, S = 8,192, bf16, remat
"full"; ``init_params`` from ``torch.Generator`` seed 0), held against the
plain float32 backward (``flash_attention_bwd_ref``, phase 9's limits) and
against a float64 backward formed the same way on the same inputs, the
kernel's forward ``o`` and ``lse`` among them (``chip_smoke.ref64``).

    python3 scripts/flash_bwd_model_grads.py [adafactor|adamw]

Prints the card's name and power limit, the step's loss, then for each kind
and each of dq, dk and dv: the largest |plain|, the kernel's largest
distance from the plain float32 backward, the limit's atol, how many
entries exceed the limit and the worst one (its ratio to the limit, the
plain, kernel and float64 values there), and the kernel's and the plain
float32 backward's distances from the float64 one (largest and relative
L2). Needs a CUDA card (about 1 minute, the kernels' build included).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import build_train_step
    from repro_torch.models import init_params, make_dummy_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    fa._launch_fn()
    fa._bwd_launch_fns()
    dev = torch.device("cuda")
    opt_name = sys.argv[1] if len(sys.argv) > 1 else "adafactor"
    cfg = get_config(cs.ARCH).replace(attn_impl="flash", optimizer=opt_name)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED))
    batch = make_dummy_batch(cfg, cs.B_TRAIN, cs.S_TRAIN, "train", np.random.default_rng(cs.SEED), device=dev)
    step, opt = build_train_step(cfg)
    seen = {}

    def record(out, q, k, v, o, lse, do, kind="causal", window=0, softcap=0.0, scale=None):
        if kind not in seen:
            seen[kind] = ([t.detach().clone() for t in (q, k, v, o, lse, do)], [t.detach().clone() for t in out],
                          window, softcap, scale)

    with cs.spying(fa, "flash_attention_bwd", record):
        params, state, loss = step(params, opt.init(params), batch)
    print(f"{cs.ARCH} train step ({opt_name}) loss {float(loss)}", flush=True)
    del params, state
    torch.cuda.empty_cache()
    for kind, (args, got, window, softcap, scale) in seen.items():
        q, k, v, o, lse, do = args
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        want = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse, do.float(), kind,
                                          window, softcap, scale)
        w64, d_lse, d_o = cs.ref64(fa, q, k, v, o, lse, do, kind, window, softcap, scale)
        print(f"{kind} window {window} softcap {softcap}: forward |lse - lse64| {d_lse:.3e}, |o - o64| {d_o:.3e}",
              flush=True)
        for name, g, w, w6 in zip(("dq", "dk", "dv"), got, want, w64):
            rtol, atol = cs.bwd_limits(w, q.dtype)
            d = (g.float() - w).abs()
            ratio = d / (atol + rtol * w.abs())
            i = int(ratio.argmax())
            at = tuple(int(x) for x in np.unravel_index(i, tuple(d.shape)))
            print(f"  {name}: max|plain| {float(w.abs().max()):.3e}, max|kernel - plain| {float(d.max()):.3e}, "
                  f"atol {atol:.3e}, over the limit {int((ratio > 1).sum())} of {d.numel()}, worst "
                  f"{float(ratio.max()):.3f}x the limit at {at} (plain {float(w.reshape(-1)[i]):.4e}, kernel "
                  f"{float(g.float().reshape(-1)[i]):.4e}, float64 {float(w6.reshape(-1)[i]):.4e}); from float64: "
                  f"kernel max {float((g.double() - w6).abs().max()):.3e} rel L2 "
                  f"{float((g.double() - w6).norm() / w6.norm()):.3e}, plain max "
                  f"{float((w.double() - w6).abs().max()):.3e} rel L2 {float((w.double() - w6).norm() / w6.norm()):.3e}",
                  flush=True)
        del want, w64
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
