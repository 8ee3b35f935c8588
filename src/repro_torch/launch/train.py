"""FL training launcher, after the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch gemma2-2b --full --rounds 10 --clients 6 --algorithm auto

Uses the architecture's (reduced, unless ``--full``) config as the FL model,
a simulated heterogeneous fleet, and the paper's scheduler for the per-round
workload split. Clients train on the card unless ``--device cpu`` is given.
On real hardware, point the estimator at measured device profiles instead of
the simulator.

The steps are split so a driver can run the launcher in-process:
:func:`parse_args`, :func:`make_world` (fleet, estimator, client data),
:func:`build_campaign` (the model and the server) and :func:`run` (the
campaign; returns the server and the history).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.fleet import PlanPolicy
from ..core.sweep import default_engine
from ..data import client_corpora, make_lm_examples
from ..fl import EnergyEstimator, FederatedServer, make_fleet, run_campaign
from ..models import init_params, loss_fn, param_count
from ..optim import sgd

__all__ = ["Campaign", "build_campaign", "main", "make_world", "parse_args", "run"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="FL training with energy-minimal round schedules")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-batches", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--algorithm", default="auto")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where clients train and rounds are planned")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Campaign:
    cfg: ModelConfig
    server: FederatedServer
    examples: list  # per client, (num_examples, seq + 1) int32 windows
    rng: np.random.Generator  # the campaign's stream, after the set-up draws
    round_T: int


def make_world(args, vocab_size: int):
    """The simulated fleet and its data, drawn from ``np.random.default_rng(
    args.seed)`` in the reference's order: ``(estimator, examples, rng,
    round_T)`` with ``round_T = Σ max_batches // 2``. Planning sees only
    these, never the model."""
    rng = np.random.default_rng(args.seed)
    fleet = make_fleet(rng, args.clients, max_batches=args.max_batches)
    est = EnergyEstimator(fleet)
    est.calibrate(rng)
    corpora = client_corpora(rng, args.clients, args.seq * 120, vocab_size)
    examples = [make_lm_examples(c, args.seq) for c in corpora]
    return est, examples, rng, sum(d.max_batches for d in fleet) // 2


def build_campaign(args, log: Callable[[str], None] = print) -> Campaign:
    """The model (random weights from ``torch.Generator`` seed ``args.seed``
    on ``args.device``) and the server, planning with ``args.algorithm`` on
    the shared engine of ``args.device``."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise SystemExit(f"{args.arch} ({cfg.family}) is not an LM; pick a decoder arch")
    params = init_params(cfg, args.seed, device=args.device)
    log(f"arch={cfg.arch} ({'smoke' if args.smoke else 'full'}): {param_count(params) / 1e6:.2f}M params")
    est, examples, rng, T = make_world(args, cfg.vocab_size)
    server = FederatedServer(
        loss_fn=lambda p, b: loss_fn(p, cfg, {"tokens": b}),
        init_params=params,
        client_optimizer=sgd(args.lr),
        estimator=est,
        policy=PlanPolicy(algorithm=args.algorithm, engine=default_engine(device=args.device)),
    )
    return Campaign(cfg, server, examples, rng, T)


def run(args, campaign: Optional[Campaign] = None, on_round=None, log: Callable[[str], None] = print):
    """Runs the campaign (built by :func:`build_campaign` unless given) and
    returns ``(server, history)``; saves the final parameters when
    ``args.checkpoint_dir`` is set."""
    c = campaign if campaign is not None else build_campaign(args, log)

    def report(r):
        log(f"round {r.round_index:3d} loss {r.mean_loss:.4f} energy {r.energy_joules:7.1f} J x={r.assignments.tolist()}")
        if on_round is not None:
            on_round(r)

    t0 = time.time()
    hist = run_campaign(c.server, c.examples, args.rounds, round_T=c.round_T, batch_size=args.batch, rng=c.rng,
                        on_round=report)
    log(f"\nwall {time.time() - t0:.1f}s  {hist.summary()}")
    if args.checkpoint_dir:
        path = save_checkpoint(args.checkpoint_dir, args.rounds, c.server.params,
                               extra={"arch": c.cfg.arch, "algorithm": args.algorithm})
        log(f"checkpoint: {path}")
    return c.server, hist


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
