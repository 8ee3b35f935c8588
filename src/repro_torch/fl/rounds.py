"""FL campaign driver: multi-round orchestration + energy accounting.

The loop itself lives in :mod:`repro_torch.fl.pipeline` (DESIGN.md §11) — ONE
code path over the server's ``plan -> train -> aggregate`` stages, run
either serially or with a background planner thread that overlaps round
*r*'s client training with round *r+1*'s scenario planning. This module
keeps the stable entry point: :func:`run_campaign`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .pipeline import CampaignHistory, CampaignRunner
from .server import FederatedServer, FLRoundResult

__all__ = ["CampaignHistory", "run_campaign"]


def run_campaign(
    server: FederatedServer,
    examples_per_client: list,
    num_rounds: int,
    round_T: int,
    batch_size: int,
    rng: np.random.Generator,
    max_steps: Optional[int] = None,
    on_round: Optional[Callable[[FLRoundResult], None]] = None,
    pipelined: bool = False,
    faults=None,
    drift=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
) -> CampaignHistory:
    """Runs ``num_rounds`` FedAvg rounds with ``round_T`` total mini-batches
    scheduled across clients each round.

    ``pipelined=False`` plans inline (the reference path); ``pipelined=True``
    moves every DP solve onto a background planner thread that overlaps with
    client training — schedules, losses, and energy accounting are
    bit-identical either way (asserted in tests/test_torch_fl_pipeline.py), only
    the wall-clock interleaving changes. The history's ``pipeline_stats``
    reports how much planning time the pipeline hid (``overlap_fraction``).

    The history's ``dp_cache_stats`` records the counter deltas on the
    SERVER'S sweep engine over the campaign: with warm (or repeating)
    shapes this shows one compile at most — rounds 2+ are compile-free.
    Caveat: a server left on the process-wide default engine shares those
    counters with every other ``schedule_batch``/``deadline_sweep`` caller,
    so concurrent solver traffic (including from an ``on_round`` callback)
    lands in the delta too. Pass ``FederatedServer(engine=SweepEngine())``
    when the accounting must isolate this campaign.

    ``faults`` (a :class:`~repro_torch.fl.faults.FaultPlan` or
    :class:`~repro_torch.fl.faults.FaultInjector`) arms the deterministic
    fault-injection layer; ``drift`` (a :class:`~repro_torch.fl.adaptive.DriftPlan`
    or :class:`~repro_torch.fl.adaptive.DriftInjector`) arms deterministic
    per-round energy-cost drift on the TRUE simulator tables;
    ``checkpoint_dir``/``checkpoint_every`` arm round-granular
    checkpoint/resume — all fully inert when unset (DESIGN.md §17–18).
    """
    runner = CampaignRunner(server, mode="pipelined" if pipelined else "serial")
    return runner.run(
        examples_per_client,
        num_rounds,
        round_T,
        batch_size,
        rng,
        max_steps=max_steps,
        on_round=on_round,
        faults=faults,
        drift=drift,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
    )
