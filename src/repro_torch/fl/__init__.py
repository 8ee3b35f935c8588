"""Federated-learning runtime of the port, after the JAX package's ``fl/``:
the server (``server.py``), client local training (``client.py``), the
campaign pipeline and its checkpoints (``pipeline.py``, ``rounds.py``),
adaptive planning under drift (``adaptive.py``), the device energy model
(``energy.py``), the deterministic fault injection (``faults.py``) and the
toy LM (``toy.py``)."""

from .adaptive import (
    AdaptiveCoordinator,
    AdaptiveRoundStats,
    DriftDetector,
    DriftInjector,
    DriftPlan,
    WatermarkStats,
    watermark_split,
)
from .client import local_train, make_client_fn
from .energy import DeviceProfile, EnergyEstimator, flops_scaled_tables, make_fleet
from .faults import (
    ClientFault,
    FaultInjector,
    FaultPlan,
    FlakyEngine,
    RoundFaults,
    proportional_greedy,
    residual_problem,
)
from .pipeline import (
    AsyncCampaignRunner,
    CampaignHistory,
    CampaignRunner,
    PipelineStats,
    PlanFuture,
    SerialPlanExecutor,
    ThreadPlanExecutor,
    load_campaign_checkpoint,
    save_campaign_checkpoint,
)
from .rounds import run_campaign
from .server import (
    FederatedServer,
    FLRoundResult,
    PlanPolicy,
    RecoveryInfo,
    RoundPlan,
    ScenarioReport,
    apply_dropout,
)

__all__ = [
    "local_train", "make_client_fn", "DeviceProfile", "EnergyEstimator",
    "make_fleet", "flops_scaled_tables", "FederatedServer", "FLRoundResult", "PlanPolicy", "RoundPlan",
    "ScenarioReport", "apply_dropout", "CampaignHistory", "run_campaign",
    "AsyncCampaignRunner", "CampaignRunner", "PipelineStats", "PlanFuture",
    "SerialPlanExecutor", "ThreadPlanExecutor",
    "ClientFault", "FaultInjector", "FaultPlan", "FlakyEngine", "RoundFaults",
    "RecoveryInfo", "proportional_greedy", "residual_problem",
    "load_campaign_checkpoint", "save_campaign_checkpoint",
    "AdaptiveCoordinator", "AdaptiveRoundStats", "DriftDetector",
    "DriftInjector", "DriftPlan", "WatermarkStats", "watermark_split",
]
