"""Federated-learning runtime of the port: so far the device energy model
(:mod:`.energy`) and the deterministic fault injection (:mod:`.faults`),
numpy copies of the JAX package's modules. The server, clients, campaign
pipeline, rounds, adaptive planning and the toy model come with the FL
runtime's slice."""

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

__all__ = [
    "ClientFault",
    "DeviceProfile",
    "EnergyEstimator",
    "FaultInjector",
    "FaultPlan",
    "FlakyEngine",
    "RoundFaults",
    "flops_scaled_tables",
    "make_fleet",
    "proportional_greedy",
    "residual_problem",
]
