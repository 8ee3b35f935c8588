"""Launchers of the port: the mesh context and sharding rules
(``sharding.py``, ``mesh.py``), step builders (``steps.py``), the FL training
launcher (``train.py``, ``python -m repro_torch.launch.train``), the
serving launcher (``serve.py``, ``python -m repro_torch.launch.serve``) and
the dry run (``dryrun.py``, ``python -m repro_torch.launch.dryrun``, its own
process; with the per-device cost counter ``hlo_analysis.py`` and the H100
roofline ``roofline.py``) and the sharding hill-climb over it
(``hillclimb.py``, ``python -m repro_torch.launch.hillclimb``, its own
process).

The step builders load on first use: the models import ``sharding`` from
this package, and ``steps`` imports the models."""

from .sharding import current_mesh, mesh_context, param_pspecs, set_mesh, shard

_STEPS = ("build_prefill_step", "build_serve_step", "build_train_step", "value_and_grad")

__all__ = ["set_mesh", "current_mesh", "mesh_context", "shard", "param_pspecs", *_STEPS]


def __getattr__(name):
    if name in _STEPS:
        from . import steps

        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
