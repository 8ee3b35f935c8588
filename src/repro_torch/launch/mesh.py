"""Device meshes of the port, after the JAX package's ``launch/mesh.py``.

A mesh spans the ranks of the initialized ``torch.distributed`` process
group, one process per rank (``init_device_mesh``): a real group on the
cards, or the fake group the dry run opens (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The production pod: a (16, 16) mesh of 256 ranks named ``("data",
    "model")``, or two pods, (2, 16, 16) of 512 named ``("pod", "data",
    "model")``, over the initialized process group (:func:`make_smoke_mesh`'s
    rules)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_smoke_mesh(shape, axes, device_type=device_type)


def make_smoke_mesh(shape=(2, 4), axes=("data", "model"), device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    process group, whose world size must be ``prod(shape)``. Its device type
    is ``"cuda"`` unless the caller passes ``device_type="cpu"`` (the CPU
    tests, over gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed process group")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(device_type or "cuda", tuple(shape), mesh_dim_names=tuple(axes))
