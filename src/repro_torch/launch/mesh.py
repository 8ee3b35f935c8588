"""Device meshes of the port, after the JAX package's ``launch/mesh.py``.

A mesh spans the ranks of the initialized ``torch.distributed`` process
group, one process per rank (``init_device_mesh``). The production pods'
builder (``make_production_mesh``) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math

__all__ = ["make_smoke_mesh"]


def make_smoke_mesh(shape=(2, 4), axes=("data", "model"), device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    process group, whose world size must be ``prod(shape)``. Its device type
    is ``"cuda"`` unless the caller passes ``device_type="cpu"`` (the CPU
    tests, over gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_smoke_mesh needs an initialized torch.distributed process group")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(device_type or "cuda", tuple(shape), mesh_dim_names=tuple(axes))
