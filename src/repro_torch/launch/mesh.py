"""Mesh builders of the port: ``torch.distributed`` device meshes.

The port's copy of the reference's ``launch/mesh.py``.  Functions, not
module-level constants: importing this module touches no device and no
process group.  Both builders need a live default process group whose
world size is the mesh's size: the dry run's is a fake one of 256 or 512
ranks (``launch/dryrun.py``), a real run's is NCCL or gloo.
"""
from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16x16 = 256 chips per pod ``("data", "model")``; 2 pods = 512 with a
    leading ``"pod"`` axis (the multi-pod dry run proves this axis
    shards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_local_mesh(shape=None, axes=("data", "model"), device_type=None):
    """A mesh over the ranks of the live process group (tests, the card's
    sharded step); ``shape`` None is (world, 1).  ``device_type`` None is
    "cuda" for an NCCL group and "cpu" otherwise."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _mesh(device_type, tuple(shape), tuple(axes))


def _mesh(device_type: str, shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
