"""Production meshes. A FUNCTION, not a module constant — importing this
module never touches process-group state (the dry-run sets up its own
group first).

Single pod: (data=16, model=16) = 256 devices.
Multi pod:  (pod=2, data=16, model=16) = 512 devices; the 'pod' axis
folds into data-parallel batch by default. GPipe-style pipeline
parallelism over 'pod' lives in :mod:`repro_torch.launch.pipeline`.

Both build a ``DeviceMesh`` over the default process group, which must
have the mesh's size: the dry-run (``launch.dryrun``) makes a ``fake``
group of 256 or 512 ranks in one process for that.
"""
from __future__ import annotations

import math


def _mesh(shape: tuple, axes: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the default process group "
            f"has {have} (the dry-run sets up a fake group of {n} ranks: "
            f"python -m repro_torch.launch.dryrun)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh on "cpu", as the dry-run's fake
    group needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "cpu")


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type="cuda"):
    """A small mesh over a default group of its size (tests pass
    ``"cpu"``)."""
    return _mesh(tuple(shape), tuple(axes), device_type)
