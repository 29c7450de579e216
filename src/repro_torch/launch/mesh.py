"""Production mesh builders on ``torch.distributed.device_mesh``, with the
reference's axis names. Functions, not module constants: importing this
module touches no process group.

A mesh spans the default process group, which the caller initialises
(``init_process_group`` with an address or store, the world size and this
rank; NCCL for CUDA tensors, gloo for CPU ones) with as many ranks as the
mesh has places. ``fake_world`` makes such a group in one process, for a
trace that moves no data (the dry run): every rank but this one exists
only as a number.
"""
from __future__ import annotations

import contextlib
import math


def _mesh(shape: tuple, axes: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"torch.distributed initialised with {n} ranks "
                         f"(init_process_group)")
    if dist.get_world_size() != n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 chips/pod; multi_pod adds a 2-pod leading axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh(dp: int, tp: int, pods: int = 1, device_type: str = "cuda"):
    """Elastic mesh builder for arbitrary DP/TP splits (--dp/--tp)."""
    if pods > 1:
        return _mesh((pods, dp, tp), ("pod", "data", "model"), device_type)
    return _mesh((dp, tp), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks in this process, on
    torch's ``"fake"`` backend (``FakeStore``): this process is rank 0, and
    a collective returns at once without moving data. Destroyed on exit.
    Refuses to start over a default group that already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists; "
                           "destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (anything with ``mesh_dim_names`` and
    ``shape``, as a ``DeviceMesh``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """Mesh axes that carry data parallelism (pod axis folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh):
    return "model" if "model" in mesh.mesh_dim_names else None
