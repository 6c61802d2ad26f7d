"""Mesh construction on ``torch.distributed``.  Twin of
``repro.launch.mesh``.

A mesh is a ``DeviceMesh`` over the running world's ranks whose dim names
are the JAX axis names.  Importing this module touches no device and starts
no process group: each function does what it needs when it is called.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.sharding import mesh_axis_sizes


def _start_world_of_one(device_type: str) -> None:
    """A process group of one rank over an in-memory ``HashStore``: no
    network port, so concurrent test workers cannot collide, and no file
    left behind.  NCCL on the card (after ``set_device(0)``), gloo on the
    CPU."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_type='cpu'")
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A world of ``world_size`` ranks in this one process, as rank 0, on
    torch's ``fake`` backend (``torch.testing._internal.distributed.
    fake_pg``): its collectives return at once and move no data, so the
    production meshes build on a host with no card, as JAX builds them on
    512 fake host devices.  The group is destroyed on exit, error or not;
    a running group is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is running already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks) over
    the running world, which must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a running "
            f"world of {want} ranks, found {have or 'no process group'}")
    return DeviceMesh(device_type, torch.arange(want).reshape(shape),
                      mesh_dim_names=axes)


def make_debug_mesh(n_devices: int | None = None, model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the first ``n_devices`` ranks (all of
    them by default).  Without a running process group it starts a world of
    one rank as the process's default group: the caller then owns it and
    ends it with ``torch.distributed.destroy_process_group()``."""
    if not dist.is_initialized():
        _start_world_of_one(device_type)
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"{n} devices asked of a world of {world}")
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh) -> int:
    return math.prod(mesh_axis_sizes(mesh).values())
