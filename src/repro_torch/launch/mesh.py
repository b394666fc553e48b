"""Production mesh construction (the port's copy of `repro/launch/mesh.py`).

Functions, never module-level constants, so importing this module touches
no process group. Single pod: 16x16 = 256 ranks ("data", "model");
multi-pod: 2x16x16 = 512 ranks with a leading "pod" axis (the
data-parallel batch shards over ("pod", "data") jointly). Both need a
process group of that many ranks: `launch.dryrun` builds one on the `fake`
backend (`fake_process_group`), where nothing is communicated.
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["SINGLE", "MULTI", "make_production_mesh", "make_smoke_mesh", "fake_process_group"]

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape, names = MULTI if multi_pod else SINGLE
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_smoke_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1-rank mesh with the production axis names."""
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=SINGLE[1])


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of `world_size` ranks on the `fake` backend (this
    process is rank 0; collectives return at once and move nothing), torn
    down on exit. For counting on the production meshes without their
    cards."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
