"""Meshes for the multi-device dry run (the port of
``repro/launch/mesh.py``).

The reference forces 512 fake host devices through an XLA flag that must
precede jax's first import.  The port's counterpart is a *fake process
group*: ``torch.distributed`` with the ``fake`` backend, whose
collectives issue nothing, at a world size equal to the mesh's number of
ranks, and one per process.  A ``DeviceMesh`` over it places DTensors on
(16, 16) = 256 ranks, or (2, 16, 16) = 512 multi-pod, while this process
holds rank 0's shards.  The group is created by the first mesh built and
refused at any other size; :func:`destroy_fake_process_group` drops it,
so one process can build meshes of two sizes in turn.

``client_mesh`` is the other kind: a real process group (gloo or NCCL,
one process a rank) and the 1-D ``("data",)`` mesh the round's client
axis shards over (``sharding/clients.py``).

Meshes are built by FUNCTIONS, never at import.  Their device type is
``cuda`` unless the caller passes ``device="cpu"``; without a GPU, asking
for ``cuda`` raises, as every entry point of the port does.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def fake_process_group(world_size: int) -> None:
    """Create the process's fake group of ``world_size`` ranks (this
    process is rank 0), or check that the one there has that size."""
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world_size:
            raise RuntimeError(
                f"a process group of {have} ranks exists; a mesh of "
                f"{world_size} needs destroy_fake_process_group() first")
        return
    # torch's testing module holds the store of the fake backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_fake_process_group() -> None:
    """Drop the process's group (and with it every mesh over it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape: tuple, names: tuple, device):
    dev = resolve_device(device)
    fake_process_group(math.prod(shape))
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def client_mesh(ranks: int, *, backend: str, device=None, rank=None,
                init_method=None):
    """The 1-D ``("data",)`` mesh of ``ranks`` processes for the round's
    client axis.  Joins the process group first where there is none
    (``rank`` and ``init_method``, e.g. ``"tcp://localhost:29500"``, are
    then required: nothing on the machine names a cluster); an existing
    group must have ``ranks`` ranks and the ``backend`` asked for."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if rank is None or init_method is None:
            raise ValueError("joining a process group needs rank= and "
                             "init_method=")
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(rank), world_size=int(ranks))
    have = (dist.get_world_size(), dist.get_backend())
    if have != (int(ranks), backend):
        raise RuntimeError(f"the process group has {have[0]} ranks on "
                           f"{have[1]}, not {ranks} on {backend}")
    return init_device_mesh(dev.type, (int(ranks),), mesh_dim_names=("data",))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1, *, device=None):
    """A small ("data", "model") mesh (tests, and the one-card tie)."""
    return _mesh((data, model), ("data", "model"), device)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or of anything with
    ``mesh_dim_names`` and ``shape``, which is all the spec builders
    read)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
