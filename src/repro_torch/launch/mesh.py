"""Meshes over ``torch.distributed`` (the reference's ``launch/mesh.py``).

Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model): 'pod' is an
additional pure-DP axis over the cross-pod links, so the only cross-pod
collective is the gradient reduction.

Functions, not module constants: importing this module touches no device
and no process group.  A mesh is a ``DeviceMesh`` with named dims; the
sharding rules (``launch/sharding.py``) read only its axis names and sizes,
so :class:`AbstractMesh` (names and sizes, no ranks) stands in for a
256- or 512-rank mesh wherever no collective runs.

:func:`init_distributed` starts the default process group: from the
``torchrun`` environment (``RANK``/``WORLD_SIZE``), from a ``file://``
init method with an explicit rank and world size, or else as a world of
one rank in this process over a ``HashStore`` (no network).  Its backend
is ``cpu:gloo,cuda:nccl`` where torch has NCCL, so one group serves CPU
and card tensors, and ``gloo`` where it has not.  With ``fake=True`` it
starts one rank of a fake world instead (torch's fake process group over
a ``FakeStore``: no peer runs, and a collective returns at once without
moving data), the 256- or 512-rank world of ``launch/dryrun.py``.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta

import torch

#: a hung collective fails after this long instead of hanging the job
DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no ranks behind it (the port's
    ``jax.sharding.AbstractMesh``): enough for the sharding rules."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an :class:`AbstractMesh`, in
    the mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def init_distributed(device='cuda', *, init_method=None, rank=None,
                     world_size=None, fake=False,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group unless one is running.  Returns
    True when this call started it (the caller then destroys it).

    ``init_method`` (e.g. ``file:///path``) needs ``rank`` and
    ``world_size``; without it the ``torchrun`` environment is read, and
    without that this process is a world of one rank.  ``fake=True``
    (with ``rank`` and ``world_size``) makes this process ``rank`` of a
    fake world of ``world_size`` ranks (module docstring)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = 'cpu:gloo,cuda:nccl' if dist.is_nccl_available() else 'gloo'
    timeout = timedelta(seconds=timeout_s)
    if torch.device(device).type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    if fake:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group('fake', store=FakeStore(), rank=rank,
                                world_size=world_size)
    elif init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timeout)
    elif 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        dist.init_process_group(backend, init_method='env://',
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return True


def _device_type(device) -> str:
    from repro_torch.core.export import resolve_device
    return resolve_device(device).type


def make_mesh(shape, axes, *, device='cuda'):
    """A DeviceMesh of ``shape`` named ``axes`` over every rank of the
    running world (ranks in row-major order).  Raises, naming the sizes,
    when the world does not have that many ranks, as ``jax.make_mesh``
    does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dtype = _device_type(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(
            f'a mesh of shape {tuple(shape)} {tuple(axes)} needs '
            f'{math.prod(shape)} ranks; the world has {world}')
    init_distributed(dtype)
    return init_device_mesh(dtype, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device='cuda'):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    return make_mesh(shape, axes, device=device)


def data_axes(mesh) -> tuple:
    """DP axes of a mesh (everything that is not 'model')."""
    return tuple(a for a in mesh_axes(mesh) if a != 'model')


def make_local_mesh(device='cuda'):
    """1x1 mesh over the single local device: the card unless the caller
    asks for the CPU.  Starts a world of one rank if no process group
    runs."""
    return make_mesh((1, 1), ('data', 'model'), device=device)
