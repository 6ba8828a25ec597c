"""Meshes (``repro.launch.mesh``): the production meshes and the host mesh.

Functions, not module constants, so importing this module starts no
process group.  Single pod: 16 x 16 = 256 devices (``data``, ``model``).
Multi-pod: 2 x 16 x 16 = 512 devices (``pod``, ``data``, ``model``); the
``pod`` axis is an extra data-parallel dimension whose collectives cross
the inter-pod links.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group of the whole world, ranks laid out row-major.  The sharding
rules read only axis names and sizes, so ``make_abstract_mesh`` gives
them a shape-only stand-in that needs no process group.

A process has one default process group.  So the production meshes,
which run over a fake group of 256 or 512 ranks that moves no data (the
dry-run), and the host mesh, over a real one-rank group, cannot live in
one process: whichever comes second raises.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: what the sharding rules read."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str]
                       ) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def _world(backend: str, world_size: int, device_id=None) -> None:
    """The default process group of ``world_size`` ranks, this process
    rank 0; kept if it is already there with that size."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialised; this mesh needs {world_size} (one "
                f"default group per process: run the other mesh in a "
                f"child process)")
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)
        return
    with socket.socket() as s:  # a free local port for the one-rank store
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=world_size,
                            device_id=device_id)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group, which must already span ``prod(shape)`` ranks."""
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str]
                   ) -> DeviceMesh:
    """A mesh over a fake process group of ``prod(shape)`` ranks, this
    process rank 0.  Its tensors live on ``meta``: it computes shapes,
    shardings and collectives' sizes, and moves no data.  Its device type
    is ``cuda`` (no card is touched), so DTensor plans the collectives
    it would on GPUs (a ``cpu`` mesh turns all-to-alls into all-gathers,
    gloo having none)."""
    n = 1
    for s in shape:
        n *= s
    _world("fake", n)
    return make_mesh(shape, axes, device_type="cuda")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 16 x 16 (or 2 x 16 x 16) mesh over a fake group of 256 (512)
    ranks (``make_fake_mesh``)."""
    return make_fake_mesh(*production_shape(multi_pod))


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """The (1, 1) mesh (``data``, ``model``) over the caller's device: a
    one-rank NCCL group on ``cuda:0`` by default, gloo when ``device="cpu"``
    is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _world("nccl", 1, device_id=dev)
        return make_mesh((1, 1), ("data", "model"), "cuda")
    if dev.type != "cpu":
        raise ValueError(f"the host mesh runs on cuda or cpu, not {dev}")
    _world("gloo", 1)
    return make_mesh((1, 1), ("data", "model"), "cpu")


def close_mesh() -> None:
    """Destroy the default process group (and so every mesh over it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
