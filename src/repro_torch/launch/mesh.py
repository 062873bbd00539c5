"""Device meshes over ``torch.distributed`` process groups.

Port of ``repro/launch/mesh.py``.  Functions, not module-level
constants: importing this module touches no device and no process
group.

- ``make_host_mesh`` builds a ``("data", "model")`` ``DeviceMesh`` over
  the default process group.  Where no group exists it starts one at
  world size 1 from an in-process ``HashStore`` (no socket): ``nccl`` for
  the card, the default, ``gloo`` for the CPU.  A launcher (``torchrun``,
  or ``join_ranks`` in each of a test's processes over a ``FileStore``)
  starts larger groups.
- ``join_ranks`` joins one rank process to a group over a ``FileStore``:
  NCCL where every rank has a card of its own, else gloo, which carries
  CUDA tensors too (NCCL refuses two ranks of one communicator on one
  card, ``ncclInvalidUsage``), so two ranks can share one card: their
  tensors and compute stay on it, and only the collectives' bytes pass
  through the host.
- ``make_production_mesh`` is the reference's 16 x 16 (or 2 x 16 x 16)
  ``("data", "model")`` (``("pod", "data", "model")``) mesh over a group
  of 256 (512) ranks that a launcher started; at any other world size it
  raises.  The dry-run alone asks for ``fake=True``: a fake group of that
  size in one process (``FakeStore``, backend ``"fake"``), which runs no
  collective and holds no device.
"""
from __future__ import annotations

import math

from repro_torch.weights import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_host_mesh(model: int = 1, device=None):
    """``(world // model, model)`` ``("data", "model")`` mesh over the
    default group on ``device``'s type (``cuda`` unless the caller names
    the CPU); starts a world-size-1 group when none exists."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"make_host_mesh: no process-group backend for "
                         f"{device}")
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[device.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"make_host_mesh: model={model} does not divide "
                         f"the world size {world}")
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device.type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def join_ranks(store_path, rank: int, world: int, device=None) -> str:
    """Join this process, rank ``rank`` of ``world``, to the default group
    over a ``FileStore`` at ``store_path`` (no socket); on the card, rank
    r takes card r mod the card count.  Returns the backend: ``nccl``
    where the ranks have a card each, ``gloo`` on the CPU or where ranks
    share a card (module docstring)."""
    import torch
    import torch.distributed as dist

    device = resolve_device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"join_ranks: no process-group backend for "
                         f"{device}")
    backend = BACKENDS[device.type]
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        if world > cards:
            backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    return backend


def make_production_mesh(*, multi_pod: bool = False, fake: bool = False,
                         device=None):
    """The production mesh over the default group, which must hold
    exactly 256 ranks (512 with ``multi_pod``).  ``fake`` (the dry-run
    only): start a fake group of that size in this process, with no
    device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if multi_pod:
        shape, names = (2, 16, 16), ("pod", "data", "model")
    else:
        shape, names = (16, 16), ("data", "model")
    need = math.prod(shape)
    if fake:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("make_production_mesh(fake=True): a process "
                               "group already exists; the fake group is "
                               "for the dry-run's own process")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=need)
        return init_device_mesh("cpu", shape, mesh_dim_names=names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"make_production_mesh: the {'x'.join(map(str, shape))} mesh "
            f"needs a process group of {need} ranks (one per device, "
            f"started by a launcher such as torchrun); found world size "
            f"{world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)
