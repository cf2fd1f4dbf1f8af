"""Device meshes (counterpart of audiolab_tpu/core/mesh.py; reference: the
single-node DDP of train.py:265-303).

A :class:`Mesh` is a ``("dp", "tp")`` grid of slots, ``mesh.shape["dp"]`` by
``mesh.shape["tp"]``.  Work is sharded over the ranks of a process group,
one rank a slot: :func:`get_mesh`, once ``init_distributed`` has started a
group, gives ``device_mesh``, torch's ``DeviceMesh`` with the same axis
names, and a layer reaches the other slots of an axis through
:meth:`Mesh.group` and :meth:`Mesh.coordinate`.  The RVC and WaveTransfer
steps, the tensor-parallel LM and the separator's fan-out all take this
form, which is what torchrun starts.

:func:`local_mesh` (and :func:`get_mesh` in a single process) keep the JAX
API's one-process mesh: ``devices`` lists this process's slots, dp-major.
No rank can reach them, so the parallel paths take such a mesh only with
one slot (it names the device) and refuse more.  It defaults to the card,
as every entry point does: without one it raises unless the caller asks
for CPU slots.

Slot (i, j) is rank (or listed device) i * tp + j: the ranks of a tp row
are consecutive, as the JAX mesh's ``reshape(dp, tp)`` lays them out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.distributed import rank_device

AXES = ("dp", "tp")


@dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    devices: tuple[torch.device, ...] | None = None
    device_mesh: object | None = None     # torch.distributed.device_mesh.DeviceMesh

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def distributed(self) -> bool:
        """Whether the slots are the ranks of a process group."""
        return self.device_mesh is not None

    def group(self, axis: str):
        """The process group of this rank's slots along ``axis`` (a mesh
        over ranks only)."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 in a one-process mesh)."""
        return self.device_mesh.get_local_rank(axis) if self.distributed else 0

    @property
    def device(self) -> torch.device:
        """This process's device: its rank's, or the first slot's."""
        return rank_device() if self.distributed else self.devices[0]


def _factor(n: int, tp: int) -> tuple[int, int]:
    tp = min(tp, n)
    while n % tp:
        tp -= 1
    return n // tp, tp


def _visible_devices(n: int | None, device: str | torch.device | None) -> list[torch.device]:
    """This process's cards, or the CPU for as many slots as asked
    (``device="cpu"``; XLA's forced host device count made visible the same
    way); raises without a card otherwise."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (n or 1)
    resolve_device(device)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_mesh(tp: int = 1, device: str | torch.device | None = None) -> Mesh:
    """The global mesh, axes ``(dp, tp)``: over every rank of the default
    process group when one is started (a ``DeviceMesh``), else
    ``local_mesh(None, tp, device=device)``."""
    if not dist.is_initialized():
        return local_mesh(None, tp, device=device)
    from torch.distributed.device_mesh import init_device_mesh

    dp, tp = _factor(dist.get_world_size(), tp)
    kind = rank_device().type
    return Mesh(dp, tp, device_mesh=init_device_mesh(kind, (dp, tp), mesh_dim_names=AXES))


def local_mesh(n_devices: int | None = None, tp: int = 1,
               devices: list | tuple | None = None,
               device: str | torch.device | None = None) -> Mesh:
    """A one-process mesh over the first ``n_devices`` of ``devices``: by
    default this process's cards (raising without one), or with
    ``device="cpu"`` the CPU as often as asked; a device listed twice fills
    two slots."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _visible_devices(n_devices, device))
    devs = devs[: n_devices or len(devs)]
    dp, tp = _factor(len(devs), tp)
    return Mesh(dp, tp, devices=tuple(devs))


def data_sharding(mesh: Mesh) -> tuple:
    """Batch-sharded over dp, replicated over tp: DTensor placements for
    the mesh's ``device_mesh``.  This and :func:`replicated` keep the JAX
    API's names for a caller that lays tensors out as DTensors; the port's
    own paths shard by hand (``core.distributed.rows``) and call neither."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh: Mesh) -> tuple:
    """Replicated on every slot: DTensor placements."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())
