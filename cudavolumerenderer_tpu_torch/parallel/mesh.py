"""The process group that sharded rendering runs over.

Port of cudavolumerenderer_tpu/parallel/mesh.py.  JAX builds a one-axis
`Mesh` over the devices a process sees; here one rank of a
torch.distributed process group is one device, so the "mesh" is the
group's world: its size, this process's rank and the device this rank
renders on.  The axis is named 'rays', as in the JAX package: samples
(paths) are split across it and images are summed over it.

Ranks render on the card: rank r takes `cuda:{LOCAL_RANK}` (torchrun's
variable) or `cuda:{r % device_count}`.  A CPU group (gloo) is built only
when the caller asks for device="cpu"; without a card and without that
request every function here raises.  The backend follows the device
(nccl for the card, gloo for the CPU) unless the caller names one, e.g.
gloo over CUDA tensors for two ranks that share one card (NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of `world_size` ranks; this process is `rank` and
    renders on `device`."""

    group: dist.ProcessGroup
    world_size: int
    rank: int
    axis_name: str
    device: torch.device


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: the card unless `device` asks for another
    (cuda:{LOCAL_RANK}, else cuda:{rank % device_count}); raises on a
    CUDA device without a card."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a rank renders on the card and torch.cuda.is_available() is "
            "False; pass device=\"cpu\" (--platform cpu) for a CPU group"
        )
    if device is not None and device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        index = rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def _env_int(name: str, given: Optional[int]) -> Optional[int]:
    if given is not None:
        return given
    return int(os.environ[name]) if name in os.environ else None


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
) -> torch.device:
    """Join the process group (jax.distributed.initialize's counterpart);
    call once per process before make_mesh.  `init_method` is
    "tcp://host:port" of rank 0, or torchrun's environment (env://,
    MASTER_ADDR / MASTER_PORT) when None; `world_size` and `rank` default
    to WORLD_SIZE and RANK.  The backend is nccl for a CUDA device and
    gloo for the CPU unless given.  Returns this rank's device (made
    current for CUDA)."""
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    if world_size is None or rank is None:
        raise ValueError(
            "world_size and rank are needed (or WORLD_SIZE and RANK set)"
        )
    dev = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl reduces CUDA tensors, not {dev} ones")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        **({"device_id": dev} if backend == "nccl" else {}),
    )
    return dev


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "rays", device=None
) -> Mesh:
    """The mesh over the initialized group.  One rank is one device, so
    `n_devices` (JAX's slice of the device list) must equal the group's
    size when given.  `device` as in rank_device."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call initialize_distributed "
            "(or torch.distributed.init_process_group) first"
        )
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices}, but the group has {world} ranks (one "
            "rank per device)"
        )
    rank = dist.get_rank()
    dev = rank_device(device, rank)
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError(f"an nccl group reduces CUDA tensors, not {dev} ones")
    return Mesh(
        group=dist.group.WORLD, world_size=world, rank=rank,
        axis_name=axis_name, device=dev,
    )
