"""Process groups and device meshes on `torch.distributed`.

Port of `spmm_tpu/parallel/mesh.py`.  The JAX package runs one controller
over a `jax.sharding.Mesh`; the port runs one process per rank (the
reference's own layout, `cupyx.distributed`: one process per GPU, NCCL,
a store for the rendezvous).  Each rank holds its own shard as local
tensors on its device, and every sharded op is called by every rank of the
mesh with its own shard (SPMD).

The backend follows the device: NCCL for a CUDA device, gloo for the CPU.
`device=None` means `cuda:{local_rank}`; the CPU is used only where
`device="cpu"` is given.  Nothing here switches backend or device on its
own: a rank with no card, a mesh whose device does not match the group's
backend, and two ranks of one host on one card (NCCL refuses those with
"Duplicate GPU detected" at its first collective) all raise, worded.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the device `init_process_group` gave this process, read by `make_mesh`
_DEVICE: Optional[torch.device] = None
_KEY = "spmm_tpu_torch/device/"


def _local_rank(local_rank: Optional[int], rank: Optional[int] = None
                ) -> int:
    """`local_rank`, else LOCAL_RANK, else the rank (one host)."""
    if local_rank is not None:
        return int(local_rank)
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return int(rank)


def _parse_device(device, local_rank: int) -> torch.device:
    """The rank's device, not yet checked: `device` as given, else
    cuda:{local_rank}.  A bare "cuda" is cuda:{local_rank}."""
    if device is None:
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"a rank runs on a CUDA device or the CPU, not "
                         f"{device}")
    return device


def check_device(device: torch.device) -> torch.device:
    """`device` if this process can use it; raises where there is no card,
    or fewer cards than the index asks for (a rank past the last card would
    share one with another rank, which NCCL refuses)."""
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for this rank ({device}): the "
                           "port's distributed layer runs NCCL ranks on the "
                           "card; pass device='cpu' for gloo ranks on the CPU")
    count = torch.cuda.device_count()
    if device.index >= count:
        raise ValueError(f"this rank asks for {device}, but the machine has "
                         f"{count} CUDA device(s): NCCL refuses two ranks on "
                         "one card, so start at most one rank per card")
    return device


def rank_device(device=None, local_rank: Optional[int] = None
                ) -> torch.device:
    """The checked device of this rank (see `check_device`)."""
    return check_device(_parse_device(device, _local_rank(local_rank)))


def refuse_shared_cards(entries: Sequence[str]) -> None:
    """Raise where two ranks of one host name one CUDA device.  `entries`
    holds one "host/device" string per rank, in rank order."""
    seen: Dict[str, int] = {}
    for r, e in enumerate(entries):
        if "/cuda" not in e:
            continue
        if e in seen:
            host, dev = e.split("/", 1)
            raise ValueError(f"ranks {seen[e]} and {r} would both run on "
                             f"{dev} of host {host}: NCCL refuses two ranks "
                             "on one card (\"Duplicate GPU detected\"); start "
                             "one rank per card, or pass device='cpu' for "
                             "gloo ranks")
        seen[e] = r


def init_process_group(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None, *,
                       store_path: Optional[str] = None, device=None,
                       local_rank: Optional[int] = None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the process group (the `init_process_group` analogue) and
    return this rank's device.

    JAX's coordinator address, process count and id become `init_method`
    (a "tcp://host:port", "file://path" or "env://" URL; the default reads
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK), `world_size` and
    `rank`; or `store_path`, a `torch.distributed.FileStore` file that every
    rank names (no TCP port to pick or clash).  Before the group is made,
    the ranks swap their devices through the store, and every rank raises
    where two of one host would share a card, or where any rank's device
    is not there (`check_device`), so no rank is left waiting.  The
    backend is NCCL on a CUDA device, gloo on the CPU; a CUDA rank's device
    becomes the current one."""
    global _DEVICE
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    dev = _parse_device(device, _local_rank(local_rank, rank))
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is not None:
        store = dist.FileStore(str(store_path), world_size)
        store.set_timeout(timeout)
    else:
        store, rank, world_size = next(dist.rendezvous(
            init_method or "env://", rank=rank, world_size=world_size,
            timeout=timeout))
    try:
        check_device(dev)
        unusable = ""
    except (RuntimeError, ValueError) as e:
        unusable = str(e)
    store.set(f"{_KEY}{rank}", f"{socket.gethostname()}/{dev}")
    store.set(f"{_KEY}unusable/{rank}", unusable)
    refuse_shared_cards([store.get(f"{_KEY}{r}").decode()
                         for r in range(world_size)])
    if unusable:
        check_device(dev)  # raises, worded, on this rank
    for r in range(world_size):
        said = store.get(f"{_KEY}unusable/{r}").decode()
        if said:
            raise RuntimeError(f"rank {r} cannot run: {said}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    _DEVICE = dev
    return dev


def destroy_process_group() -> None:
    """Leave the process group made by `init_process_group`."""
    global _DEVICE
    dist.destroy_process_group()
    _DEVICE = None


class Mesh:
    """A mesh of the process group's ranks, laid out row-major over
    `shape` (rank = x * ny + y on a 2-D mesh, as `np.reshape` lays JAX's
    devices).  It holds the group, this rank's coordinate on each axis, one
    subgroup per axis (the ranks that differ from this one only on that
    axis) and the rank's device.  `shape[axis]` is the axis' size, as on a
    JAX mesh."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        coords = np.unravel_index(self.rank, shape)
        self.coords = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self._ranks: Dict[str, Tuple[int, ...]] = {}
        self._groups = {}
        grid = np.arange(self.size).reshape(shape)
        for ax, name in enumerate(self.axis_names):
            # every line along this axis, in the same order on every rank
            # (new_group is collective over the whole group)
            lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = (dist.group.WORLD if len(ranks) == self.size
                         else dist.new_group(list(ranks)))
                if self.rank in ranks:
                    self._ranks[name] = ranks
                    self._groups[name] = group

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (JAX's `axis_index`)."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self._groups[axis]

    def ranks(self, axis: str) -> Tuple[int, ...]:
        """Global ranks of this rank's line along `axis`, by coordinate."""
        return self._ranks[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("rows",),
              shape: Optional[Tuple[int, ...]] = None, *,
              device=None) -> Mesh:
    """A mesh over every rank of the process group.

    1-D ('rows',) is the default for row-partitioned SpMV/SpMM/SpGEMM;
    pass axes=("rows", "cols") + shape for 2-D (SUMMA-style) layouts.
    `device=None` is the device given to `init_process_group`, else
    cuda:{local_rank}; with no card it raises (pass device="cpu" for gloo
    ranks).  `n_devices` must be the group's size: a rank outside the mesh
    would have nothing to run."""
    dev = (_DEVICE if device is None and _DEVICE is not None
           else rank_device(device))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "spmm_tpu_torch.parallel.init_process_group "
                           "first, on every rank")
    backend = dist.get_backend()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"make_mesh: a mesh on {dev} needs the {want} "
                         f"backend, and the process group runs {backend}")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, and "
                         f"the process group has {world} ranks (one "
                         "device each)")
    if shape is None:
        shape = (n_devices,) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    return Mesh(tuple(axes), tuple(int(s) for s in shape), dev)


class Layout(NamedTuple):
    """Where an array lives on a mesh: split by rows over `axis`, or on
    every rank whole (`axis` None).  The port's `NamedSharding`."""
    mesh: Mesh
    axis: Optional[str]


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, None)


def row_sharded(mesh: Mesh, axis: str = "rows") -> Layout:
    return Layout(mesh, axis)


def resolve_layout(mesh, axis: Optional[str]) -> Tuple[Mesh, str]:
    """(mesh, axis) from a mesh and an axis, or from a `row_sharded`
    layout (whose axis wins); a replicated layout is not a split."""
    if isinstance(mesh, Layout):
        mesh, axis = mesh.mesh, mesh.axis
        if axis is None:
            raise ValueError("a replicated layout splits nothing: pass "
                             "row_sharded(mesh, axis)")
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of {mesh}")
    return mesh, axis
