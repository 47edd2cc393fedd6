"""The process mesh and multi-process start-up on ``torch.distributed``.

Port of mixgrpo_tpu/parallel/mesh.py.  JAX runs one process per host that
owns several devices, and its arrays are global.  The port runs one process
per device, as torchrun and the reference do, and each tensor is the rank's
own share.  The rank grid is JAX's device grid: ranks fill the axes
``("dp", "fsdp", "sp", "tp")`` in row-major order, as
``np.reshape(devices, (dp, fsdp, sp, tp))`` lays out JAX's devices.

``make_mesh`` builds one process group per axis (the ranks that differ only
along it) and one for the batch axes dp x fsdp.  One process needs no
process group: ``make_mesh`` then returns the 1 x 1 x 1 x 1 mesh, and every
collective of ``collectives.py`` is the identity on it.

The backend is chosen, never tried: ``nccl`` when each rank has a card of
its own, ``gloo`` for CPU tensors and for ranks that share one card (NCCL
refuses two ranks of one communicator on one device; PERF.md records the
probe, ``python -m mixgrpo_tpu_torch.parallel.probe``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional

import torch

AXES = ("dp", "fsdp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: use all remaining devices
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        """Resolve one ``-1`` axis (any of dp/fsdp/sp/tp) to "all remaining
        devices"; the recipe launches with ``--mesh_fsdp -1``."""
        sizes = {"dp": self.dp, "fsdp": self.fsdp, "sp": self.sp, "tp": self.tp}
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one -1 mesh axis, got {free}")
        if free:
            known = 1
            for k, v in sizes.items():
                if k != free[0]:
                    known *= v
            if n_devices % known:
                raise ValueError(f"{n_devices} devices do not divide by {known}")
            sizes[free[0]] = n_devices // known
        total = sizes["dp"] * sizes["fsdp"] * sizes["sp"] * sizes["tp"]
        if total != n_devices:
            raise ValueError(f"mesh {sizes} needs {total} devices, not {n_devices}")
        return MeshConfig(**sizes)


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh and the process groups it belongs to.

    ``shape`` maps each axis to its size (as JAX's ``Mesh.shape``),
    ``coords`` to this rank's index along it; ``ranks[axis]`` lists the
    global ranks of this rank's group along ``axis`` in axis order
    (``"batch"``: dp x fsdp).  ``groups`` holds the process groups (None in
    one process)."""

    cfg: MeshConfig
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device
    coords: Dict[str, int]
    ranks: Dict[str, List[int]]
    groups: Dict[str, object]

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self.cfg, a) for a in AXES}

    def size(self, axis: str) -> int:
        return len(self.ranks[axis])

    def index(self, axis: str) -> int:
        return self.ranks[axis].index(self.rank)

    @property
    def batch_index(self) -> int:
        """This rank's index among the batch ranks (dp x fsdp): the rank of
        its prompt shard."""
        return self.coords["dp"] * self.cfg.fsdp + self.coords["fsdp"]

    @property
    def batch_size(self) -> int:
        return self.cfg.dp * self.cfg.fsdp

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self.cfg)


def _rank_of(cfg: MeshConfig, c: Dict[str, int]) -> int:
    return ((c["dp"] * cfg.fsdp + c["fsdp"]) * cfg.sp + c["sp"]) * cfg.tp + c["tp"]


def _coords_of(cfg: MeshConfig, rank: int) -> Dict[str, int]:
    out = {}
    for a in reversed(AXES):
        n = getattr(cfg, a)
        out[a] = rank % n
        rank //= n
    return {a: out[a] for a in AXES}


def _groups_along(cfg: MeshConfig, axes) -> List[List[int]]:
    """Every group of ranks that differ only along ``axes``, each in axis
    order, in a fixed order (every rank must create every group)."""
    world = cfg.dp * cfg.fsdp * cfg.sp * cfg.tp
    seen, out = set(), []
    for r in range(world):
        c = _coords_of(cfg, r)
        key = tuple(c[a] for a in AXES if a not in axes)
        if key in seen:
            continue
        seen.add(key)
        members = []
        for q in range(world):
            cq = _coords_of(cfg, q)
            if tuple(cq[a] for a in AXES if a not in axes) == key:
                members.append(q)
        out.append(members)
    return out


def _is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_mesh(cfg: MeshConfig = MeshConfig(), device=None) -> Mesh:
    """The mesh of this process over every rank of the default process group
    (one rank when none is initialised); ``cfg`` is resolved against the
    world size.  ``device`` is this rank's device (default: ``cuda:<local
    rank>`` when CUDA is available, else the CPU)."""
    import torch.distributed as dist

    dist_on = _is_initialized()
    world = dist.get_world_size() if dist_on else 1
    rank = dist.get_rank() if dist_on else 0
    cfg = cfg.resolved(world)
    if device is None:
        device = default_device()
    coords = _coords_of(cfg, rank)
    ranks, groups = {}, {}
    for name, axes in [(a, (a,)) for a in AXES] + [("batch", ("dp", "fsdp"))]:
        for members in _groups_along(cfg, axes):
            # new_group is collective: every rank creates every group, in order
            g = dist.new_group(members) if dist_on and world > 1 else None
            if rank in members:
                ranks[name], groups[name] = members, g
    return Mesh(cfg=cfg, rank=rank, world=world,
                backend=dist.get_backend() if dist_on else None,
                device=torch.device(device), coords=coords, ranks=ranks, groups=groups)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def default_device() -> torch.device:
    """``cuda:<LOCAL_RANK mod cards>`` when CUDA is available, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def backend_for(device, ranks_per_host: int) -> str:
    """``nccl`` when every rank of this host has a card of its own, else
    ``gloo`` (CPU tensors, or ranks that share a card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     timeout_s: float = 1800.0) -> None:
    """Rendezvous of ``num_processes`` ranks at ``coordinator_address``
    (``host:port``).  Arguments left out are read from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  A no-op
    for one process, as JAX's is, and when already initialised.  The backend
    is ``backend_for(device, LOCAL_WORLD_SIZE)`` (default: the number of
    processes); on a card, this rank's device becomes the current one."""
    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or _is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    device = torch.device(device) if device is not None else default_device()
    backend = backend_for(device, int(os.environ.get("LOCAL_WORLD_SIZE", num_processes)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
