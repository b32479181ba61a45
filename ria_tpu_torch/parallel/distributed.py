"""Multi-process meshes on ``torch.distributed``, and rank-local data feeding.

Port of ``ria_tpu/parallel/distributed.py``.  A JAX mesh lays the devices of
one or more processes on named axes, and ``shard_map`` runs one program on
all of them.  Torch has one device per process, so here a mesh is a set of
ranks, one process each, and every collective is explicit:

- :func:`initialize` brings up the default process group for a run of
  several processes (address, world size and rank given, or read from the
  environment as ``torchrun`` sets it) and is a no-op for one process, so
  the same program serves tests, one card and several hosts.  It picks the
  backend from the topology: NCCL when every rank of a host has a card of
  its own, gloo when ranks share a card or run on the CPU.  The choice is
  returned by :func:`backend` and printed by the callers; nothing is caught
  and retried on another backend.
- :class:`Mesh` names axes and sizes over the ranks in row-major order: a
  rank's coordinates, one process group per axis line (``dist.new_group``)
  and the rank's device.
- :func:`make_hybrid_mesh` lays a (ch, t) mesh whose ``t`` lines, which
  carry the halo exchanges of :mod:`ria_tpu_torch.parallel.stream`, stay
  inside a host, while ``ch`` spans the hosts.
- :func:`put_stream` and :func:`put_stream_rows` put only this rank's block
  or rows of the stream on its device; no rank holds another's audio.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ria_tpu_torch.utils.device import resolve_device

# Seconds a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 120.0

# This process's device once :func:`initialize` ran (a process is one rank).
_RANK_DEVICE: torch.device | None = None


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value is None else int(value)


def choose_backend(device: str | torch.device, ranks_per_host: int) -> str:
    """``"nccl"`` when the ranks of a host each have a card of their own,
    ``"gloo"`` when they share one or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device, local_rank: int = 0) -> torch.device:
    """The device of the rank with this host-local index: ``cuda`` becomes
    ``cuda:{local_rank % device_count}``; raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               device: str | torch.device = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Bring up the default process group when running as several
    processes; returns the process count.  One process is a no-op that
    returns 1.  With ``num_processes`` None the world size, rank and
    address come from the environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``), as ``torchrun`` sets them.  A process
    started as a rank (``num_processes`` given, or more than one) records
    its device as the default of this package's meshes.

    ``coordinator_address`` is an ``init_method`` URL: ``tcp://host:port``
    or ``file:///path``.  ``backend`` None picks :func:`choose_backend` for
    the ranks of this host (``LOCAL_WORLD_SIZE``, else all of them).
    ``device`` ``cuda`` gives the rank ``cuda:{local_rank % device_count}``
    (``LOCAL_RANK``, else the process id)."""
    global _RANK_DEVICE
    as_rank = num_processes is not None
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or 1
        process_id = _env_int("RANK") if process_id is None else process_id
        if coordinator_address is None and num_processes > 1:
            coordinator_address = "env://"
    process_id = process_id or 0
    local_rank = _env_int("LOCAL_RANK")
    dev = rank_device(device, process_id if local_rank is None else local_rank)
    if as_rank or num_processes > 1:
        _RANK_DEVICE = dev
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    if num_processes <= 1:
        return dist.get_world_size() if dist.is_initialized() else 1
    if backend is None:
        backend = choose_backend(dev, _env_int("LOCAL_WORLD_SIZE") or num_processes)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> str | None:
    """The default group's backend, None for a single process."""
    return dist.get_backend() if dist.is_initialized() else None


def local_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` if given, else this rank's device (:func:`initialize`),
    else the card."""
    if device is not None:
        return resolve_device(device)
    return _RANK_DEVICE if _RANK_DEVICE is not None else resolve_device("cuda")


class Mesh:
    """Named axes over the ranks of the default group, row-major: rank r
    sits at the coordinates of r in an array of ``shape``.

    ``groups[axis]`` is the process group of this rank's line along the
    axis (None for an axis of size 1, the default group for one that spans
    every rank); every rank builds every line's group, in the same order, as
    ``dist.new_group`` requires.  ``device`` is this rank's device.
    """

    def __init__(self, axis_names: tuple[str, ...], shape: tuple[int, ...],
                 device: str | torch.device | None = None):
        if len(axis_names) != len(shape):
            raise ValueError(f"axes {axis_names} and shape {shape} differ in length")
        world = world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} ranks, "
                             f"the run has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.device = local_device(device)
        self.backend = backend()
        self.rank = rank()
        self._grid = np.arange(world).reshape(tuple(shape))
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        self.groups = {name: self._axis_group(ax) for ax, name in enumerate(axis_names)}

    def _axis_group(self, ax: int):
        size = self._grid.shape[ax]
        if size == 1:
            return None
        if size == self._grid.size:
            return dist.group.WORLD
        lines = np.moveaxis(self._grid, ax, -1).reshape(-1, size)
        mine = None
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if self.rank in line:
                mine = group
        return mine

    def size(self, axis: str | None = None) -> int:
        """The size of ``axis``, or the number of ranks for None."""
        return self._grid.size if axis is None else self.shape[axis]

    def index(self, axis: str | None = None) -> int:
        """This rank's coordinate on ``axis``; its rank for None."""
        return self.rank if axis is None else self.coords[axis]

    def group(self, axis: str | None = None):
        """The process group of this rank's line along ``axis`` (every rank
        for None); None when that line is this rank alone."""
        if axis is None:
            return dist.group.WORLD if self._grid.size > 1 else None
        return self.groups[axis]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at coordinate ``index`` of this rank's line along
        ``axis``."""
        where = list(self.coords[a] for a in self.axis_names)
        where[self.axis_names.index(axis)] = index
        return int(self._grid[tuple(where)])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device}, "
                f"backend {self.backend})")


def make_hybrid_mesh(ch: int | None = None, t: int | None = None,
                     device: str | torch.device | None = None) -> Mesh:
    """2D (ch, t) mesh with the halo-exchange axis ``t`` kept on a host.

    Defaults: t = the ranks of a host (``LOCAL_WORLD_SIZE``, else every
    rank), ch = the number of hosts.  Ranks are numbered host by host, so
    each ``t`` line is one host's ranks.  On one process this is the 1x1
    mesh."""
    world = world_size()
    t = t or _env_int("LOCAL_WORLD_SIZE") or world
    ch = ch or world // t
    return Mesh(("ch", "t"), (ch, t), device)


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def put_stream(mesh: Mesh, audio_local, axis: str = "t") -> torch.Tensor:
    """This rank's block of the stream ([block] or [ch, block]) on its
    device.  ``audio_local`` is the rank's own block along ``axis``: the
    whole stream on a 1-rank axis, so one program serves one process and
    many."""
    x = _to_device(audio_local, mesh.device)
    if x.ndim not in (1, 2):
        raise ValueError(f"a stream block is [T] or [ch, T], got {tuple(x.shape)}")
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}")
    return x


def put_stream_rows(mesh: Mesh, rows_local) -> torch.Tensor:
    """This rank's part of the [ch, T] array whose CHANNEL rows are split
    over the ``ch`` axis (across hosts) and columns over ``t`` (on the
    host): ``rows_local`` is the host's own rows [ch_local, T], and the rank
    keeps its column block [ch_local, T / t] on its device."""
    rows = np.asarray(rows_local, np.float32)
    if rows.ndim != 2:
        raise ValueError(f"rows are [ch_local, T], got {rows.shape}")
    t, j = mesh.size("t"), mesh.index("t")
    if rows.shape[1] % t:
        raise ValueError(f"T = {rows.shape[1]} does not split over t = {t}")
    width = rows.shape[1] // t
    return _to_device(rows[:, j * width : (j + 1) * width], mesh.device)
