"""Device meshes over a ``torch.distributed`` world.

The JAX package's mesh (``jax.make_mesh``) names the axes of a grid of
devices; its collectives run over an axis by name inside ``shard_map``.
Here a :class:`Mesh` lays the ranks of an initialised ``torch.distributed``
world out as the same grid, row-major (rank ``r`` sits at the coordinates
of ``r`` in ``shape``), and holds, for every set of axes, the process group
of the ranks that share this rank's coordinates on the other axes: the
group a collective over those axes runs in.  A collective over a tuple of
axes orders its members row-major over the tuple, as ``shard_map`` orders
the blocks of ``P(("data", "model"))``; such a tuple lists its axes in the
mesh's order.

The groups are made with ``dist.new_group``, one per (axes, coordinates)
for every set of axes, by every rank in one order.  ``init_device_mesh``
makes a group per single axis only (a set of axes needs ``_flatten``), and
binds each rank to card ``rank % device_count``; this module makes the
same groups on a world of one rank per card (NCCL) and on a world whose
ranks share a card or run on the CPU (gloo).

The backend is the caller's explicit choice: ``"nccl"`` for one rank per
card, ``"gloo"`` on the CPU and for ranks that share a card.  Nothing
picks another when the one asked for fails.  The world's collectives time
out after at most :data:`MAX_TIMEOUT_S` seconds, so a hung collective
raises.

Single pod: 256 chips as (16, 16) = ("data", "model"); two pods as
(2, 16, 16) = ("pod", "data", "model") (:func:`make_production_mesh`).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import socket
from typing import Any, Optional

#: the longest collective timeout a world may have, in seconds
MAX_TIMEOUT_S = 120
#: the backends a world may be asked for
BACKENDS = ("nccl", "gloo")

#: the reference's production meshes: (shape, axes)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def free_port() -> int:
    """A TCP port on localhost that was free when asked (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(backend: str, *, rank: int, world_size: int,
               init_method: str, timeout_s: float = 60.0) -> None:
    """``torch.distributed.init_process_group`` with an explicit backend
    (``"nccl"`` or ``"gloo"``), address (``tcp://localhost:<port>``), world
    size and rank, and a collective timeout of at most
    :data:`MAX_TIMEOUT_S` seconds."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 < timeout_s <= MAX_TIMEOUT_S:
        raise ValueError(f"timeout {timeout_s} s is not in (0, "
                         f"{MAX_TIMEOUT_S}]")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of ranks.  ``shape`` maps each axis name to its size,
    in axis order, as a JAX mesh's ``shape`` does; ``axis_names`` lists
    them.  A mesh from :func:`make_mesh` also holds this rank's place
    (``rank``, ``coords``) and its process groups; one from
    :meth:`abstract` holds only the shape, which is all the sharding rules
    read."""

    shape: dict[str, int]
    axis_names: tuple[str, ...]
    rank: Optional[int] = None
    coords: Optional[dict[str, int]] = None
    groups: Optional[dict[tuple[str, ...], Any]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def abstract(cls, shape: tuple[int, ...], axes: tuple[str, ...]
                 ) -> "Mesh":
        """A mesh of ``shape`` over ``axes`` with no world behind it."""
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"shape {shape} does not name axes {axes}")
        return cls(dict(zip(axes, shape)), tuple(axes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name, a tuple of names in mesh order, or None) as a
        tuple."""
        if axes is None:
            return ()
        t = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in t]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {t} are not in the mesh's order "
                             f"{self.axis_names}")
        return t

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major over a tuple."""
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def of_rank(self, rank: int) -> "Mesh":
        """This mesh as rank ``rank`` of its world holds it: its
        row-major coordinates, no process groups."""
        return Mesh(self.shape, self.axis_names, rank=rank, coords=dict(
            zip(self.axis_names, _coords(rank, tuple(self.shape.values())))))

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        if self.groups is None:
            raise RuntimeError("an abstract mesh has no process groups")
        return self.groups[self.axes(axes)]


def _coords(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh over the initialised world, whose size it must equal: rank
    ``r`` at the row-major coordinates of ``r``.  Every rank calls it with
    the same arguments (the groups are made collectively)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("init_world() first")
    abstract = Mesh.abstract(shape, axes)
    world = dist.get_world_size()
    if abstract.size != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} holds "
                         f"{abstract.size} ranks, the world {world}")
    rank = dist.get_rank()
    all_coords = [_coords(r, shape) for r in range(world)]
    mine = all_coords[rank]
    groups = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            rest = [i for i in range(len(axes)) if i not in sub]
            # one group per coordinate of the other axes, made in one order
            # by every rank; this rank keeps the one it belongs to
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                members = [r for r, c in enumerate(all_coords)
                           if all(c[i] == f for i, f in zip(rest, fixed))]
                g = dist.new_group(members)
                if rank in members:
                    groups[tuple(axes[i] for i in sub)] = g
    return dataclasses.replace(
        abstract, rank=rank, coords=dict(zip(axes, mine)), groups=groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``, over a world
    of 256 or 512 ranks."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes)


def make_host_mesh(shape: Optional[tuple[int, ...]] = None,
                   axes: Optional[tuple[str, ...]] = None) -> Mesh:
    """A small mesh over the whole world (tests, CPU examples): by default
    (1, world) over ("data", "model")."""
    import torch.distributed as dist
    if shape is None:
        shape, axes = (1, dist.get_world_size()), ("data", "model")
    return make_mesh(tuple(shape), tuple(axes))


def join_world(spec: str, backend: str) -> tuple[Mesh, bool]:
    """The (data, model) mesh ``spec`` (``"DxM"``, a CLI's ``--mesh``)
    names over the world: the one already initialised in this process,
    else the one ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), joined over
    ``backend``.  Returns (mesh, whether this call started the world)."""
    import os

    import torch.distributed as dist
    try:
        shape = tuple(int(n) for n in spec.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise SystemExit(f"--mesh takes DxM (data x model), not {spec!r}")
    started = False
    if not dist.is_initialized():
        env = os.environ
        init_world(backend, rank=int(env["RANK"]),
                   world_size=int(env["WORLD_SIZE"]),
                   init_method=f"tcp://{env['MASTER_ADDR']}:"
                               f"{env['MASTER_PORT']}")
        started = True
    return make_mesh(shape, ("data", "model")), started
