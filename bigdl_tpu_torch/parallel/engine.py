"""The runtime engine: the process group, this rank's device and the
named-axis mesh over the ranks (port of ``bigdl_tpu/parallel/engine.py``).

The JAX package's "executors" are JAX processes and its "cores" the
local devices of each; a mesh names axes over all devices and a
collective runs over one or more of them inside ``shard_map``. Here a
rank is one process on one device, so:

- ``Engine.init`` is ``torch.distributed.init_process_group``: NCCL for
  the card, gloo only when the caller asks for the CPU (``device="cpu"``)
  or for gloo by name (``backend="gloo"``: ranks that share one card,
  which NCCL refuses). It raises without a GPU unless asked for the CPU,
  and is a singleton per process, as in JAX;
- ``node_number`` and ``total_devices`` are the world size,
  ``core_number`` the devices this host's ranks can use;
- a :class:`Mesh` lays the ranks of the world out row-major over named
  axes (``"data"``, ``"seq"``, ``"expert"``, ``"pipe"``) and resolves an
  axis name, or a tuple of names, to the process group of the ranks that
  share every other coordinate: the group a JAX collective over those
  axes reduces within. Every group of every subset of axes is created
  when the mesh is, by every rank in the same order, as
  ``torch.distributed.new_group`` requires.

Without a process group (no ``Engine.init``, no launcher) the world is
one rank: a mesh of size 1 whose groups are ``None``, over which every
collective of ``parallel/collectives.py`` is the identity, as a JAX
collective over a one-device axis is.

``Engine.init`` sets the topology gauges, as the JAX one does:
``bdt_engine_processes`` (the ranks), ``bdt_engine_local_devices`` (the
devices this host's ranks use, one a rank) and
``bdt_engine_total_devices`` (one device a rank: the world size).
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from bigdl_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from bigdl_tpu_torch.observability.instruments import engine_instruments

logger = logging.getLogger("bigdl_tpu_torch.engine")

Axes = Union[str, Sequence[str]]


class EngineType:
    """The compute dtype policy (the reference's MklBlas / MklDnn
    switch)."""

    FLOAT32 = "float32"
    BFLOAT16 = "bfloat16"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Named axes laid row-major over ``ranks`` (default: every rank of
    the world, in order), as ``np.asarray(devices).reshape(sizes)`` lays
    devices out in JAX."""

    def __init__(self, axes: Sequence[Tuple[str, int]],
                 ranks: Optional[Sequence[int]] = None):
        ranks = list(range(world_size())) if ranks is None else list(ranks)
        self.axis_names = tuple(a for a, _ in axes)
        sizes = [int(s) for _, s in axes]
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {list(axes)} repeat a name")
        total = 1
        for s in sizes:
            total *= s
        if total != len(ranks):
            raise ValueError(
                f"mesh axes {list(axes)} do not cover {len(ranks)} devices "
                "(one rank each)")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.ranks = ranks
        me = world_rank()
        self._coords = {r: self._coords_of(i, sizes)
                        for i, r in enumerate(ranks)}
        self._mine = self._coords.get(me)
        self._groups = {}
        if not dist.is_initialized():
            return
        for k in range(1, len(self.axis_names) + 1):
            for subset in itertools.combinations(self.axis_names, k):
                self._groups[subset] = self._make_group(subset)

    @staticmethod
    def _coords_of(index: int, sizes) -> Tuple[int, ...]:
        out = []
        for s in reversed(sizes):
            out.append(index % s)
            index //= s
        return tuple(reversed(out))

    def _make_group(self, subset):
        """This rank's group over ``subset``: ranks that agree on every
        other axis. Every rank creates every group, in one order."""
        others = [i for i, a in enumerate(self.axis_names)
                  if a not in subset]
        if not others and len(self.ranks) == world_size():
            return dist.group.WORLD
        parts: Dict[Tuple[int, ...], list] = {}
        for r in self.ranks:
            key = tuple(self._coords[r][i] for i in others)
            parts.setdefault(key, []).append(r)
        mine = None
        for key in sorted(parts):
            g = dist.new_group(parts[key])
            if self._mine is not None and all(
                    self._mine[i] == v for i, v in zip(others, key)):
                mine = g
        return mine

    def _subset(self, axes: Axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"axis {unknown} not in mesh axes "
                             f"{list(self.axis_names)}")
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axes: Axes):
        """The process group of this rank over ``axes`` (a name or a
        tuple of names); None in a world without a process group."""
        return self._groups.get(self._subset(axes))

    def size(self, axes: Axes) -> int:
        """``lax.psum(1, axes)``: the ranks in one group over ``axes``."""
        n = 1
        for a in self._subset(axes):
            n *= self.shape[a]
        return n

    def index(self, axes: Axes) -> int:
        """``lax.axis_index(axes)``: this rank's row-major position
        within its group over ``axes``."""
        if self._mine is None:
            raise ValueError("this rank is not in the mesh")
        idx = 0
        for a in self._subset(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[a] + self._mine[i]
        return idx

    def __repr__(self):
        return f"Mesh({self.shape})"


class Engine:
    """Process-wide singleton: the process group, this rank's device, the
    engine type and the default mesh."""

    _initialized = False
    _owns_group = False
    _device: Optional[torch.device] = None
    _mesh: Optional[Mesh] = None
    _engine_type = os.environ.get("BIGDL_TPU_ENGINE_TYPE",
                                  EngineType.FLOAT32)

    @classmethod
    def init(cls, coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None, *,
             device=DEFAULT_DEVICE, backend: Optional[str] = None) -> None:
        """Join the process group (a no-op once initialized).

        ``coordinator_address`` is a rendezvous URL (``tcp://host:port``
        or ``file:///path``; a bare ``host:port`` means TCP) with
        ``num_processes`` and ``process_id``. Without it the launcher's
        environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
        ``MASTER_PORT``) is read where it is set; otherwise this process
        is a world of one and no group is made. ``device`` follows the
        device rule (the card unless ``"cpu"``); ``backend`` defaults to
        NCCL for the card and gloo for the CPU. A rank uses card
        ``LOCAL_RANK % device_count``."""
        if cls._initialized:
            return
        dev = resolve_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                             f"{backend!r}")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("the NCCL backend moves CUDA tensors; pass "
                             "device='cuda' or backend='gloo'")
        env = os.environ
        from_env = coordinator_address is None and "RANK" in env \
            and "WORLD_SIZE" in env
        if coordinator_address is not None or from_env:
            rank = int(process_id if process_id is not None
                       else env["RANK"])
            world = int(num_processes if num_processes is not None
                        else env["WORLD_SIZE"])
            local_rank = int(env.get("LOCAL_RANK", rank))
            local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        else:
            rank, world, local_rank, local_world = 0, 1, 0, 1
        if dev.type == "cuda":
            n_cards = torch.cuda.device_count()
            if backend == "nccl" and local_world > n_cards:
                raise ValueError(
                    f"{local_world} ranks on this host share {n_cards} "
                    "card(s): NCCL refuses two ranks on one device; pass "
                    "backend='gloo' (the launcher's --backend gloo)")
            dev = torch.device("cuda", local_rank % n_cards)
            torch.cuda.set_device(dev)
        cls._device = dev
        if coordinator_address is not None or from_env:
            url = coordinator_address or "env://"
            if "://" not in url:
                url = f"tcp://{url}"
            dist.init_process_group(backend, init_method=url, rank=rank,
                                    world_size=world)
            cls._owns_group = True
        cls._initialized = True
        logger.info("Engine.init: rank %d of %d, %s on %s", rank, world,
                    backend if dist.is_initialized() else "no group", dev)
        # one-shot topology gauges, forced past the disable switch: a
        # later enable() must not read frozen zeros
        ins = engine_instruments()
        ins.processes.set(world, force=True)
        ins.local_devices.set(local_world, force=True)
        ins.total_devices.set(world, force=True)

    @classmethod
    def device(cls) -> torch.device:
        """This rank's device (set by ``init``)."""
        if cls._device is None:
            raise RuntimeError("Engine.init has not run in this process")
        return cls._device

    @classmethod
    def backend(cls) -> Optional[str]:
        """The default group's backend, None without a process group."""
        return dist.get_backend() if dist.is_initialized() else None

    @classmethod
    def node_number(cls) -> int:
        """The number of ranks (the reference's executor count)."""
        return world_size()

    @classmethod
    def core_number(cls) -> int:
        """The devices this host's ranks can use: the cards, or 1 on the
        CPU."""
        dev = cls._device
        if dev is not None and dev.type == "cuda":
            return torch.cuda.device_count()
        return 1

    @classmethod
    def total_devices(cls) -> int:
        """One device per rank: the world size."""
        return world_size()

    @classmethod
    def get_engine_type(cls) -> str:
        return cls._engine_type

    @classmethod
    def set_engine_type(cls, t: str) -> None:
        cls._engine_type = t

    @classmethod
    def compute_dtype(cls) -> torch.dtype:
        return (torch.bfloat16 if cls._engine_type == EngineType.BFLOAT16
                else torch.float32)

    # ------------------------------------------------------------ mesh
    @classmethod
    def create_mesh(cls, axes: Optional[Sequence[Tuple[str, int]]] = None,
                    ranks: Optional[Sequence[int]] = None,
                    devices: Optional[Sequence[int]] = None) -> Mesh:
        """A :class:`Mesh` over ``ranks`` (default: the world); default
        axes: every rank on one ``data`` axis. ``devices`` is the JAX
        name for the same list (a rank is one device): a subset of the
        world, e.g. a 2-way model mesh over ranks ``[0, 1]`` of four.
        Raises ``ValueError`` when the axes do not cover the ranks.
        Collective: every rank of the world calls it with the same
        arguments, also a rank outside the subset."""
        if devices is not None:
            if ranks is not None:
                raise ValueError("pass ranks= or devices=, not both")
            ranks = [int(d) for d in devices]
        n = world_size() if ranks is None else len(ranks)
        return Mesh(axes if axes is not None else [("data", n)], ranks)

    @classmethod
    def default_mesh(cls) -> Mesh:
        if cls._mesh is None:
            cls._mesh = cls.create_mesh()
        return cls._mesh

    @classmethod
    def set_default_mesh(cls, mesh: Mesh) -> None:
        cls._mesh = mesh

    @classmethod
    def reset(cls) -> None:
        """Forget the mesh and the initialization, and leave the process
        group this engine made."""
        if cls._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        cls._initialized = False
        cls._owns_group = False
        cls._device = None
        cls._mesh = None
