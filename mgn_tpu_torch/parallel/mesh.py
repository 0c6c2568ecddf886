"""Process groups and the (data, graph) mesh over ``torch.distributed``: the
port's ``mgn_tpu/parallel/mesh.py`` and ``make_device_mesh`` of
``mgn_tpu/parallel/spmd.py``.

The JAX package drives every local device from one process; here each rank
is a process of its own (the PyTorch idiom: ``torchrun --nproc-per-node N``
or :func:`spawn`).  Rank ``d * graph + g`` holds data coordinate ``d`` (its
trajectory) and graph coordinate ``g`` (its part of the mesh).

The backend is an explicit argument, never a switch made on failure:

- ``"nccl"`` where every rank has a GPU of its own (``cuda:LOCAL_RANK``);
- ``"gloo"`` on the CPU, and where ranks share one card (NCCL refuses two
  ranks on one device).  Gloo takes CUDA tensors in every collective used
  here (``all_to_all_single``, ``all_gather_into_tensor``, ``all_reduce``:
  checked on an H100 with torch 2.11, and again by every run of
  ``chip_smoke.py``), staging them through host memory itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mgn_tpu_torch._device import resolve_device, tracing

__all__ = ["BACKENDS", "Comm", "DeviceMesh", "initialize_multihost", "is_writer",
           "mesh_shape_for", "rank_device", "make_device_mesh", "spawn"]

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(seconds=600)  # a collective waiting longer fails


def initialize_multihost(backend: str) -> bool:
    """``torch.distributed.init_process_group`` from torchrun's environment
    contract (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    A no-op for one process (no ``WORLD_SIZE`` above 1) or where a group is
    already initialized.  Returns whether a process group is initialized."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dist.init_process_group(backend, timeout=TIMEOUT)
    return True


def is_writer() -> bool:
    """Whether this process writes checkpoints, logs and exports: rank 0 of
    an initialized process group, or a process without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def mesh_shape_for(n_devices: int, prefer_graph: int = 0) -> Tuple[int, int]:
    """(data, graph) mesh shape: the graph axis gets the largest power of two
    that divides the device count (or ``prefer_graph`` if given and
    feasible)."""
    if prefer_graph and n_devices % prefer_graph == 0:
        return n_devices // prefer_graph, prefer_graph
    graph = 1
    while graph * 2 <= n_devices and n_devices % (graph * 2) == 0:
        graph *= 2
    return n_devices // graph, graph


@dataclasses.dataclass
class Comm:
    """The collectives of one process group, with the bytes and host time
    of every call recorded in :attr:`stats` (by collective name: calls,
    bytes sent by this rank, host ms until the call returned).

    Under a trace (``torch.export``, or a ``while_loop`` body) each
    collective is its functional form (``torch.distributed.
    _functional_collectives``, which a program holds by the group's name)
    and records nothing: a host time taken while tracing measures nothing."""

    group: Any  # a torch.distributed ProcessGroup
    size: int
    rank: int
    stats: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def _record(self, name: str, nbytes: int, t0: float) -> None:
        s = self.stats.setdefault(name, [0, 0, 0.0])
        s[0] += 1
        s[1] += nbytes
        s[2] += (time.perf_counter() - t0) * 1e3

    def _functional(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The traceable form of collective ``name`` on ``x``."""
        import torch.distributed._functional_collectives as funcol

        if name == "all_to_all":
            out = funcol.all_to_all_single(x.contiguous(), None, None, self.group)
        elif name == "all_gather":
            # every rank sends x to every rank (chunk q of the result is rank q's x): the
            # functional all_gather takes gloo down on CUDA tensors (SIGSEGV, torch 2.11)
            out = funcol.all_to_all_single(x.contiguous().repeat(
                (self.size,) + (1,) * (x.dim() - 1)), None, None, self.group)
        else:
            out = funcol.all_reduce(x, "sum", self.group)
        return funcol.wait_tensor(out)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``all_to_all_single``: chunk ``q`` of ``x``'s rows goes to group
        rank ``q``; chunk ``q`` of the result came from it."""
        if tracing():
            return self._functional("all_to_all", x)
        t0 = time.perf_counter()
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self._record("all_to_all_single", x.numel() * x.element_size(), t0)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along rows, in group rank order."""
        if tracing():
            return self._functional("all_gather", x)
        t0 = time.perf_counter()
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        # torch 2.13 renames all_gather_into_tensor (deprecated there) to all_gather_single
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x, group=self.group)
        self._record("all_gather_into_tensor", x.numel() * x.element_size(), t0)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in place; returns ``x`` (under a trace, a new
        tensor: use the result)."""
        if tracing():
            return self._functional("all_reduce", x)
        t0 = time.perf_counter()
        dist.all_reduce(x, group=self.group)
        self._record("all_reduce", x.numel() * x.element_size(), t0)
        return x


@dataclasses.dataclass(eq=False)  # compared and hashed by identity
class DeviceMesh:
    """This rank's place in the (data, graph) mesh: its coordinates, the
    collectives of its graph group (the ranks sharing its trajectory), of
    its data group (the ranks holding its part of other trajectories) and of
    the world, and its device."""

    data: int
    graph: int
    data_rank: int
    graph_rank: int
    graph_comm: Comm
    data_comm: Comm
    world: Comm
    device: torch.device

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data, self.graph


def rank_device(device=None) -> torch.device:
    """This rank's device.  ``None`` and an unindexed ``"cuda"`` mean the
    card of ``LOCAL_RANK`` (torchrun's; the global rank where it is unset,
    as under :func:`spawn`), modulo the cards present, so ranks sharing one
    card all take ``cuda:0``; both raise without a GPU, as
    :func:`~mgn_tpu_torch._device.resolve_device` does.  ``"cpu"`` and an
    indexed device are taken as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", int(local) % torch.cuda.device_count())
    return dev


_MESHES: Dict[Tuple[int, int, str, torch.device], DeviceMesh] = {}


def make_device_mesh(data: int, graph: int, backend: str,
                     device: Optional[torch.device] = None) -> DeviceMesh:
    """The (data, graph) mesh over the initialized process group of
    ``data * graph`` ranks.  ``backend`` names the group's backend;
    ``device`` is resolved by :func:`rank_device` (``None``: the rank's
    card, raising without one; ``"cpu"`` for the plain path) and made the
    current CUDA device before the mesh's groups exist.

    The mesh is built once per process group: its groups are created by the
    first call (every rank makes it, in the same order with the same
    arguments), and a later call with the same arguments returns the same
    mesh, its groups and its :class:`Comm` records, until the process group
    is destroyed."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        raise ValueError("make_device_mesh needs an initialized process group "
                         "(run under torchrun, or through mgn_tpu_torch.parallel.mesh.spawn)")
    world = dist.get_world_size()
    if world != data * graph:
        raise ValueError(f"mesh {data}x{graph} needs {data * graph} ranks, have {world}")
    device = rank_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend moves CUDA tensors: pass a cuda device")
    key = (data, graph, backend, device)
    mesh = _MESHES.get(key)
    if mesh is not None and mesh.world.group is dist.group.WORLD:
        return mesh
    if any(m.world.group is not dist.group.WORLD for m in _MESHES.values()):
        _MESHES.clear()  # made in a process group since destroyed
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    d, g = divmod(rank, graph)
    # every rank creates every group, in the same order
    graph_groups = [dist.new_group(list(range(i * graph, (i + 1) * graph)))
                    for i in range(data)]
    data_groups = [dist.new_group(list(range(j, data * graph, graph))) for j in range(graph)]
    mesh = _MESHES[key] = DeviceMesh(
        data=data, graph=graph, data_rank=d, graph_rank=g,
        graph_comm=Comm(graph_groups[d], graph, g),
        data_comm=Comm(data_groups[g], data, d),
        world=Comm(dist.group.WORLD, world, rank),
        device=device)
    return mesh


def _spawned(rank: int, n: int, store_path: str, backend: str, fn: Callable,
             args: Sequence, out_dir: str) -> None:
    dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n, timeout=TIMEOUT)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn: Callable, args: Sequence = (), backend: str = "gloo") -> List[Any]:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes joined in one
    process group (rendezvous through a ``FileStore`` in a temporary
    directory, never a TCP port, so that independent spawns may run side by
    side), and return the ranks' results in rank order (``torch.save``d,
    so tensors, arrays and plain containers).  ``fn`` must be importable
    by the child (a module-level function).  A rank that raises makes this
    raise (``torch.multiprocessing.ProcessRaisedException``)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_spawned, args=(n, os.path.join(d, "store"), backend, fn, tuple(args), d),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
