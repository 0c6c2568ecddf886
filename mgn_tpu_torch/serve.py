"""Serving: self-contained artefacts of the learned simulator
(:func:`export_simulator`, :func:`export_cloth_simulator`,
:func:`load_simulator`, the port's ``mgn_tpu/serve.py``) and the cloth
family's eager simulator (:func:`cloth_simulator`).

An artefact is an ``nn.Module`` whose buffers hold the trained weights, the
normalizers, the graph template and the node ``order``, exported with
``torch.export.export(..., strict=False)`` at a fixed number of steps and
nodes and saved with ``torch.export.save`` to bytes.  Its graph holds the
serving kernels by name as the operators of
:mod:`mgn_tpu_torch.ops.library` (``torch.ops.mgn_tpu_torch.*``: the
weight-stream layout, K7, K2, K1 and K3), which a traced call reaches
through their fake implementations, so export reads no pointer and
launches nothing.  The deployment site needs no model code, checkpoint or
``meta.json``: only ``torch`` and the port's operator library
(``mgn_tpu_torch.ops``), whose CUDA kernels build from the repository's
sources at their first launch.  The JAX package's artefact needs only
``jax``; the port's cannot do without the operators it calls.

An artefact runs on the device it was exported on; :func:`load_simulator`
moves it to another (``torch.export.passes.move_to_device_pass``), the
counterpart of the JAX artefact's lowering for several platforms.  The
adaptive Tsit5's artefact holds its step controller on the device (a
``while_loop``).  :func:`export_sharded_simulator` and
:func:`load_sharded_simulator` are the graph-parallel pair: one program a
rank of a process group, whose exchanges are functional collectives held by
the group's name, all of them in one set of bytes.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.ops import library as _library  # noqa: F401  (the operators an artefact calls)

if TYPE_CHECKING:
    from mgn_tpu_torch.train.cloth import ClothConfig
    from mgn_tpu_torch.train.common import NormState

__all__ = ["export_simulator", "export_cloth_simulator", "export_sharded_simulator",
           "load_simulator", "load_sharded_simulator", "cloth_simulator"]

_INFO = "mgn_tpu_torch.json"  # the artefact's description, saved beside its program
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def _check_platforms(platforms: Optional[Sequence[str]], dev: torch.device) -> None:
    """``platforms`` (the JAX signature's) may name the export device only."""
    for name in platforms or ():
        kind = _PLATFORMS.get(str(name).lower())
        if kind is None:
            raise ValueError(f"platform {name!r}: the port's artefacts run on 'cpu' or "
                             "'cuda' ('gpu')")
        if kind != dev.type:
            raise ValueError(f"platform {name!r} is not the export device {dev}: export on "
                             "it, or move the artefact at load (load_simulator(device=))")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    index: int


def _split(tree: Any, leaves: List[torch.Tensor], names: List[str], path: str) -> Any:
    """``tree`` with each tensor replaced by a :class:`_Leaf` that indexes
    ``leaves`` (dicts, lists, tuples, named tuples and dataclasses are
    walked)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach())
        names.append(path)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _split(v, leaves, names, f"{path}__{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [_split(v, leaves, names, f"{path}__{i}")
                               for i, v in enumerate(tree)])
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _split(getattr(tree, f.name), leaves, names, f"{path}__{f.name}")
            for f in dataclasses.fields(tree)})
    return tree


def _rebuild(tree: Union[list, tuple], items: List[Any]) -> Union[list, tuple]:
    """A list or tuple of ``tree``'s type holding ``items``: a named tuple
    takes them field by field."""
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _join(tree: Any, leaves: Sequence[torch.Tensor]) -> Any:
    """The inverse of :func:`_split`."""
    if isinstance(tree, _Leaf):
        return leaves[tree.index]
    if isinstance(tree, dict):
        return {k: _join(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [_join(v, leaves) for v in tree])
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _join(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree)})
    return tree


class _Artefact(torch.nn.Module):
    """``run(state, *inputs)`` with ``state``'s tensors (weights,
    normalizers, template, order) held as buffers, so that export saves
    them with the program."""

    def __init__(self, state: Dict[str, Any], run: Callable):
        super().__init__()
        leaves: List[torch.Tensor] = []
        names: List[str] = []
        self._spec = _split(state, leaves, names, "")
        self._names = [n.strip("_") for n in names]
        for name, t in zip(self._names, leaves):
            self.register_buffer(name, t)
        self._run = run

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        state = _join(self._spec, [getattr(self, n) for n in self._names])
        return self._run(state, *inputs)


def _outputs(pred: torch.Tensor, tries: List[torch.Tensor]):
    """A program's outputs: ``pred``, and where the adaptive controller ran,
    its ``(T - 1, 2)`` tries per save interval (``tries`` holds them)."""
    return (pred, tries.pop()) if tries else pred


def _export(state: Dict[str, Any], run: Callable, example: Sequence[torch.Tensor]):
    """``run(state, *example)`` exported, ``state``'s tensors as buffers."""
    program = torch.export.export(_Artefact(state, run), tuple(example), strict=False)
    for module in program.graph_module.modules():  # the while_loop bodies' graphs too
        for node in module.graph.nodes:
            node.meta.pop("stack_trace", None)  # tens of MB of traced source lines
    return program


def _save(program, info: Dict[str, Any]) -> bytes:
    """``program``'s bytes with ``info`` beside it."""
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_INFO: json.dumps(info)})
    return buf.getvalue()


def _serving_model(meta_dir: str, cp_path: str, mesh_pos: np.ndarray, node_type: np.ndarray,
                   cells: Optional[np.ndarray], edges: Optional[np.ndarray], args,
                   dev: torch.device):
    """The model, its normalizers and a one-frame trajectory of zeros on the
    caller's mesh: ``(meta, model_cfg, spec, params, norm, traj)``."""
    from mgn_tpu_torch.api import build_model_config
    from mgn_tpu_torch.checkpoint.manager import load_model
    from mgn_tpu_torch.data.meta import load_meta
    from mgn_tpu_torch.data.pipeline import Trajectory

    meta = load_meta(meta_dir)
    if meta.get("world_edges"):
        raise ValueError("a cloth/world-edge meta: export it with export_cloth_simulator")
    model_cfg, spec = build_model_config(meta, args)
    params, norm = load_model(cp_path, args.use_valid, dev)
    node_type = np.asarray(node_type, np.int32).reshape(-1)
    n_raw = node_type.shape[0]
    traj = Trajectory(
        mesh_pos=np.asarray(mesh_pos, np.float32),
        node_type=node_type,
        times=np.zeros((1,), np.float32),
        fields={f: np.zeros((1, n_raw, d), np.float32)
                for f, d in zip(spec.fields, spec.field_dims)},
        cells=None if cells is None else np.asarray(cells, np.int32),
        edges=None if edges is None else np.asarray(edges, np.int32),
    )
    return meta, model_cfg, spec, params, norm, traj


def _examples(num_steps: int, n_raw: int, field_dims: Sequence[int],
              dev: torch.device) -> List[torch.Tensor]:
    """The example inputs a simulator is exported at: ``times`` and one
    initial field a dynamic field."""
    return ([torch.zeros((int(num_steps),), device=dev)]
            + [torch.zeros((n_raw, d), device=dev) for d in field_dims])


def export_simulator(
    meta_dir: str,
    cp_path: str,
    mesh_pos: np.ndarray,
    node_type: np.ndarray,
    num_steps: int,
    cells: Optional[np.ndarray] = None,
    edges: Optional[np.ndarray] = None,
    solver: str = "euler",
    platforms: Optional[Sequence[str]] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> bytes:
    """Serialize the simulator for one mesh topology: the rollout of
    :func:`mgn_tpu_torch.simulate` (no dataset, no ground-truth forcing) as
    an artefact for :func:`load_simulator`.

    The exported function has signature ``(times (num_steps,),
    *initial_fields (N, dim)) -> pred (num_steps, N, output_dim)``, one
    initial field per dynamic field of the meta in its order, in the
    caller's node order: the padding to the template's node bucket and the
    permutation through ``order`` (template row -> node id, the spatial
    reordering's where ``spatial_reorder``) happen inside.
    ``solver`` is a fixed-step method (``euler``, ``heun``, ``rk4``,
    ``tsit5``) or ``tsit5_adaptive``, whose step controller the artefact
    runs on the device (:func:`~mgn_tpu_torch.rollout.integrators.
    odeint_tsit5_loop`, a ``while_loop`` in the program: no host sync);
    its program also returns the tries per save interval, which the loaded
    callable keeps as ``stats``.
    ``platforms`` may name only the export ``device`` (``None``: the GPU,
    raising without one; ``"cpu"``: the plain PyTorch path's operators).
    ``kwargs`` are :class:`~mgn_tpu_torch.config.Args` fields; a
    ``graph_parallel`` above 1 is :func:`export_sharded_simulator`'s."""
    from mgn_tpu_torch.config import Args
    from mgn_tpu_torch.data.prep import prepare_trajectory
    from mgn_tpu_torch.rollout.evaluate import make_rollout_fn

    dev = resolve_device(device)
    _check_platforms(platforms, dev)
    args = Args(**kwargs).resolve_auto()
    if args.graph_parallel > 1:
        raise ValueError("graph_parallel > 1 is a sharded artefact: call "
                         "export_sharded_simulator on every rank of the graph group")
    meta, model_cfg, spec, params, norm, traj = _serving_model(
        meta_dir, cp_path, mesh_pos, node_type, cells, edges, args, dev)
    n_raw = traj.num_nodes
    prep = prepare_trajectory(traj, meta, spec, spatial_reorder=args.spatial_reorder,
                              device=dev)
    n_pad = prep.template.num_nodes
    tries: List[torch.Tensor] = []  # the adaptive controller's, at trace time
    rollout_fn = make_rollout_fn(
        model_cfg, spec, solver=solver, types_updated=args.types_updated,
        types_inflow=args.types_inflow, rtol=args.rtol, atol=args.atol, forced=False,
        stats=tries)

    def run(state, times, *initial):
        order = state["order"]
        fields = {name: torch.cat([x.index_select(0, order),
                                   x.new_zeros((n_pad - n_raw, x.shape[1]))])[None]
                  for name, x in zip(spec.fields, initial)}  # (T = 1, N_pad, dim)
        pred = rollout_fn(state["params"], state["norm"], state["template"], fields, times,
                          times[:1])[:, :n_raw]
        return _outputs(pred.new_zeros(pred.shape).index_copy(1, order, pred), tries)

    order = (torch.arange(n_raw) if prep.order is None  # template row -> node id
             else torch.as_tensor(prep.order, dtype=torch.int64))
    state = dict(params=params, norm=norm, template=prep.template, order=order.to(dev))
    program = _export(state, run, _examples(num_steps, n_raw, spec.field_dims, dev))
    return _save(program, dict(kind="simulator", device=dev.type, num_steps=int(num_steps),
                               nodes=n_raw, field_dims=list(spec.field_dims), solver=solver))


def export_sharded_simulator(
    meta_dir: str,
    cp_path: str,
    mesh_pos: np.ndarray,
    node_type: np.ndarray,
    num_steps: int,
    cells: Optional[np.ndarray] = None,
    edges: Optional[np.ndarray] = None,
    solver: str = "euler",
    graph_parallel: int = 2,
    platforms: Optional[Sequence[str]] = None,
    device: Optional[Union[str, torch.device]] = None,
    **kwargs: Any,
) -> bytes:
    """Serialize the graph-parallel simulator for one mesh topology: the
    rollout of ``simulate(graph_parallel=P)`` as an artefact for
    :func:`load_sharded_simulator`.

    A collective call: every rank of a process group of ``graph_parallel``
    ranks (``torchrun --nproc-per-node P``, or
    :func:`mgn_tpu_torch.parallel.mesh.spawn`) calls it with the same
    arguments; outside one it raises ``ValueError`` naming torchrun.  Each
    rank plans its part as the sharded ``simulate`` does
    (:class:`~mgn_tpu_torch.api_spmd.GraphPlanner`: the deep halo with
    ``halo_rounds`` rounds an exchange, the classic one with
    ``halo_rounds=0``, ``telescope_stages``) and traces its own program,
    which holds the part's tables, the weights and the normalizers: it
    scatters the caller's fields into the part's rows, rolls the part out
    with its exchanges (:func:`~mgn_tpu_torch.parallel.rollout.
    make_part_rollout_fn`; the adaptive Tsit5's error norm summed over the
    group inside its device loop), all-gathers the parts and takes the
    caller's node order, all on the device.  The signature is
    :func:`export_simulator`'s, ``(times, *initial_fields) -> pred`` in the
    caller's node order.  The collectives are held by the graph group's
    name, which :func:`load_sharded_simulator` points at the loading group.

    Returns the same bytes on every rank: every rank's program and one JSON
    description (P, the device type, ``num_steps``, nodes, field dims,
    solver and the group name baked in the programs).  ``device``: this
    rank's (``None``: ``cuda:LOCAL_RANK``, raising without a GPU;
    ``"cpu"``); ``platforms`` as for :func:`export_simulator`; ``kwargs``
    are :class:`~mgn_tpu_torch.config.Args` fields."""
    import torch.distributed as dist

    from mgn_tpu_torch.api_spmd import GraphPlanner, rank_mesh
    from mgn_tpu_torch.config import Args
    from mgn_tpu_torch.parallel.partition import global_ids
    from mgn_tpu_torch.parallel.rollout import gather_parts, make_part_rollout_fn

    args = Args(graph_parallel=int(graph_parallel), **kwargs).resolve_auto()
    if args.batchsize > 1:
        raise ValueError("a sharded artefact serves one trajectory: batchsize must be 1")
    mesh = rank_mesh(args, resolve_device(device))
    dev, comm = mesh.device, mesh.graph_comm
    _check_platforms(platforms, dev)
    meta, model_cfg, spec, params, norm, traj = _serving_model(
        meta_dir, cp_path, mesh_pos, node_type, cells, edges, args, dev)
    n_raw = traj.num_nodes
    shard, pt = GraphPlanner(meta, args, mesh).part(traj)
    n_p, g = pt.part_nodes, mesh.graph_rank
    gids = global_ids(pt, n_raw)  # node id -> part * N_p + row
    mine = np.nonzero(gids // n_p == g)[0]  # this part's node ids
    tries: List[torch.Tensor] = []
    rollout_fn = make_part_rollout_fn(
        comm, model_cfg, spec, solver=solver, types_updated=args.types_updated,
        types_inflow=args.types_inflow, rtol=args.rtol, atol=args.atol, forced=False,
        stats=tries)

    def run(state, times, *initial):
        fields = {name: x.new_zeros((n_p, x.shape[1])).index_copy(
            0, state["rows"], x.index_select(0, state["mine"]))[None]
            for name, x in zip(spec.fields, initial)}  # (T = 1, N_p, dim)
        pred = rollout_fn(state["params"], state["norm"], state["shard"], fields, times,
                          times[:1])
        full = gather_parts(pred, comm).reshape(pred.shape[0], -1, pred.shape[-1])
        return _outputs(full.index_select(1, state["gids"]), tries)

    t = lambda a: torch.as_tensor(np.asarray(a, np.int64)).to(dev)  # noqa: E731
    state = dict(params=params, norm=norm, shard=shard, mine=t(mine), rows=t(gids[mine] - g * n_p),
                 gids=t(gids))
    program = _save(_export(state, run, _examples(num_steps, n_raw, spec.field_dims, dev)), {})
    programs: List[Optional[bytes]] = [None] * comm.size
    dist.all_gather_object(programs, (str(dev), program), group=comm.group)
    info = dict(kind="sharded_simulator", graph_parallel=comm.size, device=dev.type,
                devices=[d for d, _ in programs], num_steps=int(num_steps), nodes=n_raw,
                field_dims=list(spec.field_dims), solver=solver,
                group=comm.group.group_name, exchange=shard.exchange)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        entries = [(_INFO, json.dumps(info).encode())]
        entries += [(f"rank{r}.pt2", blob) for r, (_, blob) in enumerate(programs)]
        for name, data in entries:  # a fixed date: the same bytes from the same programs
            z.writestr(zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0)), data)
    return buf.getvalue()


def export_cloth_simulator(
    params: Dict[str, Any],
    norm: "NormState",
    mesh_pos: np.ndarray,
    node_type: np.ndarray,
    cells: np.ndarray,
    cfg: "ClothConfig",
    num_steps: int,
    platforms: Optional[Sequence[str]] = None,
    type_min: int = 0,
    type_max: int = 6,
    device: Optional[Union[str, torch.device]] = None,
) -> bytes:
    """Serialize the cloth simulator (the multi-edge-set family) for one
    mesh: :func:`cloth_simulator`'s rollout — the semi-implicit
    second-order integration of ``make_cloth_rollout`` with the world-edge
    radius query at every step, which traces as device code (the Gram
    distances, ``topk``, the world set's receiver order by ``sort`` and
    ``searchsorted``) — as an artefact for :func:`load_simulator`.  Its
    signature is ``(times (T,), wp_drive (T, N, 3)) -> pred (T, N, 3)``
    with ``T = num_steps``; rows of ``wp_drive`` at handle nodes (types
    outside ``cfg.types_updated``) are the drive read at every step, the
    others only at the first two frames.  ``type_min`` / ``type_max`` must
    match the meta's ``node_type`` range; ``platforms`` and ``device`` as
    for :func:`export_simulator`."""
    from mgn_tpu_torch._device import tree_to
    from mgn_tpu_torch.core.graph import build_template
    from mgn_tpu_torch.train.cloth import make_cloth_rollout

    dev = resolve_device(device)
    _check_platforms(platforms, dev)
    node_type = np.asarray(node_type, np.int32).reshape(-1)
    n_raw, wd = node_type.shape[0], cfg.world_dim
    template = build_template(np.asarray(mesh_pos, np.float32), node_type,
                              cells=np.asarray(cells, np.int32), type_min=type_min,
                              type_max=type_max).to(dev)
    n_pad = template.num_nodes
    rollout = make_cloth_rollout(cfg)

    def run(state, times, wp_drive):
        padded = torch.cat([wp_drive, wp_drive.new_zeros((wp_drive.shape[0], n_pad - n_raw,
                                                          wd))], dim=1)
        return rollout(state["params"], state["norm"], state["template"], padded,
                       times)[:, :n_raw]

    state = dict(params=tree_to(params, dev), norm=norm.to(dev), template=template)
    example = [torch.zeros((int(num_steps),), device=dev),
               torch.zeros((int(num_steps), n_raw, wd), device=dev)]
    return _save(_export(state, run, example), dict(
        kind="cloth_simulator", device=dev.type, num_steps=int(num_steps), nodes=n_raw,
        field_dims=[wd]))


def load_simulator(blob: bytes, device: Optional[Union[str, torch.device]] = None
                   ) -> Callable[..., np.ndarray]:
    """Deserialize an :func:`export_simulator` or
    :func:`export_cloth_simulator` artefact into a callable ``(times,
    *inputs) -> pred``: numpy arrays or tensors in, numpy f32 out, each
    call under ``torch.no_grad()``.  It runs on ``device`` (``None``: the
    GPU, raising without one; ``"cpu"``: the plain versions of the
    operators), moved there where it was exported on another.  Needs
    ``torch`` and :mod:`mgn_tpu_torch.ops.library` only.  The callable's
    ``stats`` holds the adaptive controller's ``(accepted, rejected)``
    tries per save interval of its last call (empty for a fixed-step
    solver)."""
    dev = resolve_device(device)
    extra = {_INFO: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    info = json.loads(extra[_INFO])
    return _callable(_on_device(program, info["device"], dev).module(), dev)


def load_sharded_simulator(blob: bytes, device: Optional[Union[str, torch.device]] = None,
                           group=None) -> Callable[..., np.ndarray]:
    """Deserialize an :func:`export_sharded_simulator` artefact on this rank
    into a callable ``(times, *initial_fields) -> pred`` (numpy or tensors
    in, numpy f32 out, each call under ``torch.no_grad()``), the whole
    prediction in the caller's node order on every rank.

    A collective call, as every call of the result is: every rank of
    ``group`` (default: the world) loads the bytes, and the group must have
    exactly the artefact's P ranks (``ValueError`` otherwise, and outside a
    process group, naming torchrun).  Group rank ``r`` takes program ``r``,
    whose collectives are pointed at ``group`` (the group name baked at
    export need not exist here), moves it to ``device`` (``None``:
    ``cuda:LOCAL_RANK``, raising without a GPU; ``"cpu"``) and builds its
    module once.  ``stats`` as for :func:`load_simulator`."""
    import torch.distributed as dist

    from mgn_tpu_torch.parallel.mesh import rank_device

    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        info = json.loads(z.read(_INFO))
        P = int(info["graph_parallel"])
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(f"a sharded artefact runs on a process group of {P} ranks (found "
                             f"none): launch one process per rank, e.g. torchrun "
                             f"--nproc-per-node {P}, or initialize one "
                             "(mgn_tpu_torch.parallel.mesh.initialize_multihost)")
        group = dist.group.WORLD if group is None else group
        size = dist.get_world_size(group)
        if size != P:
            raise ValueError(f"artefact needs {P} ranks, got {size}")
        rank = dist.get_rank(group)
        program = torch.export.load(io.BytesIO(z.read(f"rank{rank}.pt2")))
    dev = rank_device(device)
    program = _on_device(program, info["devices"][rank], dev)
    _point_collectives(program, info["group"], group.group_name)
    return _callable(program.module(), dev)


def _point_collectives(program, baked: str, name: str) -> None:
    """Point every functional collective of ``program`` (its while_loop
    bodies' too) from the group named ``baked`` at the group named ``name``."""
    for module in program.graph_module.modules():
        changed = False
        for node in module.graph.nodes:
            target = node.target
            if node.op != "call_function" or getattr(target, "namespace", "") != "_c10d_functional":
                continue
            for i, arg in enumerate(target._schema.arguments):
                if arg.name != "group_name":
                    continue
                args = list(node.args)
                if args[i] != baked:
                    raise ValueError(f"a collective of group {args[i]!r}, not the artefact's "
                                     f"{baked!r}")
                args[i] = name
                node.args = tuple(args)
                changed = True
        if changed:
            module.recompile()


def _on_device(program, exported_on: str, dev: torch.device):
    """``program`` moved to ``dev`` where it was exported on another device."""
    if torch.device(exported_on) == dev:
        return program
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, dev)


def _callable(module: torch.nn.Module, dev: torch.device) -> Callable[..., np.ndarray]:
    """``module`` as ``(*inputs) -> pred``: inputs to f32 tensors on ``dev``,
    a run under ``torch.no_grad()``, the prediction as numpy; a second
    output (the adaptive controller's tries) goes to ``call.stats``."""
    def call(*inputs) -> np.ndarray:
        args = [(x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(
            x, np.float32))).to(dev, torch.float32) for x in inputs]
        with torch.no_grad():
            out = module(*args)
        pred, tries = out if isinstance(out, (tuple, list)) else (out, None)
        call.stats = [] if tries is None else [tuple(r) for r in tries.tolist()]
        return pred.cpu().numpy()

    call.stats = []
    return call


def cloth_simulator(params: Dict[str, Any], norm: "NormState", mesh_pos: np.ndarray,
                    node_type: np.ndarray, cells: np.ndarray, cfg: "ClothConfig",
                    num_steps: Optional[int] = None, type_min: int = 0, type_max: int = 6,
                    device: Optional[Union[str, torch.device]] = None) -> Callable:
    """The cloth simulator for one mesh, eagerly: ``simulate(times (T,),
    wp_drive (T, N, 3)) -> pred (T, N, 3)`` (numpy, f32), what
    :func:`export_cloth_simulator` bakes into an artefact.  It runs on the
    GPU through the processor kernels (K1, K2, K3 with its ``node_extra``
    form); ``device="cpu"`` runs the plain PyTorch path.

    Rows of ``wp_drive`` at handle nodes (types outside
    ``cfg.types_updated``) are the kinematic drive read at every step; the
    other rows are read only at the first two frames.  ``type_min`` /
    ``type_max`` must match the meta's ``node_type`` range the model was
    configured from.  ``num_steps``, where given, fixes ``T`` as the
    artefact does.  The graph template, the weights and the normalizers
    move to ``device`` once, here (``None``: the GPU, raising without one);
    each call runs under ``torch.no_grad()``.
    """
    from mgn_tpu_torch._device import tree_to
    from mgn_tpu_torch.core.graph import build_template
    from mgn_tpu_torch.train.cloth import make_cloth_rollout

    dev = resolve_device(device)
    node_type = np.asarray(node_type, np.int32).reshape(-1)
    n_raw = node_type.shape[0]
    template = build_template(np.asarray(mesh_pos, np.float32), node_type,
                              cells=np.asarray(cells, np.int32), type_min=type_min,
                              type_max=type_max).to(dev)
    params, norm = tree_to(params, dev), norm.to(dev)
    n_pad, wd = template.num_nodes, cfg.world_dim
    rollout = make_cloth_rollout(cfg)

    def simulate(times, wp_drive) -> np.ndarray:
        times_t = torch.as_tensor(times, dtype=torch.float32).to(dev)
        wp = torch.as_tensor(wp_drive, dtype=torch.float32).to(dev)
        steps = times_t.shape[0]
        if wp.shape != (steps, n_raw, wd) or (num_steps is not None and steps != num_steps):
            raise ValueError(f"expected times ({num_steps or 'T'},) and wp_drive (T, {n_raw}, "
                             f"{wd}), got {tuple(times_t.shape)} and {tuple(wp.shape)}")
        padded = wp.new_zeros((steps, n_pad, wd))
        padded[:, :n_raw] = wp
        with torch.no_grad():
            pred = rollout(params, norm, template, padded, times_t)
        return pred[:, :n_raw].cpu().numpy()

    return simulate
