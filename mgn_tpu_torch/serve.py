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
counterpart of the JAX artefact's lowering for several platforms.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mgn_tpu_torch._device import resolve_device
from mgn_tpu_torch.ops import library as _library  # noqa: F401  (the operators an artefact calls)

if TYPE_CHECKING:
    from mgn_tpu_torch.train.cloth import ClothConfig
    from mgn_tpu_torch.train.common import NormState

__all__ = ["export_simulator", "export_cloth_simulator", "load_simulator", "cloth_simulator"]

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
    ``leaves`` (dicts, lists, tuples and dataclasses are walked)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach())
        names.append(path)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _split(v, leaves, names, f"{path}__{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, leaves, names, f"{path}__{i}") for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _split(getattr(tree, f.name), leaves, names, f"{path}__{f.name}")
            for f in dataclasses.fields(tree)})
    return tree


def _join(tree: Any, leaves: Sequence[torch.Tensor]) -> Any:
    """The inverse of :func:`_split`."""
    if isinstance(tree, _Leaf):
        return leaves[tree.index]
    if isinstance(tree, dict):
        return {k: _join(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_join(v, leaves) for v in tree)
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


def _export(state: Dict[str, Any], run: Callable, example: Sequence[torch.Tensor],
            info: Dict[str, Any]) -> bytes:
    program = torch.export.export(_Artefact(state, run), tuple(example), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_INFO: json.dumps(info)})
    return buf.getvalue()


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
    permutation through ``order`` (template row -> node id) happen inside.
    ``solver`` is a fixed-step method (``euler``, ``heun``, ``rk4``,
    ``tsit5``); the adaptive Tsit5 takes a host decision at every try and
    does not trace (``NotImplementedError``, ROADMAP.md A5.1).
    ``platforms`` may name only the export ``device`` (``None``: the GPU,
    raising without one; ``"cpu"``: the plain PyTorch path's operators).
    ``kwargs`` are :class:`~mgn_tpu_torch.config.Args` fields."""
    from mgn_tpu_torch.api import build_model_config
    from mgn_tpu_torch.checkpoint.manager import load_model
    from mgn_tpu_torch.config import Args
    from mgn_tpu_torch.data.meta import load_meta
    from mgn_tpu_torch.data.pipeline import Trajectory
    from mgn_tpu_torch.data.prep import prepare_trajectory
    from mgn_tpu_torch.rollout.evaluate import make_rollout_fn

    dev = resolve_device(device)
    _check_platforms(platforms, dev)
    if solver == "tsit5_adaptive":
        raise NotImplementedError(
            "an artefact of the adaptive Tsit5 is not ported yet (ROADMAP.md, A5.1): its step "
            "controller decides on the host at every try, which torch.export cannot trace; "
            "export a fixed-step solver (euler, heun, rk4, tsit5)")
    args = Args(**kwargs).resolve_auto()
    if args.graph_parallel > 1:
        raise NotImplementedError("a sharded artefact (export_sharded_simulator, "
                                  "graph_parallel > 1) is not ported yet (ROADMAP.md, A7b)")
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
    prep = prepare_trajectory(traj, meta, spec, spatial_reorder=args.spatial_reorder,
                              device=dev)
    n_pad = prep.template.num_nodes
    rollout_fn = make_rollout_fn(
        model_cfg, spec, solver=solver, types_updated=args.types_updated,
        types_inflow=args.types_inflow, rtol=args.rtol, atol=args.atol, forced=False)

    def run(state, times, *initial):
        order = state["order"]
        fields = {name: torch.cat([x.index_select(0, order),
                                   x.new_zeros((n_pad - n_raw, x.shape[1]))])[None]
                  for name, x in zip(spec.fields, initial)}  # (T = 1, N_pad, dim)
        pred = rollout_fn(state["params"], state["norm"], state["template"], fields, times,
                          times[:1])[:, :n_raw]
        return pred.new_zeros(pred.shape).index_copy(1, order, pred)

    # the port keeps the caller's node order (no spatial reordering): order is the identity
    state = dict(params=params, norm=norm, template=prep.template,
                 order=torch.arange(n_raw, device=dev))
    example = [torch.zeros((int(num_steps),), device=dev)]
    example += [torch.zeros((n_raw, d), device=dev) for d in spec.field_dims]
    return _export(state, run, example, dict(kind="simulator", device=dev.type,
                                             num_steps=int(num_steps), nodes=n_raw,
                                             field_dims=list(spec.field_dims), solver=solver))


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
    return _export(state, run, example, dict(kind="cloth_simulator", device=dev.type,
                                             num_steps=int(num_steps), nodes=n_raw,
                                             field_dims=[wd]))


def load_simulator(blob: bytes, device: Optional[Union[str, torch.device]] = None
                   ) -> Callable[..., np.ndarray]:
    """Deserialize an :func:`export_simulator` or
    :func:`export_cloth_simulator` artefact into a callable ``(times,
    *inputs) -> pred``: numpy arrays or tensors in, numpy f32 out, each
    call under ``torch.no_grad()``.  It runs on ``device`` (``None``: the
    GPU, raising without one; ``"cpu"``: the plain versions of the
    operators), moved there where it was exported on another.  Needs
    ``torch`` and :mod:`mgn_tpu_torch.ops.library` only."""
    dev = resolve_device(device)
    extra = {_INFO: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    info = json.loads(extra[_INFO])
    if info["device"] != dev.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    module = program.module()

    def call(*inputs) -> np.ndarray:
        args = [(x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(
            x, np.float32))).to(dev, torch.float32) for x in inputs]
        with torch.no_grad():
            pred = module(*args)
        return pred.cpu().numpy()

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
