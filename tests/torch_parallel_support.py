"""The ranks of the ``test_torch_parallel*`` files: module-level functions
that :func:`mgn_tpu_torch.parallel.mesh.spawn` runs in processes of their
own (gloo on the CPU), and the small problem both packages share.  Imports
no JAX: each rank imports this module afresh.  Not a test module itself."""

import dataclasses
import time

import numpy as np
import torch

from mgn_tpu_torch.core import normalizers as N
from mgn_tpu_torch.core.graph import cells_to_edges
from mgn_tpu_torch.data.synthetic import make_channel_mesh, make_trajectory
from mgn_tpu_torch.models.mgn import MGNConfig
from mgn_tpu_torch.parallel import halo as H
from mgn_tpu_torch.parallel.mesh import make_device_mesh
from mgn_tpu_torch.parallel.partition import (add_deep_halo_plan, add_halo_plan,
                                              partition_template)
from mgn_tpu_torch.parallel.rollout import (gather_prediction, make_sharded_rollout_fn,
                                            unpermute_sharded)
from mgn_tpu_torch.parallel.spmd import (batch_from_partitioned, make_spmd_derivative_step,
                                         partition_stack)
from mgn_tpu_torch.train.common import FieldSpec, NormState, TrainState, param_leaves

MPS, LATENT, HIDDEN = 4, 16, 1
NODES, TL, DT = 120, 8, 0.01
SPEC = FieldSpec(("velocity",), ("velocity",), (2,), (2,))
SAVES = {"euler": TL - 1, "tsit5_adaptive": 3}  # save intervals of each rollout
# the forward forms: (exchange, rounds per exchange)
FORMS = {"gather": ("gather", 0), "halo": ("halo", 0), "deep1": ("deep", 1),
         "deep2": ("deep", 2), "deep4": ("deep", 4)}


def model_config() -> MGNConfig:
    return MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=LATENT,
                     hidden_layers=HIDDEN, message_passing_steps=MPS)


def problem(num_parts: int = 2, nodes: int = NODES):
    """The mesh, its edges, node features and a loss weighting (numpy,
    from seeds), and a velocity trajectory."""
    pos, cells, nt = make_channel_mesh(nodes, seed=0)
    s, r = cells_to_edges(cells)
    rng = np.random.default_rng(0)
    nf = rng.normal(size=(len(pos), 9)).astype(np.float32)
    w = rng.normal(size=(len(pos), 2)).astype(np.float32)
    vel = make_trajectory(pos, nt, TL, DT, seed=1)
    times = np.arange(TL, dtype=np.float32) * DT
    return dict(pos=pos, cells=cells, nt=nt, s=s, r=r, nf=nf, w=w, vel=vel, times=times,
                num_parts=num_parts)


def planned(pb, form: str):
    """The partition with the plan of ``form`` (FORMS)."""
    exchange, k = FORMS[form]
    pt = partition_template(pb["pos"], pb["nt"], pb["s"], pb["r"], pb["num_parts"])
    if exchange == "halo":
        return add_halo_plan(pt)
    if exchange == "deep":
        return dataclasses.replace(pt, deep=add_deep_halo_plan(pt, pb["pos"], pb["s"],
                                                               pb["r"], k, MPS))
    return pt


def fresh_norm() -> NormState:
    return NormState(edge=N.Online.create(3),
                     node={"velocity": N.Online.create(2),
                           "node_type": N.OfflineMinMax.create(0.0, 1.0)},
                     output={"velocity": N.Online.create(2)})


def _forward_grads(params, pb, form, mesh, cfg):
    """One part's forward of ``form`` and the world-summed gradient of the
    weighted sum of its real outputs."""
    pt = planned(pb, form)
    g = mesh.graph_rank
    shard = H.shard_graph(pt, g, FORMS[form][0], "cpu")
    nf = torch.as_tensor(partition_stack(pt, pb["nf"][None])[g, 0])
    w = torch.as_tensor(partition_stack(pt, pb["w"][None])[g, 0])
    leaves = param_leaves(params)
    out = H.apply_shard(params, nf, lambda x: x, shard, cfg, mesh.graph_comm)
    loss = (out * w * shard.node_mask[:, None]).sum()
    grads = []
    for _ in range(2):  # two backward passes: the served-row sums' bits
        g_local = torch.autograd.grad(loss, leaves, retain_graph=True)
        grads.append(mesh.world.all_reduce(torch.cat([x.reshape(-1) for x in g_local])).numpy())
    return out.detach().numpy(), grads


def _synced_norms(pb, mesh, steps: int):
    """``steps`` synced accumulations of the part's velocity rows and own
    edges (frame ``t % TL``), as the SPMD step makes them."""
    pt = planned(pb, "halo")
    g = mesh.graph_rank
    shard = H.shard_graph(pt, g, "halo", "cpu")
    vel = torch.as_tensor(partition_stack(pt, pb["vel"])[g])
    node, edge, after = N.Online.create(2), N.Online.create(3), {}
    for k in range(steps):
        node, edge = N.accumulate_synced_all(
            [(node, vel[k % TL], shard.node_mask), (edge, shard.mef, shard.edge_mask)],
            mesh.world)
        if k + 1 in (TL, steps):
            after[k + 1] = {name: {f: getattr(n, f).numpy().copy() for f in
                                   ("acc_count", "num_accumulations", "acc_sum", "acc_sum_sq")}
                            for name, n in (("node", node), ("edge", edge))}
    return after


def core_rank(rank, params, norm, pb):
    """Mesh (1, 2): every forward form and its gradient, the SPMD step on the
    deep plan from ``params`` (Adam 1e-3, noise-free, two frames), 50 synced
    normalizer accumulations, and the sharded Euler and adaptive rollouts
    with ``norm``."""
    torch.set_num_threads(1)
    mesh = make_device_mesh(1, 2, "gloo", "cpu")
    cfg = model_config()
    params = _clone(params)
    out, t0 = {"forms": {}, "seconds": {}}, time.perf_counter()
    for form in FORMS:
        out["forms"][form] = _forward_grads(params, pb, form, mesh, cfg)
    out["seconds"]["forms"] = time.perf_counter() - t0

    pt = planned(pb, "deep4")
    batch = batch_from_partitioned([pt], [{"velocity": pb["vel"]}], [pb["times"]])
    shard = batch.shard(0, mesh.graph_rank, "deep", "cpu")
    p2 = _clone(params)
    state = TrainState(p2, torch.optim.Adam(param_leaves(p2), lr=1e-3), fresh_norm())
    step = make_spmd_derivative_step(mesh, cfg, SPEC, (0.0,), norm_steps=0)
    state, losses = step(state, shard, np.array([[0], [1]]), 0)
    out["step"] = dict(losses=losses.numpy(),
                       params=[p.detach().numpy() for p in param_leaves(state.params)],
                       norm=_norm_arrays(state.norm))
    out["norms"] = _synced_norms(pb, mesh, 50)
    out["seconds"]["step_norms"] = time.perf_counter() - t0

    out["rollouts"] = {}
    for solver in ("euler", "tsit5_adaptive"):
        stats = []
        fn = make_sharded_rollout_fn(mesh.graph_comm, cfg, SPEC, solver=solver, stats=stats)
        saves = shard.times[:SAVES[solver] + 1]
        with torch.no_grad():
            pred, loss = fn(params, norm, shard.graph, shard.fields, saves, shard.times)
        full = unpermute_sharded(pt, gather_prediction(pred, mesh.graph_comm), len(pb["pos"]))
        out["rollouts"][solver] = dict(pred=full, loss=float(loss), tries=stats,
                                       exchange=dict(mesh.graph_comm.stats))
    out["seconds"]["rollouts"] = time.perf_counter() - t0
    return out


def width_rank(rank, params, pb, latent: int):
    """Mesh (1, 2) at ``latent``, a width the kernels are not built for:
    the deep and the classic forward and their world-summed gradients
    (:func:`_forward_grads`)."""
    torch.set_num_threads(1)
    mesh = make_device_mesh(1, 2, "gloo", "cpu")
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=latent,
                    hidden_layers=HIDDEN, message_passing_steps=MPS)
    params = _clone(params)
    return {form: _forward_grads(params, pb, form, mesh, cfg) for form in ("deep4", "halo")}


def step_rank(rank, params, pb):
    """Mesh (2, 2): the SPMD step over two copies of the trajectory (one a
    data coordinate), as core_rank's."""
    torch.set_num_threads(1)
    mesh = make_device_mesh(2, 2, "gloo", "cpu")
    pt = planned(pb, "deep4")
    batch = batch_from_partitioned([pt, pt], [{"velocity": pb["vel"]}] * 2,
                                   [pb["times"]] * 2)
    shard = batch.shard(mesh.data_rank, mesh.graph_rank, "deep", "cpu")
    p2 = _clone(params)
    state = TrainState(p2, torch.optim.Adam(param_leaves(p2), lr=1e-3), fresh_norm())
    step = make_spmd_derivative_step(mesh, model_config(), SPEC, (0.0,), norm_steps=0)
    state, losses = step(state, shard, np.array([[0, 2], [1, 3]]), 0)
    merged = N.cross_replica_sync(N.Online.create(2).update(
        torch.full((3, 2), float(rank + 1))), mesh.world)
    return dict(losses=losses.numpy(), params=[p.detach().numpy() for p in param_leaves(p2)],
                merged=_norm_arrays(NormState(merged, {}, {}))["edge"])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def _norm_arrays(norm: NormState):
    def arr(n):
        return {f.name: getattr(n, f.name).numpy().copy() for f in dataclasses.fields(n)}
    return {"edge": arr(norm.edge), "node": {k: arr(v) for k, v in norm.node.items()},
            "output": {k: arr(v) for k, v in norm.output.items()}}


def api_rank(rank, ds, workdir, kw):
    """train_network, eval_network and simulate with graph_parallel=2 (the
    deep and the classic exchange), then the command line's train and eval
    through ``main(argv)``."""
    import mgn_tpu_torch
    from mgn_tpu_torch.__main__ import main
    from mgn_tpu_torch.checkpoint.manager import load_model
    from mgn_tpu_torch.data.pipeline import load_dataset
    from mgn_tpu_torch.train.strategies import DerivativeTraining
    from mgn_tpu_torch.utils.metrics import MetricsLogger

    torch.set_num_threads(1)
    out = {}
    for form, extra in (("deep", {}), ("halo", {"halo_rounds": 0})):
        cp = f"{workdir}/cp_{form}"
        log = MetricsLogger(quiet=True)
        state, best = mgn_tpu_torch.train_network(
            0.0, lambda ps: torch.optim.Adam(ps, lr=1e-3), ds, cp, device="cpu", steps=10,
            graph_parallel=2, metrics=log, training_strategy=DerivativeTraining(random=False),
            **kw["train"], **extra)
        torch.distributed.barrier()  # rank 0's checkpoint is written
        reports = mgn_tpu_torch.eval_network(ds, cp, f"{workdir}/out_{form}", device="cpu",
                                             graph_parallel=2, **kw["eval"], **extra)
        tr = load_dataset(ds, is_training=False).trajectory(0)
        sim = mgn_tpu_torch.simulate(ds, cp, tr.mesh_pos, tr.node_type,
                                     {"velocity": tr.fields["velocity"][0]}, tr.times[:4],
                                     cells=tr.cells, device="cpu", graph_parallel=2,
                                     **kw["model"], **extra)
        out[form] = dict(params=[p.detach().numpy() for p in param_leaves(state.params)],
                         best=best, records=log.records, reports=reports, simulate=sim)
    cli_cp = f"{workdir}/cp_cli"
    main(["train", ds, cli_cp, "--steps", "5", "--checkpoint", "5", "--norm-steps", "2",
          "--noise", "0", *kw["cli"], "--graph-parallel", "2", "--dist-backend", "gloo",
          "--device", "cpu"])
    torch.distributed.barrier()
    main(["eval", ds, cli_cp, f"{workdir}/cli_out", "--solver", "euler", "--num-rollouts", "1",
          *kw["cli"], "--graph-parallel", "2", "--dist-backend", "gloo", "--device", "cpu"])
    out["cli_params"] = [p.numpy() for p in param_leaves(
        load_model(cli_cp, False, torch.device("cpu"))[0])]
    from mgn_tpu_torch.api_spmd import _PARTS
    from mgn_tpu_torch.parallel import mesh as M

    out["meshes"] = len(M._MESHES)
    out["parts"] = len(_PARTS[make_device_mesh(1, 2, "gloo", "cpu")])
    return out


class _Stop(Exception):
    """Raised by a patched model loader once it has recorded its device."""


def device_rank(rank, ds, kw):
    """Where the entry points put the model on a multi-card host: with
    ``LOCAL_RANK`` set and two cards faked (``torch.cuda.is_available``,
    ``device_count`` and ``set_device`` patched; no tensor reaches a card),
    the device ``train_network``, ``eval_network`` and ``simulate`` hand to
    ``init_state`` and ``load_model`` (patched to record it and stop), the
    mesh's device and the current device it set.  First, unpatched,
    ``make_device_mesh`` without a device, which must raise (no card
    here).  Then the planner's parts: two planners on the mesh get the same
    part of one trajectory."""
    import os

    import mgn_tpu_torch
    import mgn_tpu_torch.api as api
    from mgn_tpu_torch.api_spmd import GraphPlanner
    from mgn_tpu_torch.config import Args
    from mgn_tpu_torch.data.pipeline import load_dataset

    torch.set_num_threads(1)
    out = {}
    try:
        make_device_mesh(1, 2, "gloo")
        out["no_card"] = None
    except RuntimeError as e:
        out["no_card"] = str(e)

    cpu_mesh = make_device_mesh(1, 2, "gloo", "cpu")
    out["same_mesh"] = make_device_mesh(1, 2, "gloo", "cpu") is cpu_mesh
    tr = load_dataset(ds, is_training=False).trajectory(0)
    meta, args = load_dataset(ds).meta, Args(graph_parallel=2, **kw["model"]).resolve_auto()
    first = GraphPlanner(meta, args, cpu_mesh).part(tr)
    out["same_part"] = GraphPlanner(meta, args, cpu_mesh).part(tr)[0] is first[0]

    os.environ["LOCAL_RANK"] = str(rank)
    current, seen = [], {}
    saved = (torch.cuda.is_available, torch.cuda.device_count, torch.cuda.set_device,
             api.init_state, api.load_model)

    def record(name):
        def stop(*a, **k):
            seen[name] = torch.device(a[-1] if name == "init_state" else a[2])
            raise _Stop
        return stop

    torch.cuda.is_available, torch.cuda.device_count = (lambda: True), (lambda: 2)
    torch.cuda.set_device = current.append
    api.init_state, api.load_model = record("init_state"), record("load_model")
    try:
        calls = {
            "train_network": lambda: mgn_tpu_torch.train_network(
                0.0, lambda ps: torch.optim.Adam(ps), ds, "unused", graph_parallel=2,
                **kw["model"]),
            "eval_network": lambda: mgn_tpu_torch.eval_network(
                ds, "unused", "unused", graph_parallel=2, **kw["eval"]),
            "simulate": lambda: mgn_tpu_torch.simulate(
                ds, "unused", tr.mesh_pos, tr.node_type, {"velocity": tr.fields["velocity"][0]},
                tr.times[:2], cells=tr.cells, graph_parallel=2, **kw["model"]),
        }
        for name, call in calls.items():
            try:
                call()
            except _Stop:
                out[name] = seen.pop("init_state" if name == "train_network" else "load_model")
        out["mesh"] = make_device_mesh(1, 2, "gloo").device
    finally:
        (torch.cuda.is_available, torch.cuda.device_count, torch.cuda.set_device,
         api.init_state, api.load_model) = saved
    out["current"] = [torch.device(d) for d in current]
    return out
