"""The ranks of ``test_torch_parallel_solver.py``, ``test_torch_parallel_telescope.py``
and ``test_torch_parallel_cloth.py``: module-level functions that
:func:`mgn_tpu_torch.parallel.mesh.spawn` runs in processes of their own
(gloo on the CPU, mesh (1, 2)), and the small problems they share with the
JAX side.  Imports no JAX: each rank imports this module afresh.  Not a
test module itself."""

import contextlib
import dataclasses

import numpy as np
import torch

import mgn_tpu_torch.train.solver as port_solver
from mgn_tpu_torch.core.graph import build_template, build_world_edges, cells_to_edges
from mgn_tpu_torch.data.synthetic import flag_meta, make_flag_mesh, make_flag_trajectory
from mgn_tpu_torch.parallel import cloth as C
from mgn_tpu_torch.parallel import halo as H
from mgn_tpu_torch.parallel.mesh import make_device_mesh
from mgn_tpu_torch.parallel.partition import add_deep_halo_plan, partition_template
from mgn_tpu_torch.parallel.rollout import gather_prediction, unpermute_sharded
from mgn_tpu_torch.parallel.spmd import (RankShard, batch_from_partitioned, make_spmd_solver_step,
                                         partition_stack)
from mgn_tpu_torch.train.cloth import ClothConfig, cloth_model_config
from mgn_tpu_torch.train.common import NormState, TrainState, param_leaves
from mgn_tpu_torch.train.strategies import MultipleShooting, SolverTraining

from tests import torch_parallel_support as S

# --- solver training -------------------------------------------------------------------------

SOLVER_LR = 1e-2  # SGD: the update is the gradient
SOLVER_CASES = {
    "euler": (SolverTraining, dict(tstart=0.0, dt=S.DT, tstop=0.05, solver="euler")),
    "rk4_remat": (SolverTraining, dict(tstart=0.0, dt=S.DT, tstop=0.03, solver="rk4",
                                       remat=True)),
    "tsit5": (SolverTraining, dict(tstart=0.0, dt=S.DT, tstop=0.03, solver="tsit5_adaptive",
                                   remat=False, adaptive_substeps=4)),
    "shooting": (MultipleShooting, dict(tstart=0.0, dt=S.DT, tstop=0.07, interval_size=3,
                                        continuity_term=10.0, solver="euler")),
}
NAN_FRAME = 2  # the frame the guard's case poisons on rank 0's part


def solver_strategy(case: str):
    cls, kw = SOLVER_CASES[case]
    return cls(**kw)


@contextlib.contextmanager
def recorded_tries(out: list):
    """While entered, every bounded adaptive Tsit5 solve of the solver
    trainers appends its ``(accepted, rejected)`` tries per interval to
    ``out`` (one list a solve)."""
    inner = port_solver.odeint_tsit5_bounded

    def counted(*args, **kwargs):
        stats = []
        out.append(stats)
        return inner(*args, stats=stats, **kwargs)

    port_solver.odeint_tsit5_bounded = counted
    try:
        yield out
    finally:
        port_solver.odeint_tsit5_bounded = inner


def solver_rank(rank, params, pb):
    """Mesh (1, 2) on the deep plan: two noise-free steps of every
    SOLVER_CASES strategy from ``params`` (SGD), then one Euler step with a
    NaN frame on rank 0's part."""
    torch.set_num_threads(1)
    mesh = make_device_mesh(1, 2, "gloo", "cpu")
    cfg = S.model_config()
    pt = S.planned(pb, "deep4")
    batch = batch_from_partitioned([pt], [{"velocity": pb["vel"]}], [pb["times"]])
    shard = batch.shard(0, mesh.graph_rank, "deep", "cpu")
    out = {}
    for case in SOLVER_CASES:
        p2 = S._clone(params)
        state = TrainState(p2, torch.optim.SGD(param_leaves(p2), lr=SOLVER_LR), S.fresh_norm())
        step = make_spmd_solver_step(mesh, cfg, S.SPEC, solver_strategy(case), norm_steps=0)
        tries = []
        with recorded_tries(tries):
            losses = [float(step(state, shard)[1][0]) for _ in range(2)]
        out[case] = dict(losses=losses, params=[p.detach().numpy() for p in param_leaves(p2)],
                         norm=S._norm_arrays(state.norm), tries=tries, step=state.step)
    vel = shard.fields["velocity"].clone()
    if mesh.graph_rank == 0:
        vel[NAN_FRAME] = float("nan")
    p2 = S._clone(params)
    before = [p.detach().clone() for p in param_leaves(p2)]
    state = TrainState(p2, torch.optim.SGD(param_leaves(p2), lr=SOLVER_LR), S.fresh_norm())
    step = make_spmd_solver_step(mesh, cfg, S.SPEC, solver_strategy("euler"), norm_steps=0)
    _, loss = step(state, RankShard(shard.graph, {"velocity": vel}, shard.times))
    out["nan"] = dict(loss=float(loss[0]), step=state.step,
                      unchanged=all(torch.equal(a, b.detach())
                                    for a, b in zip(before, param_leaves(p2))))
    return out


# --- telescoped stages -----------------------------------------------------------------------

# (rounds per exchange, telescope): the single segment (k = MPS) and the multi-segment
# schedule (k < MPS, depth 2k - 1)
TELESCOPES = {"k4_2x2": (4, (2, 2)), "k4_1x4": (4, (1, 1, 1, 1)), "k2_1x2": (2, (1, 1)),
              "k4_2_1_1": (4, (2, 1, 1))}


def telescoped(pb, name: str):
    k, tel = TELESCOPES[name]
    pt = partition_template(pb["pos"], pb["nt"], pb["s"], pb["r"], pb["num_parts"])
    return dataclasses.replace(pt, deep=add_deep_halo_plan(pt, pb["pos"], pb["s"], pb["r"], k,
                                                           S.MPS, telescope=tel))


def grads_of(params, forward, w, node_mask, mesh):
    """``forward(params)``'s rows and the world-summed gradient of the
    weighted sum of its real rows, flat."""
    p = S._clone(params)
    leaves = param_leaves(p)
    out = forward(p)
    grads = torch.autograd.grad((out * w * node_mask[:, None]).sum(), leaves)
    flat = mesh.world.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    return dict(out=out.detach().numpy(), grads=flat.numpy())


def telescope_rank(rank, params, pb, ds, workdir, kw):
    """Mesh (1, 2): each TELESCOPES plan's forward and gradient, the stages'
    row counts, then train_network with and without telescope_stages=2."""
    import mgn_tpu_torch
    from mgn_tpu_torch.train.strategies import DerivativeTraining
    from mgn_tpu_torch.utils.metrics import MetricsLogger

    torch.set_num_threads(1)
    mesh = make_device_mesh(1, 2, "gloo", "cpu")
    cfg = S.model_config()
    out = {"forms": {}}
    for name in TELESCOPES:
        pt = telescoped(pb, name)
        shard = H.shard_graph(pt, mesh.graph_rank, "deep", "cpu")
        nf = torch.as_tensor(partition_stack(pt, pb["nf"][None])[mesh.graph_rank, 0])
        w = torch.as_tensor(partition_stack(pt, pb["w"][None])[mesh.graph_rank, 0])
        res = grads_of(params, lambda p: H.apply_shard(p, nf, lambda x: x, shard, cfg,
                                                       mesh.graph_comm), w, shard.node_mask,
                       mesh)
        res["rows"] = [(st.tables.rows, int(st.tables.senders.shape[0])) for st in shard.stages]
        res["ext"] = (shard.tables.rows, int(shard.tables.senders.shape[0]))
        out["forms"][name] = res
    out["train"] = {}
    for stages in (None, 2):
        log = MetricsLogger(quiet=True)
        state, _ = mgn_tpu_torch.train_network(
            0.0, lambda ps: torch.optim.Adam(ps, lr=1e-3), ds, f"{workdir}/cp_tel{stages}",
            device="cpu", steps=6, graph_parallel=2, metrics=log, telescope_stages=stages,
            training_strategy=DerivativeTraining(window_size=2, random=False), **kw)
        out["train"][stages] = dict(
            losses=[r["loss"] for r in log.records if r["kind"] == "train"],
            params=[p.detach().numpy() for p in param_leaves(state.params)])
    return out


# --- the cloth family ------------------------------------------------------------------------

FLAG_MESH, FLAG_T, FLAG_DT = (14, 9), 6, 0.02
CLOTH_LATENT, CLOTH_HIDDEN, CLOTH_MPS, CLOTH_LR = 16, 1, 2, 1e-3
RADIUS = 0.23  # hundreds of world edges on the small sheet, off its lattice spacings
# the whole sheet's hits fit the first capacity; a part's overflow the second
CAPACITIES = {"above": 4096, "below": 64}
CLOTH_PERM = [3, 1, 4, 2]
# the trainer window's optimizers (torch.optim name, learning rate): Adam's update does not
# change when the gradient is scaled, SGD's is the gradient, so its size is held too
CLOTH_OPTIMIZERS = {"adam": ("Adam", CLOTH_LR), "sgd": ("SGD", 1e-2)}


def cloth_problem():
    """The flag mesh, its edges, a waving trajectory (numpy, from seeds)."""
    pos, cells, nt = make_flag_mesh(*FLAG_MESH)
    s, r = cells_to_edges(cells)
    wp = make_flag_trajectory(pos, nt, tl=FLAG_T, dt=FLAG_DT, seed=3)
    times = (np.arange(FLAG_T) * FLAG_DT).astype(np.float32)
    return dict(pos=pos, cells=cells, nt=nt, s=s, r=r, wp=wp, times=times,
                meta=flag_meta(FLAG_T, 1, 1))


def cloth_config(capacity: int = CAPACITIES["above"], norm_steps: int = 2) -> ClothConfig:
    return ClothConfig(model=cloth_model_config(flag_meta(FLAG_T, 1, 1), latent=CLOTH_LATENT,
                                                hidden_layers=CLOTH_HIDDEN, mps=CLOTH_MPS),
                       world_radius=RADIUS, world_capacity=capacity, noise_stddev=0.0,
                       norm_steps=norm_steps)


def cloth_partition(cp, parts: int = 2):
    return partition_template(cp["pos"], cp["nt"], cp["s"], cp["r"], parts, type_min=0,
                              type_max=6)


def cloth_rank(rank, params, norm, cp):
    """Mesh (1, 2): the part's world edges at every capacity and frame, the
    sharded forward, one noise-free trainer window from ``params`` with each
    of CLOTH_OPTIMIZERS (two warm-up steps) and the sharded rollout with
    ``norm``."""
    torch.set_num_threads(1)
    mesh = make_device_mesh(1, 2, "gloo", "cpu")
    comm = mesh.graph_comm
    pt = cloth_partition(cp)
    shard = H.shard_graph(pt, comm.rank, "gather", "cpu")
    wp = torch.as_tensor(np.ascontiguousarray(C.partition_field_stack(pt, cp["wp"])[:, comm.rank]))
    times = torch.as_tensor(cp["times"])
    rl = shard.tables.receivers - comm.rank * pt.part_nodes
    out = {"world": {}}
    for name, cap in CAPACITIES.items():
        out["world"][name] = [
            [x.numpy() for x in C.build_world_edges_sharded(
                wp[t], shard.node_mask, RADIUS, cap, comm,
                exclude_senders=shard.tables.senders, exclude_receivers=rl)]
            for t in range(FLAG_T)]
    cfg = cloth_config()
    # the forward at frame 1 from the checkpointed normalizers, features as the trainer's
    with torch.no_grad():
        vel = (wp[1] - wp[0]) / (times[1] - times[0])
        wp_full, mesh_raw = C._frame_features(shard, wp[1], comm)
        world, world_raw = C._world(shard, wp[1], wp_full, C._mask_full(shard, comm), cfg,
                                    cfg.world_capacity, comm)
        nf, mef, wef = C._inputs(norm, shard, vel, mesh_raw, world_raw, world[2])
        out["forward"] = C.apply_cloth_sharded(params, nf, mef, wef, shard, world, cfg.model,
                                               comm).numpy()
    out["world_edges"] = [x.numpy() for x in world]

    out["train"] = {}
    trainer = C.make_sharded_cloth_trainer(comm, cfg, cfg.world_capacity)
    for name, (opt, lr) in CLOTH_OPTIMIZERS.items():
        p2 = S._clone(params)
        state = TrainState(p2, getattr(torch.optim, opt)(param_leaves(p2), lr=lr),
                           _cloth_norm(cfg))
        state, losses = trainer(state, shard, wp, times, CLOTH_PERM,
                                torch.Generator().manual_seed(0))
        out["train"][name] = dict(losses=losses.numpy(), step=state.step,
                                  params=[p.detach().numpy() for p in param_leaves(p2)],
                                  norm=_cloth_norm_arrays(state.norm))
    with torch.no_grad():
        pred = C.make_sharded_cloth_rollout(comm, cfg, cfg.world_capacity)(params, norm, shard,
                                                                             wp, times)
    out["rollout"] = unpermute_sharded(pt, gather_prediction(pred, comm), len(cp["pos"]))
    return out


def _cloth_norm_arrays(norm: NormState):
    def arr(n):
        return {f.name: getattr(n, f.name).numpy().copy() for f in dataclasses.fields(n)}
    return {part: {k: arr(v) for k, v in getattr(norm, part).items()}
            for part in ("edge", "node", "output")}


def _cloth_norm(cfg: ClothConfig) -> NormState:
    from mgn_tpu_torch.train.cloth import make_cloth_norm_state
    return make_cloth_norm_state(cfg)


def single_world_edges(cp, capacity: int):
    """The single-device world edges of every frame, as original-order pairs."""
    t = build_template(cp["pos"], cp["nt"], cells=cp["cells"])
    n = len(cp["pos"])
    out = []
    for f in range(FLAG_T):
        wp = np.zeros((t.num_nodes, 3), np.float32)
        wp[:n] = cp["wp"][f]
        s, r, m = build_world_edges(torch.as_tensor(wp), t.node_mask, RADIUS, capacity,
                                    t.senders, t.receivers)
        out.append({(int(a), int(b)) for a, b in zip(s[m].numpy(), r[m].numpy())})
    return out


def cloth_api_rank(rank, ds, workdir, kw):
    """train_network and eval_network on a flag dataset with graph_parallel=2."""
    import mgn_tpu_torch
    from mgn_tpu_torch.train.strategies import DerivativeTraining
    from mgn_tpu_torch.utils.metrics import MetricsLogger

    torch.set_num_threads(1)
    log = MetricsLogger(quiet=True)
    cp = f"{workdir}/cp_cloth_gp"
    state, best = mgn_tpu_torch.train_network(
        0.0, lambda ps: torch.optim.Adam(ps, lr=CLOTH_LR), ds, cp, device="cpu",
        graph_parallel=2, metrics=log, training_strategy=DerivativeTraining(random=False),
        **kw["train"])
    torch.distributed.barrier()  # rank 0's checkpoint is written
    elog = MetricsLogger(quiet=True)
    reports = mgn_tpu_torch.eval_network(ds, cp, f"{workdir}/out_cloth_gp", device="cpu",
                                         graph_parallel=2, metrics=elog, **kw["eval"])
    return dict(losses=[r["loss"] for r in log.records if r["kind"] == "train"],
                valid=[r["loss"] for r in log.records if r["kind"] == "valid"], best=best,
                params=[p.detach().numpy() for p in param_leaves(state.params)],
                reports=reports, exports=[r["path"] for r in elog.records if r["kind"] == "export"])
