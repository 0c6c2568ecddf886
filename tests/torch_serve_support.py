"""The ranks of tests/test_torch_serve_sharded.py and
tests/test_torch_multihost_example.py: module-level functions that
:func:`mgn_tpu_torch.parallel.mesh.spawn` runs in processes of their own
(gloo on the CPU).  Imports no JAX: each rank imports this module afresh.
Not a test module itself."""

import os

import numpy as np
import torch
import torch.distributed as dist

SMALL = dict(mps=4, layer_size=16, hidden_layers=1)
# the graph-parallel plans: Args fields of each
PLANS = {"deep": {}, "classic": {"halo_rounds": 0}, "telescoped": {"telescope_stages": 2}}
SOLVERS = ("euler", "tsit5_adaptive")
# the adaptive Tsit5's tolerances: at the default rtol 1e-4 two step sequences
# that part at one ulp of the right-hand side end up to 8e-4 apart on the test
# case (the JAX package's own sharded and single-device rollouts do), beyond
# the sharded artefacts' comparison; at 1e-6 both sit within 4e-5 of each other
TOLERANCES = {"euler": {}, "tsit5_adaptive": dict(rtol=1e-6, atol=1e-8)}


def cell_args(plan, solver):
    """The Args fields of one (plan, solver) cell."""
    return {**PLANS[plan], **TOLERANCES[solver]}


def _counting_module():
    """Count ``ExportedProgram.module()`` calls (the loader's module builds)."""
    from torch.export import ExportedProgram

    build, calls = ExportedProgram.module, [0]

    def counted(self, *a, **k):
        calls[0] += 1
        return build(self, *a, **k)

    ExportedProgram.module = counted
    return calls


def serve_rank(rank, c):
    """Mesh (1, 2): the sharded artefact of every plan and solver exported,
    loaded and run twice, beside ``simulate(graph_parallel=2)``; the
    command line's ``export --graph-parallel 2``; the loader's refusal of a
    group of one rank."""
    import mgn_tpu_torch
    from mgn_tpu_torch.__main__ import main
    from mgn_tpu_torch.serve import export_sharded_simulator, load_sharded_simulator

    torch.set_num_threads(1)
    builds = _counting_module()
    mesh = dict(mesh_pos=c["pos"], node_type=c["nt"], cells=c["cells"])
    out = {}
    for plan in PLANS:
        for solver in SOLVERS:
            kw = cell_args(plan, solver)
            blob = export_sharded_simulator(c["root"], c["cp"], num_steps=len(c["times"]),
                                            solver=solver, graph_parallel=2, device="cpu",
                                            **mesh, **SMALL, **kw)
            before = builds[0]
            sim = load_sharded_simulator(blob, device="cpu")
            pred = sim(c["times"], c["v0"])
            again = sim(c["times"], c["v0"])
            ref = mgn_tpu_torch.simulate(c["root"], c["cp"], initial_fields={"velocity": c["v0"]},
                                         times=c["times"], solver=solver, graph_parallel=2,
                                         device="cpu", **mesh, **SMALL, **kw)
            out[plan, solver] = dict(pred=pred, again=again, ref=ref, stats=sim.stats,
                                     builds=builds[0] - before, blob=blob)
    singles = [dist.new_group([0]), dist.new_group([1])]  # every rank makes both
    try:
        load_sharded_simulator(out["deep", "euler"]["blob"], device="cpu", group=singles[rank])
    except ValueError as e:
        out["refusal"] = str(e)
    path = os.path.join(c["root"], "cli.pt2")
    main(["export", c["root"], c["cp"], path, "--graph-parallel", "2", "--dist-backend", "gloo",
          "--device", "cpu", "--num-steps", str(len(c["times"])), "--mps", str(SMALL["mps"]),
          "--layer-size", str(SMALL["layer_size"]), "--hidden-layers",
          str(SMALL["hidden_layers"]), "--seed", "3"])
    dist.barrier()
    with open(path, "rb") as fh:
        out["cli"] = load_sharded_simulator(fh.read(), device="cpu")(c["times"], c["v0"])
    for r in out.values():
        if isinstance(r, dict):
            r.pop("blob")
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.detach().clone()


def multihost_rank(rank, ds, sizes, params):
    """The multihost example's ``main`` at mesh (1, 2) with its module
    constants set from ``sizes`` and, where given, ``params`` as its first
    parameters; returns each window's losses and the final parameters."""
    from mgn_tpu_torch.examples import multihost_cylinder as M
    from mgn_tpu_torch.train.common import param_leaves

    torch.set_num_threads(1)
    for k, v in sizes.items():
        setattr(M, k, v)
    if params is not None:  # a copy: spawn hands the ranks the caller's storage
        M.initial_params = lambda cfg, device: _copy(params)
    state, history = M.main([ds, "2", "--dist-backend", "gloo", "--device", "cpu"])
    return dict(losses=np.stack(history),
                params=[p.detach().numpy().copy() for p in param_leaves(state.params)])
