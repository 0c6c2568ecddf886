"""Command-line interface of the port: python -m mgn_tpu_torch <command> ...

The commands, options and defaults of ``python -m mgn_tpu``, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path):

    python -m mgn_tpu_torch train <ds_path> <cp_path> [options]
    python -m mgn_tpu_torch eval  <ds_path> <cp_path> <out_path> [options]
    python -m mgn_tpu_torch export <ds_path> <cp_path> <out_file> [options]
    python -m mgn_tpu_torch synth <ds_path> [--family cylinder|ns|airfoil|flag|plate]
    python -m mgn_tpu_torch convert <to-tfrecord|to-h5|inspect|stats> <dir> [<dst_dir>]

``synth`` writes TFRecord datasets (meta.json and train/valid/test.tfrecord),
which every installation reads; it writes no HDF5, which needs ``h5py``.
``--family ns`` runs the incompressible Navier-Stokes generator
(``mgn_tpu_torch.data.ns``, minutes of CPU at the default size).
``eval`` exports ``trajectories.h5`` where ``h5py`` is installed, else the
same arrays as ``trajectories.npz``.  ``convert`` is
``python -m mgn_tpu_torch.data.convert`` (``to-h5`` needs ``h5py``).
``export`` writes the artefact of ``mgn_tpu_torch.serve.export_simulator``
for one trajectory's mesh (``--trajectory``) to ``out_file``, exported on
``--device``; ``mgn_tpu_torch.serve.load_simulator`` runs it.  Every
``--solver`` exports, ``tsit5_adaptive`` with its step controller on the
device.  With ``--graph-parallel N`` under torchrun every rank exports its
part (``export_sharded_simulator``, the partition options of ``train``)
and rank 0 writes the file, which ``load_sharded_simulator`` runs on N
ranks:

    torchrun --nproc-per-node N -m mgn_tpu_torch export <ds_path> <cp_path> \
        <out_file> --graph-parallel N [--halo-rounds K] [--telescope-stages S] \
        [--dist-backend nccl|gloo]

``train`` and ``eval`` with ``--graph-parallel N`` shard each mesh over N
ranks, one process each, launched by torchrun (``--batchsize B`` trains B
trajectories a step over B x N ranks; every ``--strategy``, and the cloth
family):

    torchrun --nproc-per-node N -m mgn_tpu_torch train <ds_path> <cp_path> \
        --graph-parallel N [--halo-rounds K] [--telescope-stages S] \
        [--strategy derivative|solver|shooting] [--dist-backend nccl|gloo]

``--dist-backend`` (default ``nccl``) initializes the process group from
torchrun's environment: NCCL where every rank has a GPU of its own, gloo on
the CPU (``--device cpu``) and where ranks share one card.
``bench-scaling`` runs a benchmark and waits for the port's own (refused,
naming ROADMAP.md A1).
"""

from __future__ import annotations

import argparse


def _add_common(p):
    p.add_argument("--mps", type=int, default=15)
    p.add_argument("--layer-size", type=int, default=128)
    p.add_argument("--hidden-layers", type=int, default=2)
    p.add_argument("--types-updated", type=int, nargs="+", default=[0, 5])
    p.add_argument("--types-noisy", type=int, nargs="+", default=[0])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the GPU's kernels, or the plain PyTorch path")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mgn_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("ds_path")
    t.add_argument("cp_path")
    t.add_argument("--noise", type=float, default=0.02)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--steps", type=int, default=10_000_000)
    t.add_argument("--checkpoint", type=int, default=10_000)
    t.add_argument("--norm-steps", type=int, default=1000)
    t.add_argument("--batchsize", type=int, default=1)
    t.add_argument("--graph-parallel", type=int, default=1,
                   help="shard each mesh over this many ranks (run under torchrun)")
    t.add_argument("--halo-rounds", type=int, default=None,
                   help="processor rounds per halo exchange under graph parallelism "
                        "(default: mps, one exchange a forward; 0: the classic per-round halo)")
    t.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="the process group's backend under --graph-parallel (gloo on the CPU "
                        "and for ranks sharing one card)")
    t.add_argument("--telescope-stages", type=int, default=None,
                   help="shrinking telescope stages per deep segment under "
                        "--graph-parallel (default: none)")
    t.add_argument("--strategy", default="derivative",
                   choices=["derivative", "solver", "shooting"])
    t.add_argument("--tstart", type=float, default=0.0)
    t.add_argument("--dt", type=float, default=0.01)
    t.add_argument("--tstop", type=float, default=1.0)
    t.add_argument("--interval-size", type=int, default=10)
    _add_common(t)

    e = sub.add_parser("eval")
    e.add_argument("ds_path")
    e.add_argument("cp_path")
    e.add_argument("out_path")
    e.add_argument("--solver", default="tsit5_adaptive")
    e.add_argument("--solver-dt", type=float, default=None)
    e.add_argument("--num-rollouts", type=int, default=10)
    e.add_argument("--mse-steps", type=int, nargs="+", default=[])
    e.add_argument("--graph-parallel", type=int, default=1,
                   help="partition each mesh over this many ranks (run under torchrun)")
    e.add_argument("--halo-rounds", type=int, default=None,
                   help="processor rounds per halo exchange (see train)")
    e.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="the process group's backend under --graph-parallel (see train)")
    e.add_argument("--telescope-stages", type=int, default=None,
                   help="shrinking telescope stages per deep segment (see train)")
    _add_common(e)

    x = sub.add_parser("export")
    x.add_argument("ds_path")
    x.add_argument("cp_path")
    x.add_argument("out_file")
    x.add_argument("--solver", default="euler")
    x.add_argument("--num-steps", type=int, default=None)
    x.add_argument("--trajectory", type=int, default=0)
    x.add_argument("--platforms", nargs="+", default=None)
    x.add_argument("--graph-parallel", type=int, default=1,
                   help="a sharded artefact over this many ranks (run under torchrun)")
    x.add_argument("--halo-rounds", type=int, default=None,
                   help="processor rounds per halo exchange (see train)")
    x.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="the process group's backend under --graph-parallel (see train)")
    x.add_argument("--telescope-stages", type=int, default=None,
                   help="shrinking telescope stages per deep segment (see train)")
    _add_common(x)

    s = sub.add_parser("synth")
    s.add_argument("ds_path")
    s.add_argument("--family", default="cylinder",
                   choices=["cylinder", "ns", "airfoil", "flag", "plate"])
    s.add_argument("--num-nodes", type=int, default=1900)
    s.add_argument("--tl", type=int, default=100)
    s.add_argument("--n-train", type=int, default=8)
    s.add_argument("--n-valid", type=int, default=2)
    s.add_argument("--n-test", type=int, default=2)

    c = sub.add_parser("convert")
    c.add_argument("rest", nargs=argparse.REMAINDER)

    b = sub.add_parser("bench-scaling")
    b.add_argument("rest", nargs=argparse.REMAINDER)
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    if args.cmd == "synth":
        from mgn_tpu_torch.data import synthetic as S

        if args.family == "cylinder":
            S.write_synthetic_tfrecord_dataset(args.ds_path, num_nodes=args.num_nodes,
                                               tl=args.tl, n_train=args.n_train,
                                               n_valid=args.n_valid, n_test=args.n_test)
        elif args.family == "ns":
            # incompressible NS vortex shedding (offline projection solver)
            from mgn_tpu_torch.data.ns import write_ns_tfrecord_dataset

            write_ns_tfrecord_dataset(args.ds_path, num_nodes=args.num_nodes, tl=args.tl,
                                      n_train=args.n_train, n_valid=args.n_valid,
                                      n_test=args.n_test)
        elif args.family == "airfoil":
            S.write_airfoil_tfrecord_dataset(args.ds_path, num_nodes=args.num_nodes,
                                             tl=args.tl, n_train=args.n_train,
                                             n_valid=args.n_valid, n_test=args.n_test)
        elif args.family == "flag":
            S.write_flag_tfrecord_dataset(args.ds_path, tl=args.tl, n_train=args.n_train,
                                          n_valid=args.n_valid, n_test=args.n_test)
        else:
            S.write_plate_tfrecord_dataset(args.ds_path, tl=args.tl, n_train=args.n_train,
                                           n_valid=args.n_valid, n_test=args.n_test)
        print(f"wrote {args.family} dataset to {args.ds_path}")
        return
    if args.cmd == "convert":
        from mgn_tpu_torch.data.convert import main as convert_main

        convert_main(args.rest)
        return
    if args.cmd == "bench-scaling":
        raise NotImplementedError("bench-scaling (graph-parallel scaling sweeps) runs a "
                                  "benchmark, which waits for the port's own (ROADMAP.md, A1)")
    if args.cmd == "export":
        from mgn_tpu_torch.data.pipeline import load_dataset
        from mgn_tpu_torch.serve import export_sharded_simulator, export_simulator

        tr = load_dataset(args.ds_path, is_training=False).trajectory(args.trajectory)
        num_steps = args.num_steps or len(tr.times)
        model = dict(mps=args.mps, layer_size=args.layer_size,
                     hidden_layers=args.hidden_layers, types_updated=tuple(args.types_updated),
                     types_noisy=tuple(args.types_noisy), seed=args.seed,
                     compute_dtype=args.compute_dtype)
        mesh = dict(cells=tr.cells, edges=tr.edges, solver=args.solver,
                    platforms=args.platforms, device=args.device)
        writer = True
        if args.graph_parallel > 1:
            from mgn_tpu_torch.parallel.mesh import initialize_multihost, is_writer

            initialize_multihost(args.dist_backend)  # from torchrun's environment
            blob = export_sharded_simulator(
                args.ds_path, args.cp_path, tr.mesh_pos, tr.node_type, num_steps=num_steps,
                graph_parallel=args.graph_parallel, halo_rounds=args.halo_rounds,
                telescope_stages=args.telescope_stages, **mesh, **model)
            writer = is_writer()
        else:
            blob = export_simulator(args.ds_path, args.cp_path, tr.mesh_pos, tr.node_type,
                                    num_steps=num_steps, **mesh, **model)
        if writer:
            with open(args.out_file, "wb") as fh:
                fh.write(blob)
            print(f"wrote {len(blob)} bytes to {args.out_file} "
                  f"(num_steps={num_steps}, solver={args.solver})")
        return

    import torch

    from mgn_tpu_torch.api import eval_network, train_network
    from mgn_tpu_torch.train.strategies import (DerivativeTraining, MultipleShooting,
                                                SolverTraining)
    from mgn_tpu_torch.utils.metrics import MetricsLogger

    common = dict(mps=args.mps, layer_size=args.layer_size, hidden_layers=args.hidden_layers,
                  types_updated=tuple(args.types_updated),
                  types_noisy=tuple(args.types_noisy), seed=args.seed,
                  compute_dtype=args.compute_dtype, graph_parallel=args.graph_parallel,
                  halo_rounds=args.halo_rounds, telescope_stages=args.telescope_stages,
                  device=args.device)
    if args.graph_parallel > 1:
        from mgn_tpu_torch.parallel.mesh import initialize_multihost

        initialize_multihost(args.dist_backend)  # from torchrun's environment
    log = MetricsLogger()

    if args.cmd == "train":
        strategy = {
            "derivative": DerivativeTraining(),
            "solver": SolverTraining(args.tstart, args.dt, args.tstop),
            "shooting": MultipleShooting(args.tstart, args.dt, args.tstop,
                                         interval_size=args.interval_size),
        }[args.strategy]
        lr = args.lr
        train_network(args.noise, lambda ps: torch.optim.Adam(ps, lr=lr), args.ds_path,
                      args.cp_path, training_strategy=strategy, steps=args.steps,
                      checkpoint=args.checkpoint, norm_steps=args.norm_steps,
                      batchsize=args.batchsize, metrics=log, **common)
    else:
        eval_network(args.ds_path, args.cp_path, args.out_path, solver=args.solver,
                     dt=args.solver_dt, num_rollouts=args.num_rollouts,
                     mse_steps=tuple(args.mse_steps), metrics=log, **common)


if __name__ == "__main__":
    main()
