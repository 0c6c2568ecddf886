"""The port's twins of the JAX package's example drivers (``examples/``):
``cylinder_flow``, ``airfoil``, ``deforming_plate``, ``flag_simple``,
``ns_vortex`` and ``multihost_cylinder``, each runnable as ``python -m
mgn_tpu_torch.examples.<name>`` with a ``main(argv)``; ``flag_simple
--graph-parallel N`` runs the cloth family graph-parallel under torchrun,
and ``multihost_cylinder`` is the SPMD derivative path over a (data, graph)
mesh of torchrun's ranks."""
