"""The port's twins of the JAX package's example drivers (``examples/``):
``cylinder_flow``, ``airfoil``, ``deforming_plate``, ``flag_simple`` and
``ns_vortex``, each runnable as ``python -m mgn_tpu_torch.examples.<name>``
with a ``main(argv)``; ``flag_simple --graph-parallel N`` runs the cloth
family graph-parallel under torchrun.  ``multihost_cylinder``'s twin is not
ported yet (ROADMAP.md, A7b); ``python -m mgn_tpu_torch train
--graph-parallel N`` under torchrun runs its path."""
