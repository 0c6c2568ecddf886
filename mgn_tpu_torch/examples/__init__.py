"""The port's twins of the JAX package's example drivers (``examples/``),
runnable as ``python -m mgn_tpu_torch.examples.<name>``."""
