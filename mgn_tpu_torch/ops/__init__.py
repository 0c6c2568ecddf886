"""The port's kernels and their plain versions.  Importing the package
registers the serving kernels as PyTorch operators
(:mod:`mgn_tpu_torch.ops.library`)."""

from mgn_tpu_torch.ops import library  # noqa: F401  (registers torch.ops.mgn_tpu_torch)
