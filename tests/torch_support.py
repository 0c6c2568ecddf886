"""Shared helpers of the ``test_torch_*`` files (the PyTorch port against the
JAX package).  Not a test module itself."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device; skips the test when there is none.  Kernel tests use
    it together with the ``requires_cuda`` marker."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda")


def local_graph(rng, n, e, spread=30):
    """Receiver-sorted random edges whose senders lie near their receivers
    (narrow bands, so the JAX fused kernel gets a banding plan)."""
    receivers = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)
    senders = np.clip(receivers + rng.integers(-spread, spread, e),
                      0, n - 1).astype(np.int32)
    return senders, receivers


def csr_case(rng, n_real, n_pad, e_real, e_pad, f, hub=None):
    """Receiver-sorted edge data padded with dead edges on node n_pad-1, as
    ``build_template`` lays them out.  ``hub``: (node, degree) adds one
    high-degree receiver."""
    recv = rng.integers(0, n_real, size=(e_real,))
    if hub is not None:
        recv[: hub[1]] = hub[0]
    recv = np.sort(recv).astype(np.int32)
    recv_p = np.concatenate([recv, np.full((e_pad - e_real,), n_pad - 1, np.int32)])
    counts = np.bincount(recv, minlength=n_real)
    row = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    row_p = np.concatenate([row, np.full((n_pad - n_real,), e_real, np.int32)])
    row_p[-1] = e_pad
    data = rng.normal(size=(e_pad, f)).astype(np.float32)
    return data, recv_p, row_p
