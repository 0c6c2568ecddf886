"""Mesh (2, 2) on the CPU: four gloo ranks, two trajectories over the data
axis, each partitioned over two graph ranks — the port's SPMD derivative
step against mgn_tpu.parallel.spmd's, and the one-time normalizer merge."""

import jax
import numpy as np
import pytest

from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.parallel.mesh import spawn

from tests import torch_parallel_support as S
from tests.test_torch_parallel import _jax_cfg, _jax_step


@pytest.fixture(scope="module")
def case():
    pb = S.problem()
    jparams = jax_init_mgn(jax.random.PRNGKey(0), _jax_cfg())
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return dict(pb=pb, jparams=jparams, ranks=spawn(4, S.step_rank, (params, pb)))


def test_spmd_step_matches_jax_mesh_2x2(case):
    """Two noise-free steps, frames (0, 2) then (1, 3) of the two data
    coordinates: the losses and the updated parameters equal
    make_spmd_derivative_step's at mesh (2, 2) (rtol 1e-4), the same bits on
    every rank."""
    losses, params, _ = _jax_step(case, 2, [[0, 2], [1, 3]])
    ranks = case["ranks"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    for got, want in zip(ranks[0]["params"], params):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for a, b in zip(r["params"], ranks[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_cross_replica_sync_is_a_one_time_merge(case):
    """cross_replica_sync sums four ranks' separately accumulated Online
    state (3 rows of rank + 1 each): counts and sums add, the call count
    takes the largest."""
    for r in case["ranks"]:
        m = r["merged"]
        assert float(m["acc_count"]) == 1.0 and float(m["num_accumulations"]) == 12.0
        np.testing.assert_array_equal(m["acc_sum"], [30.0, 30.0])
        np.testing.assert_array_equal(m["acc_sum_sq"], [90.0, 90.0])
