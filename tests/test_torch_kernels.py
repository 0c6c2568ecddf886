"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a GPU (``requires_cuda``).  On a GPU machine without JAX run
them with ``python -m pytest --noconftest tests/test_torch_kernels.py -q``;
this module imports nothing of JAX.  ``chip_smoke.py`` holds the same
kernels against the same plain versions at full width.
"""

import numpy as np
import pytest
import torch

from mgn_tpu_torch.core.graph import build_template
from mgn_tpu_torch.data.synthetic import make_channel_mesh
from mgn_tpu_torch.models.mgn import MGNConfig, init_mgn
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from tests.torch_support import csr_case, cuda_device  # noqa: F401  (fixture)

pytestmark = [pytest.mark.requires_cuda, pytest.mark.usefixtures("cuda_device")]

L = 128


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(100, 128, 700, 768, 128, None),
                                  (5, 256, 17, 512, 8, None),
                                  (200, 256, 1200, 1536, 260, (37, 300))])
def test_csr_segment_sum_kernel(dtype, case):
    data, recv, row = csr_case(np.random.default_rng(0), *case)
    d = torch.from_numpy(data).cuda().to(dtype)
    r, ro = torch.from_numpy(recv).cuda(), torch.from_numpy(row).cuda()
    before = csr_segment_sum.launches
    out = csr_segment_sum(d, r, ro, case[1])
    assert csr_segment_sum.launches == before + 1
    ref = csr_segment_sum_plain(d, r, ro, case[1])
    deg = torch.diff(ro).float()[:, None]
    bound = 2 * torch.clamp(deg - 1, min=0) * 2.0 ** -24 * csr_segment_sum_plain(
        d.abs(), r, ro, case[1])
    assert ((out - ref).abs() <= bound).all()
    assert not out[torch.diff(ro) == 0].any()


def test_csr_segment_sum_kernel_gradient_is_gather():
    data, recv, row = csr_case(np.random.default_rng(1), 100, 128, 700, 768, 8)
    d = torch.from_numpy(data).cuda().requires_grad_(True)
    r = torch.from_numpy(recv).cuda()
    out = csr_segment_sum(d, r, torch.from_numpy(row).cuda(), 128)
    (out ** 2).sum().backward()
    torch.testing.assert_close(d.grad, 2 * out.detach()[r.long()])


def test_kernels_reject_what_they_do_not_take():
    d = torch.zeros(768, 6, device="cuda")
    ro = torch.zeros(129, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # F not a multiple of 4
        csr_segment_sum(d, torch.zeros(768, dtype=torch.int32, device="cuda"), ro, 128)
    with pytest.raises(TypeError):
        csr_segment_sum(d.half(), torch.zeros(768, dtype=torch.int32, device="cuda"), ro, 128)
    t, proc, v0, e0, ev = _graph_and_params(torch.float32, latent=48)
    with pytest.raises(ValueError):  # a width the kernels are not built for
        F.edge_round(e0, v0, t.senders, t.receivers, ev, F.round_params(proc["edge_mlp"], 0))


def _graph_and_params(dtype, mps=2, latent=L, hidden=2):
    pos, cells, nt = make_channel_mesh(300, seed=0)
    t = build_template(pos, nt, cells=cells).to("cuda")
    proc = init_mgn(MGNConfig(9, 3, 2, latent, hidden, mps), torch.Generator().manual_seed(0),
                    device="cuda")["processor"]
    g = torch.Generator(device="cuda").manual_seed(1)
    ev = t.edge_mask.to(dtype)[:, None].contiguous()
    v0 = torch.randn((t.num_nodes, latent), generator=g, device="cuda").to(dtype)
    e0 = (torch.randn((t.num_edges, latent), generator=g, device="cuda").to(dtype)
          * ev).contiguous()
    return t, proc, v0, e0, ev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_edge_and_node_round_kernels(dtype, latent, hidden):
    t, proc, v0, e0, ev = _graph_and_params(dtype, latent=latent, hidden=hidden)
    em = F.round_params(F.cast_mlp(proc["edge_mlp"], dtype), 0)
    nm = F.round_params(F.cast_mlp(proc["node_mlp"], dtype), 0)
    e = e0.clone()
    msg = F.edge_round(e, v0, t.senders, t.receivers, ev, em)
    e_ref, msg_ref = F.edge_round_plain(e0, v0, t.senders, t.receivers, ev, em)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0.02, atol=0.05)
    torch.testing.assert_close(msg.float(), msg_ref.float(), **tol)
    torch.testing.assert_close(e.float(), e_ref.float(), **tol)
    assert not msg[~t.edge_mask].any()
    agg = csr_segment_sum_plain(msg_ref, t.receivers, t.row_offsets, t.num_nodes)
    v = v0.clone()
    F.node_round(v, agg, nm)
    torch.testing.assert_close(v.float(), F.node_round_plain(v0, agg, nm).float(), **tol)


def test_fused_process_kernels_match_plain():
    t, proc, v0, e0, ev = _graph_and_params(torch.float32, mps=3)
    counts = (F.edge_round.launches, csr_segment_sum.launches, F.node_round.launches)
    with torch.no_grad():
        out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3)
    assert (F.edge_round.launches, csr_segment_sum.launches, F.node_round.launches) == \
        tuple(c + 3 for c in counts)
    ref = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, 3, torch.float32,
                                 t.num_nodes)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_fused_process_refuses_gradients():
    t, proc, v0, e0, ev = _graph_and_params(torch.float32)
    v0.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 2)
