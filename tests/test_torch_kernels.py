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


def _close(out, ref, dtype, what=""):
    """One backward round against its plain version.  f32: at least 99.9 %
    of the entries within 1e-4 x (|ref| + max(1, max |ref|)) and relative L2
    <= 1e-3 (the kernels and the plain ops sum in other orders, and where a
    ReLU's pre-activation lies within rounding of 0 the two can take
    different sides, moving that row by O(1)).  bf16: relative L2 within
    2e-2 (an order difference flips a bf16 rounding now and then)."""
    out, ref = out.float(), ref.float()
    rel = float((out - ref).norm()) / max(float(ref.norm()), 1e-30)
    if dtype == torch.float32:
        scale = max(1.0, float(ref.abs().max()))
        share = float(((out - ref).abs() > 1e-4 * (ref.abs() + scale)).float().mean())
        assert share <= 1e-3 and rel <= 1e-3, (what, share, rel)
    else:
        assert float((out - ref).norm()) <= 2e-2 * float(ref.norm()) + 1e-6, (what, rel)


def _grad_close(out, ref, dtype, what):
    """Whole-processor gradients.  f32: at most 1 % of the entries outside
    rtol 5e-4 and atol 5e-4 x max(1, max |ref|), and relative L2 <= 2e-3.
    Where a ReLU's pre-activation lies within rounding of 0, two f32
    summation orders (the kernels', cuBLAS's) can take different sides,
    which moves that row's gradient by O(1), and each earlier round spreads
    it to the neighbouring rows; f32 against f64 autograd shows the same on
    the CPU.  bf16: relative L2 <= 5e-2 (the plain path's autograd rounds
    weight gradients to bf16 and sums scatter cotangents in bf16)."""
    out, ref = out.float(), ref.float()
    rel = float((out - ref).norm()) / max(float(ref.norm()), 1e-30)
    if dtype == torch.float32:
        bad = (out - ref).abs() > 5e-4 * (ref.abs() + max(1.0, float(ref.abs().max())))
        assert float(bad.float().mean()) <= 1e-2 and rel <= 2e-3, (what, rel)
    else:
        assert rel <= 5e-2, (what, rel)


def _saved_close(saved, ref, dtype, what):
    for i, (a, b) in enumerate(zip(saved.dh, ref.dh)):
        _close(a, b, dtype, f"{what} dh[{i}]")
    for i, (a, b) in enumerate(zip(saved.post, ref.post)):
        _close(a, b, dtype, f"{what} post[{i}]")
    _close(saved.ln, ref.ln, dtype, f"{what} ln")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_edge_and_node_round_bwd_kernels(dtype, latent, hidden):
    t, proc, v0, e0, ev = _graph_and_params(dtype, latent=latent, hidden=hidden)
    em = F.round_params(F.cast_mlp(proc["edge_mlp"], dtype), 1)
    nm = F.round_params(F.cast_mlp(proc["node_mlp"], dtype), 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    agg = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    dv0 = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    counts = (F.node_round_bwd.launches, F.edge_round_bwd.launches)
    dv = dv0.clone()
    dagg, saved_n = F.node_round_bwd(dv, v0, agg, nm)
    ref_dv, ref_dagg, ref_n = F.node_round_bwd_plain(dv0, v0, agg, nm)
    _close(dv, ref_dv, dtype, "dv")
    _close(dagg, ref_dagg, dtype, "dagg")
    _saved_close(saved_n, ref_n, dtype, "node")
    de0 = torch.randn(e0.shape, generator=g, device="cuda").to(dtype)
    de = de0.clone()
    dvs, dvr, saved_e = F.edge_round_bwd(de, ref_dagg, e0, v0, t.senders, t.receivers, ev, em)
    ref = F.edge_round_bwd_plain(de0, ref_dagg, e0, v0, t.senders, t.receivers, ev, em)
    for name, a, b in (("de", de, ref[0]), ("dvs", dvs, ref[1]), ("dvr", dvr, ref[2])):
        _close(a, b, dtype, name)
    _saved_close(saved_e, ref[3], dtype, "edge")
    assert not dvs[~t.edge_mask].any() and not dvr[~t.edge_mask].any()
    assert torch.equal(de[~t.edge_mask], de0[~t.edge_mask])  # masked: no de_part
    assert (F.node_round_bwd.launches, F.edge_round_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [32, 64, 128, 256])
def test_wgrad_kernel(dtype, latent):
    t, *_ = _graph_and_params(dtype, latent=latent)
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = t.num_edges
    dh = torch.randn((rows, latent), generator=g, device="cuda").to(dtype)
    x = torch.randn((rows, latent), generator=g, device="cuda").to(dtype)
    v = torch.randn((t.num_nodes, latent), generator=g, device="cuda").to(dtype)
    part = torch.randn((rows // 4, 2 * latent), generator=g, device="cuda")
    before = F.wgrad.launches
    # one grouped call: a plain product with its bias, a gathered one, column sums
    dw = torch.empty((latent, latent), device="cuda")
    db = torch.empty((latent,), device="cuda")
    dws = torch.empty((latent, latent), device="cuda")
    cols = [torch.empty((latent,), device="cuda") for _ in range(2)]
    F.wgrad_group([F.WgradProduct(dh, [(x, None)], dw, [db]),
                   F.WgradProduct(dh, [(v, t.senders)], dws),
                   F.WgradProduct(part, (), None, cols)])
    for got, (xs, idx) in ((dw, (x, None)), (dws, (v, t.senders))):
        _close(got, F.wgrad_plain(dh, xs, idx)[0], torch.float32, "dw")
    _close(db, F.wgrad_plain(dh)[1], torch.float32, "db")
    _close(torch.cat(cols), F.wgrad_plain(part)[1], torch.float32, "column sums")
    dw2 = torch.empty((latent, latent), device="cuda")
    F.wgrad(dh, x, dw=dw2)
    F.wgrad(dh, x, dw=dw)
    assert torch.equal(dw, dw2)  # a fixed summation order: the same bits every run
    assert F.wgrad.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [32, 64, 128, 256])
def test_wgrad_one_mlp_round(dtype, latent):
    """One grouped K6 call per MLP round (edge: 3 parts, two gathered; node:
    2 parts) against mlp_wgrads through the plain versions on the CPU."""
    t, *_ = _graph_and_params(dtype, latent=latent)
    g = torch.Generator(device="cuda").manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
    hidden = 2
    v = rnd(t.num_nodes, latent)
    for rows, inputs, group_rows in (
            (t.num_edges, [(rnd(t.num_edges, latent), None), (v, t.senders),
                           (v, t.receivers)], F._EDGE_BWD_ROWS),
            (t.num_nodes, [(v, None), (rnd(t.num_nodes, latent), None)], F._NODE_BWD_ROWS)):
        saved = F.MlpSaved([rnd(rows, latent) for _ in range(hidden + 1)],
                           [torch.relu(rnd(rows, latent)) for _ in range(hidden)],
                           torch.randn((-(-rows // group_rows), 2 * latent), generator=g,
                                       device="cuda"))
        parts = len(inputs)
        grads = {"w": [torch.zeros((1, parts * latent, latent), device="cuda")]
                 + [torch.zeros((1, latent, latent), device="cuda") for _ in range(hidden)],
                 "b": [torch.zeros((1, latent), device="cuda") for _ in range(hidden + 1)],
                 "ln_scale": torch.zeros((1, latent), device="cuda"),
                 "ln_bias": torch.zeros((1, latent), device="cuda")}
        cpu = lambda tree: ({k: cpu(x) for k, x in tree.items()} if isinstance(tree, dict) else
                            [cpu(x) for x in tree] if isinstance(tree, list) else tree.cpu())
        ref = cpu(grads)
        before = F.wgrad.launches
        F.mlp_wgrads(saved, inputs, grads, 0)
        assert F.wgrad.launches == before + 1
        F.mlp_wgrads(F.MlpSaved(cpu(saved.dh), cpu(saved.post), saved.ln.cpu()),
                     [(x.cpu(), None if i is None else i.cpu()) for x, i in inputs], ref, 0)
        for name in ("w", "b"):
            for i, (a, b) in enumerate(zip(grads[name], ref[name])):
                _close(a, b.cuda(), torch.float32, f"{name}[{i}]")
        for name in ("ln_scale", "ln_bias"):
            _close(grads[name], ref[name].cuda(), torch.float32, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_segment_sum_kernel_sender_perm(dtype):
    t, *_ = _graph_and_params(dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    data = torch.randn((t.num_edges, L), generator=g, device="cuda").to(dtype)
    before = (csr_segment_sum.launches, csr_segment_sum.perm_launches)
    out = csr_segment_sum(data, t.senders, t.sender_offsets, t.num_nodes, perm=t.sender_perm)
    assert (csr_segment_sum.launches, csr_segment_sum.perm_launches) == \
        (before[0], before[1] + 1)
    ref = torch.zeros((t.num_nodes, L), device="cuda").index_add_(
        0, t.senders.long(), data.float())
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    plain = csr_segment_sum_plain(data, t.senders, t.sender_offsets, t.num_nodes,
                                  perm=t.sender_perm)
    torch.testing.assert_close(plain, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_process_gradients_use_the_kernels(dtype):
    """Gradients of fused_process on the card (K5/K6/K4/K1 per round) against
    torch.autograd of process_rounds_plain, for every leaf, v0 and e0."""
    t, proc, v0, e0, ev = _graph_and_params(dtype, mps=3)
    leaves = F._flatten_proc(proc)
    for x in (v0, e0, *leaves):
        x.requires_grad_(True)
    counts = (F.node_round_bwd.launches, F.edge_round_bwd.launches, F.wgrad.launches)
    out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3,
                          sender_perm=t.sender_perm, sender_offsets=t.sender_offsets)
    got = torch.autograd.grad((out.float() ** 2).sum(), [v0, e0, *leaves])
    assert (F.node_round_bwd.launches, F.edge_round_bwd.launches) == \
        (counts[0] + 3, counts[1] + 3)
    assert F.wgrad.launches > counts[2]
    ref_out = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, 3, dtype,
                                     t.num_nodes)
    ref = torch.autograd.grad((ref_out.float() ** 2).sum(), [v0, e0, *leaves])
    for i, (a, b) in enumerate(zip(got, ref)):
        _grad_close(a, b, dtype, f"grad {i}")
    assert not got[1][~t.edge_mask].any()  # dead edges: no gradient
