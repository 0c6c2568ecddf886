"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a GPU (``requires_cuda``).  On a GPU machine without JAX run
them with ``python -m pytest --noconftest tests/test_torch_kernels.py -q``;
this module imports nothing of JAX.  ``chip_smoke.py`` holds the same
kernels against the same plain versions at full width.
"""

import numpy as np
import pytest
import torch

from mgn_tpu_torch.core.graph import build_template, build_world_edges
from mgn_tpu_torch.data.synthetic import make_channel_mesh, make_flag_mesh, make_flag_trajectory
from mgn_tpu_torch.models.mgn import MGNConfig, init_mgn
from mgn_tpu_torch.models.mgn_multi import (EdgeSet, MultiGraph, MultiMGNConfig,
                                            apply_mgn_multi, init_mgn_multi)
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_plain
from mgn_tpu_torch.ops.segment import csr_order, segment_sum
from mgn_tpu_torch.train.common import param_leaves
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
                                  (200, 256, 1200, 1536, 260, (37, 300)),
                                  # widths that are not a multiple of 4: the tail form
                                  (100, 128, 700, 768, 90, None),
                                  (200, 256, 1200, 1536, 7, (37, 300))])
def test_csr_segment_sum_kernel(dtype, case):
    data, recv, row = csr_case(np.random.default_rng(0), *case)
    d = torch.from_numpy(data).cuda().to(dtype)
    r, ro = torch.from_numpy(recv).cuda(), torch.from_numpy(row).cuda()
    before = csr_segment_sum.launches
    out = csr_segment_sum(d, r, ro, case[1])
    assert csr_segment_sum.launches == before + 1
    # the kernel sums in the plain version's fixed chunk order: its CPU bits
    assert torch.equal(out.cpu(), csr_segment_sum_plain(d.cpu(), r.cpu(), ro.cpu(), case[1]))
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
    with pytest.raises(ValueError):  # rows of no column
        csr_segment_sum(d[:, :0], torch.zeros(768, dtype=torch.int32, device="cuda"), ro, 128)
    with pytest.raises(TypeError):
        csr_segment_sum(d.half(), torch.zeros(768, dtype=torch.int32, device="cuda"), ro, 128)
    t, proc, v0, e0, ev = _graph_and_params(torch.float32, latent=48)
    pq = torch.zeros((2, t.num_nodes, 48), device="cuda")
    with pytest.raises(ValueError):  # a width the kernels are not built for
        F.edge_round(e0, pq[0], pq[1], t.senders, t.receivers, ev,
                     F.round_params(proc["edge_mlp"], 0), None)
    t, proc, v0, e0, ev = _graph_and_params(torch.float32)
    em_all = F.cast_mlp(proc["edge_mlp"], torch.float32)
    em = F.round_params(em_all, 0)
    pq = torch.zeros((2, t.num_nodes, L), device="cuda")
    with pytest.raises(ValueError):  # a kernel needs its weight stream
        F.edge_round(e0, pq[0], pq[1], t.senders, t.receivers, ev, em, None)
    with pytest.raises(ValueError):
        F.edge_project(v0, em, None)
    ws_e, _, ws_p = F.weight_streams(em_all)
    with pytest.raises(ValueError):  # K2 takes the forward part of a stream, nothing longer
        F.edge_round(e0, pq[0], pq[1], t.senders, t.receivers, ev, em,
                     F.weight_streams(em_all, adjoint=True)[0][0])
    with pytest.raises(ValueError):  # the projections are f32
        F.edge_round(e0, pq[0].to(torch.bfloat16), pq[1], t.senders, t.receivers, ev, em,
                     ws_e[0])
    with pytest.raises(ValueError):  # K7 reads the projection stream, not the edge stream
        F.edge_project(v0, em, ws_e[0])


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
    em_all, nm_all = F.cast_mlp(proc["edge_mlp"], dtype), F.cast_mlp(proc["node_mlp"], dtype)
    em, nm = F.round_params(em_all, 0), F.round_params(nm_all, 0)
    ws_e, ws_n, _ = (x[0] for x in F.weight_streams(em_all, nm_all))
    # K2's products, then K4's; K3's, then K5's
    ws_k4, ws_k5, _ = (x[0] for x in F.weight_streams(em_all, nm_all, adjoint=True))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0.02, atol=0.05)
    p, q = F.edge_project_plain(v0, em)  # K2's inputs: the plain projections
    # the whole graph, then row counts that are not a multiple of the tiles
    # (64 edges, 16 nodes), made by slicing
    for n_e, n_n in ((t.num_edges, t.num_nodes), (t.num_edges - 37, t.num_nodes - 9)):
        s, r, evs = t.senders[:n_e], t.receivers[:n_e], ev[:n_e]
        e = e0[:n_e].clone()
        msg = F.edge_round(e, p, q, s, r, evs, em, ws_e)
        e_ref, msg_ref = F.edge_round_plain(e0[:n_e], p, q, s, r, evs, em)
        torch.testing.assert_close(msg.float(), msg_ref.float(), **tol)
        torch.testing.assert_close(e.float(), e_ref.float(), **tol)
        assert not msg[~t.edge_mask[:n_e]].any()
        e2 = e0[:n_e].clone()
        assert torch.equal(F.edge_round(e2, p, q, s, r, evs, em, ws_e), msg)
        assert torch.equal(e2, e)
        e3 = e0[:n_e].clone()  # the forward part of the stream K4 reads too: the same bits
        assert torch.equal(F.edge_round(e3, p, q, s, r, evs, em, ws_k4[:ws_e.numel()]), msg)
        # the first n_e edges' CSR: the receiver-sorted offsets cut at n_e
        agg = csr_segment_sum_plain(msg_ref, r, t.row_offsets.clamp(max=n_e),
                                    t.num_nodes)[:n_n].contiguous()
        v = v0[:n_n].clone()
        F.node_round(v, agg, nm, ws_n)
        torch.testing.assert_close(v.float(), F.node_round_plain(v0[:n_n], agg, nm).float(),
                                   **tol)
        v2 = v0[:n_n].clone()
        F.node_round(v2, agg, nm, ws_n)
        assert torch.equal(v2, v)  # a second call with the same inputs: the same bits
        v3 = v0[:n_n].clone()  # the forward part of the stream K5 reads too: the same bits
        F.node_round(v3, agg, nm, ws_k5[:ws_n.numel()])
        assert torch.equal(v3, v)


# K7 against an f64 product of the same (compute-dtype) operands: the kernel
# and the plain version (cuBLAS f32) each sum L products in f32, within
# about L u sum|v w| of it; 1e-4 x max(1, max |P|) holds both with room.
def _project_close(got, v, w, what):
    ref = v.double() @ w.double()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got.double() - ref).abs().max()) <= 1e-4 * scale, what


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_edge_project_kernel(dtype, latent, hidden):
    """K7 against its plain version and an f64 product, at row counts that
    are and are not a multiple of its 64-row tile, below one tile and one
    row past it: f32 projections, the same bits from a second call, one
    launch a call."""
    t, proc, v0, *_ = _graph_and_params(dtype, latent=latent, hidden=hidden)
    em_all = F.cast_mlp(proc["edge_mlp"], dtype)
    em, ws_p = F.round_params(em_all, 1), F.weight_streams(em_all)[2][1]
    w0 = em["w"][0]
    for n in (t.num_nodes, t.num_nodes - 9, 5, 65):
        v = v0[:n].contiguous()
        before = F.edge_project.launches
        p, q = F.edge_project(v, em, ws_p)
        assert F.edge_project.launches == before + 1
        assert p.dtype == q.dtype == torch.float32 and p.shape == q.shape == (n, latent)
        ref = F.edge_project_plain(v, em)
        for got, want, rows in ((p, ref[0], w0[latent:2 * latent]),
                                (q, ref[1], w0[2 * latent:])):
            _project_close(got, v, rows, "kernel")
            _project_close(want, v, rows, "plain")
        again = F.edge_project(v, em, ws_p)
        assert torch.equal(again[0], p) and torch.equal(again[1], q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_round_kernel_reads_the_projections(dtype):
    """K2 on K7's projections against the plain edge stage on the same
    projections, and the control: Q zeroed changes every live message (the
    gathered rows are read)."""
    t, proc, v0, e0, ev = _graph_and_params(dtype)
    em_all = F.cast_mlp(proc["edge_mlp"], dtype)
    em = F.round_params(em_all, 0)
    ws_e, _, ws_p = F.weight_streams(em_all)
    p, q = F.edge_project(v0, em, ws_p[0])
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0.02, atol=0.05)
    msg = F.edge_round(e0.clone(), p, q, t.senders, t.receivers, ev, em, ws_e[0])
    ref = F.edge_round_plain(e0, p, q, t.senders, t.receivers, ev, em)[1]
    torch.testing.assert_close(msg.float(), ref.float(), **tol)
    zero_q = F.edge_round(e0.clone(), p, torch.zeros_like(q), t.senders, t.receivers, ev, em,
                          ws_e[0])
    live = t.edge_mask
    assert float((zero_q - ref).float()[live].norm()) > 0.1 * float(ref.float()[live].norm())


def test_backward_recomputes_the_forward_projections(monkeypatch):
    """The backward's K7 on each round's saved v gives the forward's P and Q
    bit for bit (K4's recompute then sees K2's first layer)."""
    t, proc, v0, e0, ev = _graph_and_params(torch.float32, mps=3)
    seen, launch = [], F._project_launch

    def record(v, wstream, p, q):
        launch(v, wstream, p, q)
        seen.append((p.clone(), q.clone()))

    monkeypatch.setattr(F, "_project_launch", record)
    leaves = F._flatten_proc(proc)
    for x in (v0, *leaves):
        x.requires_grad_(True)
    out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3,
                          sender_perm=t.sender_perm, sender_offsets=t.sender_offsets)
    torch.autograd.grad((out ** 2).sum(), [v0, *leaves])
    assert len(seen) == 6
    for r in range(3):  # the backward walks the rounds in reverse
        fwd, bwd = seen[r], seen[5 - r]
        assert torch.equal(fwd[0], bwd[0]) and torch.equal(fwd[1], bwd[1]), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_weight_streams_kernel(dtype, latent, hidden):
    """The weight-stream layout kernel gives its plain version's bits, for
    both MLPs in one launch and for each alone, in each form (serving, with
    the adjoint products, and with them in the defer_first form's extent),
    at 1, 3 and 15 rounds; one launch a call."""
    bits = lambda x: x.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    for mps in (1, 3, 15):
        _, proc, *_ = _graph_and_params(dtype, mps=mps, latent=latent, hidden=hidden)
        em = F.cast_mlp(proc["edge_mlp"], dtype)
        nm = F.cast_mlp(proc["node_mlp"], dtype)
        for adjoint, defer in ((False, False), (True, False), (True, True)):
            before = F.weight_streams.launches
            got = F.weight_streams(em, nm, adjoint, defer)
            assert F.weight_streams.launches == before + 1
            ref = F.weight_streams_plain(em, nm, adjoint, defer)
            assert len(got) == len(ref) == 3
            for a, b in zip(got, ref):
                assert torch.equal(bits(a), bits(b))
            alone = F.weight_streams(em=em, adjoint=adjoint, defer=defer)
            assert alone[1] is None
            assert torch.equal(bits(alone[0]), bits(ref[0]))
            assert torch.equal(bits(alone[2]), bits(ref[2]))
            alone = F.weight_streams(nm=nm, adjoint=adjoint, defer=defer)
            assert alone[0] is None and alone[2] is None
            assert torch.equal(bits(alone[1]), bits(ref[1]))


def _kernel_counts(fn, want: dict) -> dict:
    """Device kernels that torch.profiler saw during ``fn()``, by name
    (copies and fills left out).  The profiler on the card now and then
    drops an event (PERF.md), so ``fn`` is profiled up to three times:
    the first profile that shows each name fragment of ``want`` as many
    times as ``want`` says is returned, else the last."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {}
        for ev in prof.events():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not ev.name.startswith(("Memcpy", "Memset"))):
                counts[ev.name] = counts.get(ev.name, 0) + 1
        if all(sum(n for name, n in counts.items() if k in name) == m for k, m in want.items()):
            break
    return counts


FORWARD_KERNELS = {"edge_project_kernel": 3, "edge_round_kernel": 3,
                   "csr_segment_sum_kernel": 3, "node_round_kernel": 3, "weight_streams_kernel": 1}


def test_fused_process_kernels_match_plain():
    t, proc, v0, e0, ev = _graph_and_params(torch.float32, mps=3)
    counts = (F.edge_project.launches, F.edge_round.launches, csr_segment_sum.launches,
              F.node_round.launches, F.weight_streams.launches)
    with torch.no_grad():
        out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3)
    assert (F.edge_project.launches, F.edge_round.launches, csr_segment_sum.launches,
            F.node_round.launches, F.weight_streams.launches) == tuple(
                c + d for c, d in zip(counts, (3, 3, 3, 3, 1)))
    for preproject in (True, False):
        ref = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, 3,
                                     torch.float32, t.num_nodes, preproject=preproject)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    # the device kernels of one forward: K7, K2, K1 and K3 once per round and
    # one weight-stream launch for both MLPs, nothing else
    with torch.no_grad():
        seen = _kernel_counts(lambda: F.fused_process(proc, v0, e0, t.senders, t.receivers,
                                                      t.row_offsets, ev, 3), FORWARD_KERNELS)
    by = {k: sum(n for name, n in seen.items() if k in name) for k in FORWARD_KERNELS}
    assert by == FORWARD_KERNELS, seen
    assert sum(seen.values()) == 13, seen


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
    em_all, nm_all = (F.cast_mlp(proc[k], dtype) for k in ("edge_mlp", "node_mlp"))
    em, nm = F.round_params(em_all, 1), F.round_params(nm_all, 1)
    ws, ws_n, ws_p = (x[1] for x in F.weight_streams(em_all, nm_all, adjoint=True))
    g = torch.Generator(device="cuda").manual_seed(2)
    agg = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    dv0 = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    counts = (F.node_round_bwd.launches, F.edge_round_bwd.launches)
    dv = dv0.clone()
    dagg, saved_n = F.node_round_bwd(dv, v0, agg, nm, ws_n)
    ref_dv, ref_dagg, ref_n = F.node_round_bwd_plain(dv0, v0, agg, nm)
    _close(dv, ref_dv, dtype, "dv")
    _close(dagg, ref_dagg, dtype, "dagg")
    _saved_close(saved_n, ref_n, dtype, "node")
    de0 = torch.randn(e0.shape, generator=g, device="cuda").to(dtype)
    de = de0.clone()
    # the kernel's projections, as the backward makes them (K7's part of the adjoint row)
    p, q = F.edge_project(v0, em, ws_p[:F._stream_sizes(latent, dtype, 0, 0)[2]])
    dvs, dvr, saved_e = F.edge_round_bwd(de, ref_dagg, e0, p, q, t.senders, t.receivers, ev,
                                         em, ws)
    ref = F.edge_round_bwd_plain(de0, ref_dagg, e0, p, q, t.senders, t.receivers, ev, em)
    for name, a, b in (("de", de, ref[0]), ("dvs", dvs, ref[1]), ("dvr", dvr, ref[2])):
        _close(a, b, dtype, name)
    _saved_close(saved_e, ref[3], dtype, "edge")
    assert not dvs[~t.edge_mask].any() and not dvr[~t.edge_mask].any()
    assert torch.equal(de[~t.edge_mask], de0[~t.edge_mask])  # masked: no de_part
    assert (F.node_round_bwd.launches, F.edge_round_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_edge_round_bwd_kernel_defer_form(dtype, latent, hidden):
    """K4's defer_first form (no dvs/dvr; its ring stops at W0's e block)
    against its plain version, and the same bits in de and in every MlpSaved
    output as the three-part form's kernel: the form only drops the last two
    products."""
    t, proc, v0, e0, ev = _graph_and_params(dtype, latent=latent, hidden=hidden)
    em_all, nm_all = (F.cast_mlp(proc[k], dtype) for k in ("edge_mlp", "node_mlp"))
    em = F.round_params(em_all, 1)
    ws, _, ws_p = (x[1] for x in F.weight_streams(em_all, nm_all, adjoint=True))
    ws_defer = F.weight_streams(em_all, adjoint=True, defer=True)[0][1]
    g = torch.Generator(device="cuda").manual_seed(12)
    dagg = torch.randn(v0.shape, generator=g, device="cuda")
    de0 = torch.randn(e0.shape, generator=g, device="cuda").to(dtype)
    size_p = F._stream_sizes(latent, dtype, 0, 0)[2]
    p, q = F.edge_project(v0, em, ws_p[:size_p])
    args = (dagg, e0, p, q, t.senders, t.receivers, ev, em, ws)
    before = (F.edge_round_bwd.launches, F.edge_round_bwd.defer_launches)
    de = de0.clone()
    saved = F.edge_round_bwd(de, *args[:-1], ws_defer, defer=True)
    assert (F.edge_round_bwd.launches, F.edge_round_bwd.defer_launches) == \
        (before[0], before[1] + 1)
    ref_de, ref = F.edge_round_bwd_plain(de0, *args[:-1], defer=True)
    _close(de, ref_de, dtype, "de")
    _saved_close(saved, ref, dtype, "edge defer")
    de3 = de0.clone()
    *_, saved3 = F.edge_round_bwd(de3, *args)
    assert torch.equal(de, de3)
    for a, b in zip([*saved.dh, *saved.post, saved.ln], [*saved3.dh, *saved3.post, saved3.ln]):
        assert torch.equal(a, b)
    de2 = de0.clone()
    saved2 = F.edge_round_bwd(de2, *args[:-1], ws_defer, defer=True)  # again: the same bits
    assert torch.equal(de2, de) and torch.equal(saved2.dh[0], saved.dh[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (128, 2), (256, 3)])
def test_edge_round_bwd_defer_form_on_the_shortened_stream(dtype, latent, hidden):
    """K4's defer form on the defer_first form's shortened stream gives the
    bits it gives on the full adjoint stream's row cut to the same length
    (the two are the same bytes; the shortened row lies in a tensor of its
    own size, so nothing follows it in the round's row), every round of a
    3-round stream; the wrapper refuses a full row in the defer form."""
    t, proc, v0, e0, ev = _graph_and_params(dtype, mps=3, latent=latent, hidden=hidden)
    em_all = F.cast_mlp(proc["edge_mlp"], dtype)
    full, _, ws_p = F.weight_streams(em_all, adjoint=True)
    cut = F.weight_streams(em_all, adjoint=True, defer=True)[0]
    size = F._stream_sizes(latent, dtype, hidden + 1, 0, True, True)[0]
    assert cut.shape == (3, size) and full.shape[1] > size
    g = torch.Generator(device="cuda").manual_seed(14)
    dagg = torch.randn(v0.shape, generator=g, device="cuda")
    de0 = torch.randn(e0.shape, generator=g, device="cuda").to(dtype)
    size_p = F._stream_sizes(latent, dtype, 0, 0)[2]
    for r in range(3):
        em = F.round_params(em_all, r)
        p, q = F.edge_project(v0, em, ws_p[r][:size_p])
        args = (dagg, e0, p, q, t.senders, t.receivers, ev, em)
        outs = []
        for ws in (cut[r].clone(), full[r][:size]):
            de = de0.clone()
            saved = F.edge_round_bwd(de, *args, ws, defer=True)
            outs.append([de, *saved.dh, *saved.post, saved.ln])
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        with pytest.raises(ValueError, match="wstream"):
            F.edge_round_bwd(de0.clone(), *args, full[r], defer=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_first_layer_adjoint_kernel(dtype, latent, hidden):
    """K8 against its plain version on the dh0 sums the backward gives it
    (K1 by receiver, K1-perm by sender), every latent width, at the mesh's
    row count, 9 rows fewer (not a multiple of the 32-row tile) and below
    one tile; two calls the same bits; G is f32 in both dtypes (bf16: never
    rounded to bf16)."""
    t, proc, v0, e0, ev = _graph_and_params(dtype, latent=latent, hidden=hidden)
    em_all = F.cast_mlp(proc["edge_mlp"], dtype)
    em = F.round_params(em_all, 1)
    ws_p = F.weight_streams(em=em_all, adjoint=True)[2][1]
    size_p = F._stream_sizes(latent, dtype, 0, 0)[2]
    g = torch.Generator(device="cuda").manual_seed(13)
    dh0 = torch.randn(e0.shape, generator=g, device="cuda").to(dtype) * ev
    g_r_all = csr_segment_sum(dh0, t.receivers, t.row_offsets, t.num_nodes)
    g_s_all = csr_segment_sum(dh0, t.senders, t.sender_offsets, t.num_nodes, perm=t.sender_perm)
    dv_all = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    w0 = em["w"][0].double()
    for n in (t.num_nodes, t.num_nodes - 9, 5):
        g_s, g_r, dv0 = (x[:n].contiguous() for x in (g_s_all, g_r_all, dv_all))
        before = F.first_layer_adjoint.launches
        runs = []
        for _ in range(2):
            dv = dv0.clone()
            F.first_layer_adjoint(dv, g_s, g_r, em, ws_p[size_p:])
            runs.append(dv)
        assert F.first_layer_adjoint.launches == before + 2
        assert torch.equal(runs[0], runs[1])
        ref = F.first_layer_adjoint_plain(dv0, g_s, g_r, em)
        _close(runs[0], ref, dtype, "dv")
        exact = dv0.double() + g_s.double() @ w0[latent:2 * latent].t() + \
            g_r.double() @ w0[2 * latent:].t()
        assert float((runs[0].double() - exact).norm()) <= \
            1.5 * float((ref.double() - exact).norm()) + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent", [32, 64, 128, 256])
def test_wgrad_node_rows_of_the_defer_form(dtype, latent):
    """K6's N-row first-layer products of the defer_first form, x^T G with x
    in the compute dtype and G f32 (bf16: the mixed form), in one grouped
    call beside an ordinary product, against wgrad_plain; two calls the
    same bits."""
    t, *_ = _graph_and_params(dtype, latent=latent)
    g = torch.Generator(device="cuda").manual_seed(14)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dh = rnd(t.num_edges, latent).to(dtype)
    e, v = rnd(t.num_edges, latent).to(dtype), rnd(t.num_nodes, latent).to(dtype)
    gs, gr = rnd(t.num_nodes, latent), rnd(t.num_nodes, latent)
    runs = []
    for _ in range(2):
        dw = torch.empty((3 * latent, latent), device="cuda")
        db = torch.empty((latent,), device="cuda")
        F.wgrad_group([F.WgradProduct(dh, [(e, None)], dw[:latent], [db]),
                       F.WgradProduct(gs, [(v, None)], dw[latent:2 * latent]),
                       F.WgradProduct(gr, [(v, None)], dw[2 * latent:])])
        runs.append((dw, db))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    dw, db = runs[0]
    _close(dw[:latent], F.wgrad_plain(dh, e)[0], torch.float32, "dw e")
    _close(db, F.wgrad_plain(dh)[1], torch.float32, "db")
    for k, gg in enumerate((gs, gr)):
        got = dw[(1 + k) * latent:(2 + k) * latent]
        ref = F.wgrad_plain(gg, v)[0]
        _close(got, ref, torch.float32, f"dw node rows {k}")
        # f32 x f32: G is not rounded to bf16 on the way
        exact = v.double().t() @ gg.double()
        assert float((got.double() - exact).norm()) <= 1e-5 * float(exact.norm())


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


def _wgrad_twice(products):
    """Two K6 calls on ``products``: the outputs of the first, after
    checking that the second gives the same bits and that every counter is
    back at 0."""
    outs = [t for q in products for t in ([q.dw] if q.dw is not None else []) + list(q.db)]
    F.wgrad_group(products)
    first = [o.clone() for o in outs]
    F.wgrad_group(products)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, outs))
    assert not bool(F._wgrad_counters(torch.cuda.current_device()).any())
    return first


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [33, 300, 11264 + 1])
@pytest.mark.parametrize("latent", [64, 128])
def test_wgrad_kernel_row_counts(dtype, rows, latent):
    """K6 at row counts that divide neither the 32-row chunk nor a block's
    rows (the last chunk partial, one block a tile and several), a
    contiguous and a gathered part with the bias, the mixed form and column
    sums, against wgrad_plain; two calls the same bits."""
    g = torch.Generator(device="cuda").manual_seed(rows)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dh, x, v = rnd(rows, latent).to(dtype), rnd(rows, latent).to(dtype), rnd(97, latent).to(dtype)
    idx = torch.randint(0, 97, (rows,), generator=g, device="cuda", dtype=torch.int32)
    gf = rnd(rows, latent)
    part = rnd(rows, 2 * latent)
    dw = torch.empty((2 * latent, latent), device="cuda")
    dwm = torch.empty((latent, latent), device="cuda")
    db = torch.empty((latent,), device="cuda")
    cols = [torch.empty((latent,), device="cuda") for _ in range(2)]
    got = _wgrad_twice([F.WgradProduct(dh, [(x, None), (v, idx)], dw, [db]),
                        F.WgradProduct(gf, [(x, None)], dwm),
                        F.WgradProduct(part, (), None, cols)])
    ref_w = torch.cat([F.wgrad_plain(dh, x)[0], F.wgrad_plain(dh, v, idx)[0]])
    for out, ref, what in ((got[0], ref_w, "dw"), (got[1], F.wgrad_plain(dh)[1], "db"),
                           (got[2], F.wgrad_plain(gf, x)[0], "dw mixed"),
                           (torch.cat(got[3:]), F.wgrad_plain(part)[1], "column sums")):
        _close(out, ref, torch.float32, what)
    exact = x.double().t() @ gf.double()
    assert float((got[2].double() - exact).norm()) <= 1e-5 * float(exact.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_gathered_part_at_256(dtype):
    """L = 256 (four 128 x 128 tiles a part, one bulk copy a row): a
    three-part first layer, two parts gathered through the edge index, with
    the bias, against wgrad_plain; two calls the same bits."""
    t, *_ = _graph_and_params(dtype, latent=256)
    g = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
    dh, e, v = rnd(t.num_edges, 256), rnd(t.num_edges, 256), rnd(t.num_nodes, 256)
    dw = torch.empty((3 * 256, 256), device="cuda")
    db = torch.empty((256,), device="cuda")
    inputs = [(e, None), (v, t.senders), (v, t.receivers)]
    got = _wgrad_twice([F.WgradProduct(dh, inputs, dw, [db])])
    ref = torch.cat([F.wgrad_plain(dh, x, i)[0] for x, i in inputs])
    _close(got[0], ref, torch.float32, "dw")
    _close(got[1], F.wgrad_plain(dh)[1], torch.float32, "db")


def test_wgrad_counters_are_left_at_zero_between_groups():
    """A group whose tile takes many blocks (the cylinder's e part, 11,264
    rows), then a different group (the N-row pair, 64-wide tiles, then one
    with a single block a tile), then the first again: each call's results
    against wgrad_plain and the first's bits, the counters 0 after every
    call."""
    g = torch.Generator(device="cuda").manual_seed(12)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    dh, e = rnd(11264, L), rnd(11264, L)
    v, gs, gr = rnd(1920, L), rnd(1920, L), rnd(1920, L)
    dw, db, dw2 = (torch.empty((L, L), device="cuda"), torch.empty((L,), device="cuda"),
                   torch.empty((2 * L, L), device="cuda"))
    small = torch.empty((L, L), device="cuda")
    groups = [[F.WgradProduct(dh, [(e, None)], dw, [db])],
              [F.WgradProduct(gs, [(v, None)], dw2[:L]), F.WgradProduct(gr, [(v, None)], dw2[L:])],
              [F.WgradProduct(dh[:40], [(e[:40], None)], small)]]
    first = _wgrad_twice(groups[0])
    for group in groups[1:]:
        _wgrad_twice(group)
    again = _wgrad_twice(groups[0])
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _close(first[0], F.wgrad_plain(dh, e)[0], torch.float32, "dw")
    _close(first[1], F.wgrad_plain(dh)[1], torch.float32, "db")
    _close(dw2, torch.cat([F.wgrad_plain(x, v)[0] for x in (gs, gr)]), torch.float32, "rows")
    _close(small, F.wgrad_plain(dh[:40], e[:40])[0], torch.float32, "small")


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
    """K1-perm and the plain sender-side sum against an f64 scatter-add: two
    f32 sums of a row's deg terms in any order each lie within
    (deg - 1) u sum|x| of the exact sum (u = 2^-24), so the bound is
    2 (deg - 1) u sum|x| per entry, as chip_smoke.py's check_k1 uses (f64
    atomics add an error some 2^-29 times smaller).  The kernel gives the
    CPU plain version's bits: both sum in K1's fixed chunk order."""
    t, *_ = _graph_and_params(dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    data = torch.randn((t.num_edges, L), generator=g, device="cuda").to(dtype)
    before = (csr_segment_sum.launches, csr_segment_sum.perm_launches)
    out = csr_segment_sum(data, t.senders, t.sender_offsets, t.num_nodes, perm=t.sender_perm)
    assert (csr_segment_sum.launches, csr_segment_sum.perm_launches) == \
        (before[0], before[1] + 1)
    assert torch.equal(out.cpu(), csr_segment_sum_plain(
        data.cpu(), t.senders.cpu(), t.sender_offsets.cpu(), t.num_nodes,
        perm=t.sender_perm.cpu()))
    idx = t.senders.long()
    ref = torch.zeros((t.num_nodes, L), dtype=torch.float64, device="cuda").index_add_(
        0, idx, data.double())
    abs_sum = torch.zeros_like(ref).index_add_(0, idx, data.double().abs())
    deg = torch.diff(t.sender_offsets).double()[:, None]
    bound = 2 * torch.clamp(deg - 1, min=0) * 2.0 ** -24 * abs_sum
    plain = csr_segment_sum_plain(data, t.senders, t.sender_offsets, t.num_nodes,
                                  perm=t.sender_perm)
    for got in (out, plain):
        assert got.dtype == torch.float32
        assert ((got.double() - ref).abs() <= bound).all()


@pytest.mark.parametrize("defer", [None, False], ids=["own-rule", "three-part"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_process_gradients_use_the_kernels(dtype, defer, monkeypatch):
    """Gradients of fused_process on the card (per round K5/K6/K7/K4, then
    K1 twice, K8 and K6 in the defer_first form the mesh's E >= N gives, or
    K1 twice and K6 in the three-part form) against torch.autograd of
    process_rounds_plain, for every leaf, v0 and e0."""
    monkeypatch.setattr(F, "_FORCE_DEFER", defer)
    t, proc, v0, e0, ev = _graph_and_params(dtype, mps=3)
    assert t.num_edges >= t.num_nodes
    leaves = F._flatten_proc(proc)
    for x in (v0, e0, *leaves):
        x.requires_grad_(True)
    counts = (F.node_round_bwd.launches, F.edge_round_bwd.launches, F.wgrad.launches,
              F.weight_streams.launches, F.edge_round_bwd.defer_launches,
              F.first_layer_adjoint.launches)
    out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3,
                          sender_perm=t.sender_perm, sender_offsets=t.sender_offsets)
    got = torch.autograd.grad((out.float() ** 2).sum(), [v0, e0, *leaves])
    k4, k8 = (0, 3) if defer is None else (3, 0)
    assert (F.node_round_bwd.launches, F.edge_round_bwd.launches,
            F.edge_round_bwd.defer_launches, F.first_layer_adjoint.launches) == \
        (counts[0] + 3, counts[1] + k4, counts[4] + k8, counts[5] + k8)
    # one weight-stream launch: the backward reads the edge stream the forward made
    assert F.weight_streams.launches == counts[3] + 1
    assert F.wgrad.launches > counts[2]
    ref_out = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, 3, dtype,
                                     t.num_nodes)
    ref = torch.autograd.grad((ref_out.float() ** 2).sum(), [v0, e0, *leaves])
    for i, (a, b) in enumerate(zip(got, ref)):
        _grad_close(a, b, dtype, f"grad {i}")
    assert not got[1][~t.edge_mask].any()  # dead edges: no gradient


# --- the cloth family: K3's node_extra form, the world edges and their sum ----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (128, 2), (256, 3)])
def test_node_round_kernel_extra(dtype, latent, hidden):
    """K3 with an f32 first-layer offset against node_round_plain(extra=),
    ragged row counts included; a null extra keeps the bits of the call
    without it."""
    t, proc, v0, *_ = _graph_and_params(dtype, latent=latent, hidden=hidden)
    nm_all = F.cast_mlp(proc["node_mlp"], dtype)
    nm, ws_n = F.round_params(nm_all, 0), F.weight_streams(nm=nm_all)[1][0]
    g = torch.Generator(device="cuda").manual_seed(2)
    agg_all = torch.randn((t.num_nodes, latent), generator=g, device="cuda")
    extra_all = torch.randn((t.num_nodes, latent), generator=g, device="cuda")
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0.02, atol=0.05)
    for n_n in (t.num_nodes, t.num_nodes - 9):
        agg, extra = agg_all[:n_n].contiguous(), extra_all[:n_n].contiguous()
        before = (F.node_round.launches, F.node_round.extra_launches)
        v = v0[:n_n].clone()
        F.node_round(v, agg, nm, ws_n, extra)
        assert (F.node_round.launches, F.node_round.extra_launches) == (before[0],
                                                                         before[1] + 1)
        ref = F.node_round_plain(v0[:n_n], agg, nm, extra)
        torch.testing.assert_close(v.float(), ref.float(), **tol)
        v2 = v0[:n_n].clone()
        F.node_round(v2, agg, nm, ws_n, extra)
        assert torch.equal(v2, v)
        plain = v0[:n_n].clone()  # the call without extra, and a zero extra: the same bits
        F.node_round(plain, agg, nm, ws_n)
        for x in (None, torch.zeros_like(extra)):
            again = v0[:n_n].clone()
            F.node_round(again, agg, nm, ws_n, x)
            assert torch.equal(again, plain)


def test_fused_process_node_extra_kernels():
    """fused_process with a per-round node_extra hook against
    process_rounds_plain with the same hook: one weight-stream launch, and
    K2, K1 and K3 (its extra form) once a round."""
    t, proc, v0, e0, ev = _graph_and_params(torch.float32, mps=3)
    w = torch.randn((3, L, L), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda") * 0.05
    hook = lambda r, v: torch.matmul(torch.tanh(v.float()), w[r])
    before = (F.node_round.launches, F.node_round.extra_launches, F.weight_streams.launches)
    with torch.no_grad():
        out = F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3,
                              node_extra=hook)
        assert (F.node_round.launches, F.node_round.extra_launches,
                F.weight_streams.launches) == (before[0], before[1] + 3, before[2] + 1)
        seen = _kernel_counts(lambda: F.fused_process(proc, v0, e0, t.senders, t.receivers,
                                                      t.row_offsets, ev, 3, node_extra=hook),
                              {"node_round_kernel": 3, "weight_streams_kernel": 1})
    ref = F.process_rounds_plain(proc, v0, e0, t.senders, t.receivers, ev, 3, torch.float32,
                                 t.num_nodes, node_extra=hook)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert sum(n for k, n in seen.items() if "node_round_kernel" in k) == 3, seen
    assert sum(n for k, n in seen.items() if "weight_streams_kernel" in k) == 1, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_unsorted_kernel(dtype):
    """Unsorted ids sum through K1's permutation path, in f32, in a fixed
    order (the same bits twice), within the summation bound of a plain
    f64 scatter-add."""
    g = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(0, 300, (2000,), generator=g, device="cuda", dtype=torch.int32)
    data = torch.randn((2000, L), generator=g, device="cuda").to(dtype)
    before = csr_segment_sum.perm_launches
    out = segment_sum(data, ids, 300, indices_are_sorted=False)
    assert csr_segment_sum.perm_launches == before + 1
    assert torch.equal(segment_sum(data, ids, 300, indices_are_sorted=False), out)
    ref = torch.zeros((300, L), dtype=torch.float64, device="cuda").index_add_(
        0, ids.long(), data.double())
    abs_sum = torch.zeros_like(ref).index_add_(0, ids.long(), data.double().abs())
    deg = torch.bincount(ids.long(), minlength=300).double()[:, None]
    assert ((out.double() - ref).abs() <= 2 * deg * 2.0 ** -24 * abs_sum + 1e-30).all()


def test_csr_order_invalid_rows_are_never_read_by_the_kernel():
    """Rows that ``csr_order`` marks invalid sort past every K1 row: NaNs in
    them do not reach the sums, and every row, node 0's too, sums only
    valid rows."""
    g = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, 300, (2000,), generator=g, device="cuda", dtype=torch.int32)
    valid = torch.rand((2000,), generator=g, device="cuda") < 0.5
    ids = torch.where(valid, ids, torch.zeros_like(ids))  # dead slots point at node 0
    data = torch.randn((2000, L), generator=g, device="cuda")
    perm, offsets = csr_order(ids, 300, valid)
    assert int(offsets[-1]) == int(valid.sum())
    poisoned = torch.where(valid[:, None], data, torch.full_like(data, float("nan")))
    out = csr_segment_sum(poisoned, ids, offsets, 300, perm=perm)
    ref = torch.zeros((300, L), dtype=torch.float64, device="cuda").index_add_(
        0, ids[valid].long(), data[valid].double())
    abs_sum = torch.zeros_like(ref).index_add_(0, ids[valid].long(), data[valid].double().abs())
    deg = torch.bincount(ids[valid].long(), minlength=300).double()[:, None]
    assert torch.isfinite(out).all()
    assert ((out.double() - ref).abs() <= 2 * deg * 2.0 ** -24 * abs_sum + 1e-30).all()


def test_build_world_edges_on_the_card_gives_the_cpu_bits():
    """Elementwise f32 Gram sums (no tensor core, whatever TF32 allows) and
    an f64 centre: the card builds the CPU's world edges."""
    pos, cells, nt = make_flag_mesh(50, 32)
    t = build_template(pos, nt, cells=cells)
    wp = np.zeros((t.num_nodes, 3), np.float32)
    for frame, wp_f in enumerate(make_flag_trajectory(pos, nt, tl=4, dt=0.02, seed=0)):
        wp[: len(pos)] = wp_f
        x = torch.from_numpy(wp)
        cpu = build_world_edges(x, t.node_mask, 0.05, 4 * t.num_nodes, t.senders, t.receivers)
        torch.backends.cuda.matmul.allow_tf32 = frame % 2 == 1
        dev = build_world_edges(x.cuda(), t.node_mask.cuda(), 0.05, 4 * t.num_nodes,
                                t.senders.cuda(), t.receivers.cuda())
        torch.backends.cuda.matmul.allow_tf32 = False
        for a, b in zip(cpu, dev):
            assert torch.equal(a, b.cpu())
        assert bool(cpu[2].all())  # the buffer is full: 4 slots a node are fewer than hits


def test_apply_mgn_multi_kernels_match_plain():
    """The two-edge-set model on the card (K2, K1, K3 with its extra form,
    K1 through a permutation for the world set) against the CPU plain path."""
    pos, cells, nt = make_flag_mesh(20, 12)
    t = build_template(pos, nt, cells=cells)
    rng = np.random.default_rng(5)
    cap = 4 * t.num_nodes
    wp = np.zeros((t.num_nodes, 3), np.float32)
    wp[: len(pos)] = make_flag_trajectory(pos, nt, tl=3, dt=0.02, seed=1)[2]
    ws, wr, wm = build_world_edges(torch.from_numpy(wp), t.node_mask, 0.12, cap, t.senders,
                                   t.receivers)
    cfg = MultiMGNConfig(node_input_dim=10, edge_input_dims=(7, 4), output_dim=3,
                         latent_size=32, hidden_layers=2, message_passing_steps=3)
    params = init_mgn_multi(cfg, torch.Generator().manual_seed(6), device="cpu")
    feats = [rng.normal(size=(rows, d)).astype(np.float32)
             for rows, d in ((t.num_nodes, 10), (t.num_edges, 7), (cap, 4))]

    def graph(dev):
        on = lambda x: torch.as_tensor(x).to(dev)
        return MultiGraph(
            node_features=on(feats[0]) * on(t.node_mask)[:, None],
            edge_sets=(EdgeSet(on(feats[1]), on(t.senders), on(t.receivers), on(t.edge_mask),
                               on(t.row_offsets)),
                       EdgeSet(on(feats[2]), on(ws), on(wr), on(wm))),
            node_mask=on(t.node_mask))

    ref = apply_mgn_multi(params, graph("cpu"), cfg)
    before = (F.node_round.extra_launches, csr_segment_sum.perm_launches)
    with torch.no_grad():
        out = apply_mgn_multi(_to_cuda(params), graph("cuda"), cfg)
    assert (F.node_round.extra_launches, csr_segment_sum.perm_launches) == (before[0] + 3,
                                                                          before[1] + 3)
    n = len(pos)
    torch.testing.assert_close(out.cpu()[:n], ref[:n], rtol=1e-3, atol=1e-3)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


# --- cloth training: K5's node_extra form and the world set's backward ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (128, 2), (256, 3)])
def test_node_round_bwd_kernel_extra(dtype, latent, hidden):
    """K5 with an f32 first-layer offset against node_round_bwd_plain(extra=):
    dv, dagg, dxtr and the parts K6 reads, ragged row counts included.
    dxtr is dh0 in f32.  A zero offset recomputes other ReLU masks, which
    the check must refuse; a null offset (the call without it) and a zero
    one give the bits of K5 without it."""
    t, proc, v0, *_ = _graph_and_params(dtype, latent=latent, hidden=hidden)
    nm_all = F.cast_mlp(proc["node_mlp"], dtype)
    nm, ws = F.round_params(nm_all, 1), F.weight_streams(nm=nm_all, adjoint=True)[1][1]
    g = torch.Generator(device="cuda").manual_seed(3)
    agg_all = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    dv_all = torch.randn(v0.shape, generator=g, device="cuda").to(dtype)
    extra_all = 2 * torch.randn(v0.shape, generator=g, device="cuda")
    for n_n in (t.num_nodes, t.num_nodes - 9):
        v, agg, dv0, extra = (x[:n_n].contiguous() for x in (v0, agg_all, dv_all, extra_all))
        before = (F.node_round_bwd.launches, F.node_round_bwd.extra_launches)
        dv = dv0.clone()
        dagg, saved, dxtr = F.node_round_bwd(dv, v, agg, nm, ws, extra)
        assert (F.node_round_bwd.launches, F.node_round_bwd.extra_launches) == (
            before[0], before[1] + 1)
        ref_dv, ref_dagg, ref_saved, ref_dxtr = F.node_round_bwd_plain(dv0, v, agg, nm, extra)
        _close(dv, ref_dv, dtype, "dv")
        _close(dagg, ref_dagg, dtype, "dagg")
        _close(dxtr, ref_dxtr, dtype, "dxtr")
        _saved_close(saved, ref_saved, dtype, "node extra")
        assert dxtr.dtype == torch.float32 and torch.equal(dxtr, saved.dh[0].float())
        with pytest.raises(AssertionError):  # the control: the forward's masks matter
            dz = dv0.clone()
            _close(F.node_round_bwd(dz, v, agg, nm, ws, torch.zeros_like(extra))[2],
                   ref_dxtr, dtype, "zero extra")
        plain = dv0.clone()
        plain_out = F.node_round_bwd(plain, v, agg, nm, ws)
        zero = dv0.clone()
        zero_out = F.node_round_bwd(zero, v, agg, nm, ws, torch.zeros_like(extra))
        assert torch.equal(zero, plain) and torch.equal(zero_out[0], plain_out[0])
        for a, b in zip([*zero_out[1].dh, *zero_out[1].post, zero_out[1].ln],
                        [*plain_out[1].dh, *plain_out[1].post, plain_out[1].ln]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_extra", [False, True])
def test_node_round_bwd_kernel_is_deterministic(dtype, with_extra):
    """Two K5 calls on the same inputs give the same bits in every output
    (dv, dagg, dxtr, dh, post and the LayerNorm partial sums), with the
    offset and without: fixed-order sums, no atomics."""
    t, proc, v0, *_ = _graph_and_params(dtype)
    nm_all = F.cast_mlp(proc["node_mlp"], dtype)
    nm, ws = F.round_params(nm_all, 0), F.weight_streams(nm=nm_all, adjoint=True)[1][0]
    g = torch.Generator(device="cuda").manual_seed(8)
    agg, dv0 = (torch.randn(v0.shape, generator=g, device="cuda").to(dtype) for _ in range(2))
    extra = 2 * torch.randn(v0.shape, generator=g, device="cuda") if with_extra else None
    runs = []
    for _ in range(2):
        dv = dv0.clone()
        dagg, saved, *dx = F.node_round_bwd(dv, v0, agg, nm, ws, extra)
        runs.append([dv, dagg, *dx, *saved.dh, *saved.post, saved.ln])
    assert len(runs[0]) == 2 + with_extra + 3 + 2 + 1  # dh: 3 layers, post: 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _cloth_case(dtype=torch.float32):
    """A 20 x 12 flag with its world edges, a small two-edge-set model whose
    leaves need a gradient, and its graph on the card and on the CPU."""
    pos, cells, nt = make_flag_mesh(20, 12)
    t = build_template(pos, nt, cells=cells)
    cap = 4 * t.num_nodes
    wp = np.zeros((t.num_nodes, 3), np.float32)
    wp[: len(pos)] = make_flag_trajectory(pos, nt, tl=3, dt=0.02, seed=1)[2]
    ws, wr, wm = build_world_edges(torch.from_numpy(wp), t.node_mask, 0.12, cap, t.senders,
                                   t.receivers)
    cfg = MultiMGNConfig(node_input_dim=10, edge_input_dims=(7, 4), output_dim=3,
                         latent_size=32, hidden_layers=2, message_passing_steps=3,
                         compute_dtype=dtype)
    params = init_mgn_multi(cfg, torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=(rows, d)).astype(np.float32)
             for rows, d in ((t.num_nodes, 10), (t.num_edges, 7), (cap, 4))]

    def graph(dev):
        on = lambda x: torch.as_tensor(x).to(dev)
        return MultiGraph(
            node_features=on(feats[0]) * on(t.node_mask)[:, None],
            edge_sets=(EdgeSet(on(feats[1]), on(t.senders), on(t.receivers), on(t.edge_mask),
                               on(t.row_offsets), on(t.sender_perm), on(t.sender_offsets)),
                       EdgeSet(on(feats[2]) * on(wm)[:, None], on(ws), on(wr), on(wm))),
            node_mask=on(t.node_mask))

    return cfg, params, graph, len(pos)


def _leaves_with_grad(tree):
    leaves = param_leaves(tree)
    for x in leaves:
        x.requires_grad_(True)
    return leaves


def test_cloth_gradient_on_the_card_is_deterministic_and_matches_the_cpu():
    """apply_mgn_multi's whole gradient on the card (K2, K1, K3 and K5 in
    their extra forms, K4, K6, K1-perm for the mesh's senders and the world
    set's gathers) against the CPU plain path, and a second backward pass
    that gives the same bits."""
    cfg, params, graph, n = _cloth_case()
    cpu_leaves = _leaves_with_grad(params)
    ref = torch.autograd.grad((apply_mgn_multi(params, graph("cpu"), cfg)[:n] ** 2).sum(),
                              cpu_leaves)
    p = _to_cuda(params)
    leaves = _leaves_with_grad(p)
    g_cuda = graph("cuda")
    before = (F.node_round_bwd.extra_launches, F.node_round_bwd.launches)
    runs = [torch.autograd.grad((apply_mgn_multi(p, g_cuda, cfg)[:n] ** 2).sum(), leaves)
            for _ in range(2)]
    assert (F.node_round_bwd.extra_launches, F.node_round_bwd.launches) == (before[0] + 6,
                                                                          before[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(runs[0], ref)):
        _grad_close(a.cpu(), b, torch.float32, f"leaf {i}")
    world = {id(x) for x in _leaves_with_grad(p["processor"]["edge_mlps"][1])}
    assert all(float(a.abs().max()) > 0 for a, x in zip(runs[0], leaves) if id(x) in world)


def test_cloth_gradient_kernel_counts():
    """The device kernels of one differentiable forward and backward at 3
    rounds: per round one weight-stream launch (one mps=1 call a round), K7
    twice (the forward's projections and the backward's recompute), K2, K3,
    K4 (its defer_first form: the mesh set has E >= N), K5 and K8 once, and
    K1 a mesh receiver sum and a world receiver sum forward, the mesh's dh0
    by receiver and by sender and the world set's two gathers backward (K1
    and K1-perm are one kernel)."""
    cfg, params, graph, n = _cloth_case()
    p = _to_cuda(params)
    leaves = _leaves_with_grad(p)
    g_cuda = graph("cuda")
    want = {"weight_streams_kernel": 3, "edge_project_kernel": 3 * 2, "edge_round_kernel": 3,
            "node_round_kernel": 3, "edge_round_bwd_kernel": 3, "node_round_bwd_kernel": 3,
            "csr_segment_sum_kernel": 3 * 6, "first_layer_adjoint_kernel": 3}
    seen = _kernel_counts(lambda: torch.autograd.grad(
        (apply_mgn_multi(p, g_cuda, cfg)[:n] ** 2).sum(), leaves), want)
    by = {k: sum(c for name, c in seen.items() if k in name) for k in want}
    assert by == want, seen


# --- disjoint-union batching: B subgraphs as one graph -------------------------------

def _union_templates():
    """Two channel meshes of one bucket and their union (data/union.py):
    two trash rows, the first subgraph's dead edges in the middle."""
    from mgn_tpu_torch.data.prep import PreparedTrajectory
    from mgn_tpu_torch.data.union import union_prepared

    tms = []
    for seed in (0, 1):
        pos, cells, nt = make_channel_mesh(300 + 20 * seed, seed=seed)
        tms.append(build_template(pos, nt, cells=cells, node_bucket=384,
                                  edge_bucket=2048).to("cuda"))
    preps = [PreparedTrajectory(t, {}, torch.zeros(2, device="cuda"), 0, 2) for t in tms]
    return tms, union_prepared(preps)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (128, 2)])
def test_union_fused_process_is_the_per_graph_calls(dtype, latent, hidden):
    """The union's fused_process on the subgraphs' inputs concatenated gives
    each subgraph's own fused_process bits: every kernel output row depends
    on that row's inputs alone (K1's fixed order within a row; K2, K3 and K7
    per edge or per node)."""
    tms, tu = _union_templates()
    proc = init_mgn(MGNConfig(9, 3, 2, latent, hidden, 3), torch.Generator().manual_seed(0),
                    device="cuda")["processor"]
    g = torch.Generator(device="cuda").manual_seed(2)
    parts = []
    for t in tms:
        ev = t.edge_mask.to(dtype)[:, None].contiguous()
        v0 = torch.randn((t.num_nodes, latent), generator=g, device="cuda").to(dtype)
        e0 = (torch.randn((t.num_edges, latent), generator=g, device="cuda").to(dtype) * ev)
        parts.append((v0, e0.contiguous(), ev))
    with torch.no_grad():
        singles = [F.fused_process(proc, v0, e0, t.senders, t.receivers, t.row_offsets, ev, 3)
                   for (v0, e0, ev), t in zip(parts, tms)]
        cat = [torch.cat([p[i] for p in parts]).contiguous() for i in range(3)]
        before = F.edge_round.launches
        joint = F.fused_process(proc, *cat[:2], tu.senders, tu.receivers, tu.row_offsets,
                                cat[2], 3)
    assert F.edge_round.launches == before + 3
    n = tms[0].num_nodes
    for i, single in enumerate(singles):
        assert torch.equal(joint[i * n:(i + 1) * n], single), i


def test_union_training_gradient_matches_the_cpu():
    """One union training frame's whole-model gradient on the card (the
    defer_first backward over B·N rows) against the CPU plain path, f32, to
    the whole-gradient tolerance of _grad_close."""
    from mgn_tpu_torch.core.graph import MeshGraph
    from mgn_tpu_torch.models.mgn import apply_mgn

    tms, tu = _union_templates()
    cfg = MGNConfig(9, 3, 2, L, 2, 3)
    params = init_mgn(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(3)
    nf = torch.randn((tu.num_nodes, 9), generator=g) * tu.node_mask.cpu()[:, None]
    ef = torch.randn((tu.num_edges, 3), generator=g) * tu.edge_mask.cpu()[:, None]
    target = torch.randn((tu.num_nodes, 2), generator=g)
    grads, counts = [], None
    for dev in ("cuda", "cpu"):
        t = tu.to(dev)
        p = _leaf_copy(params, dev)
        graph = MeshGraph(nf.to(dev), ef.to(dev), t.senders, t.receivers, t.node_mask,
                          t.edge_mask)
        before = (F.edge_round_bwd.launches, F.edge_round_bwd.defer_launches)
        pred = apply_mgn(p, graph, cfg, t.row_offsets, t.sender_perm, t.sender_offsets)
        loss = (((pred - target.to(dev)) ** 2).sum(-1) * t.node_mask).sum()
        grads.append([x.cpu() for x in torch.autograd.grad(loss, param_leaves(p))])
        if dev == "cuda":
            counts = (F.edge_round_bwd.launches - before[0],
                      F.edge_round_bwd.defer_launches - before[1])
    assert counts == (0, 3)  # B·E >= B·N: the defer_first form, no three-part K4
    for i, (a, b) in enumerate(zip(*grads, strict=True)):
        _grad_close(a, b, torch.float32, f"grad {i}")


def _leaf_copy(tree, dev):
    if isinstance(tree, dict):
        return {k: _leaf_copy(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_copy(v, dev) for v in tree]
    return tree.detach().to(dev, copy=True).requires_grad_(True)
