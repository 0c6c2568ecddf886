"""Port: the processor rounds (ops/fused) against the JAX package's fused
Pallas kernel in interpret mode and its XLA reference (f32, and bf16 against
the XLA reference), at every latent the CUDA kernels are built for; and the
layouts of the weight streams of K2, K3, K4 and K5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu.ops.fused import build_fused_plan, fused_process as jax_fused_process
from mgn_tpu.ops.fused import process_rounds_xla
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.ops.csr_segment import csr_segment_sum
from tests.torch_support import local_graph, one_thread  # noqa: F401  (fixture)

torch.set_num_threads(2)

N, E, LATENT, MPS = 256, 512, 32, 3


def _setup(seed, dead_edges=0, latent=LATENT, hidden=2):
    rng = np.random.default_rng(seed)
    s, r = local_graph(rng, N, E)
    if dead_edges:  # padded tail aimed at the trash node, as build_template does
        s[-dead_edges:] = N - 1
        r[-dead_edges:] = N - 1
    cfg = JaxMGNConfig(node_input_dim=8, edge_input_dim=3, output_dim=2,
                       latent_size=latent, hidden_layers=hidden, message_passing_steps=MPS)
    proc = jax_init_mgn(jax.random.PRNGKey(seed), cfg)["processor"]
    v0 = rng.normal(size=(N, latent)).astype(np.float32)
    e0 = rng.normal(size=(E, latent)).astype(np.float32)
    ev = np.ones((E, 1), np.float32)
    if dead_edges:
        ev[-dead_edges:] = 0.0
        e0[-dead_edges:] = 0.0
    row = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=N))]).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    port = dict(proc=params_from_jax(jax.tree.map(np.asarray, proc)), v0=t(v0), e0=t(e0),
                s=t(s), r=t(r), row=t(row), ev=t(ev))
    return proc, s, r, v0, e0, ev, port


def _plain(port):
    return F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"], port["r"],
                                  port["ev"], MPS, torch.float32, N)


def test_plain_matches_jax_fused_kernel():
    proc, s, r, v0, e0, ev, port = _setup(1)
    plan = build_fused_plan(s, r, N)
    assert plan is not None
    ref = jax_fused_process(proc, jnp.asarray(v0), jnp.asarray(e0), plan, jnp.asarray(s),
                            jnp.asarray(r), jnp.asarray(ev), MPS, interpret=True)
    np.testing.assert_allclose(_plain(port).numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# (dead_edges, latent, hidden layers, compute dtype): the first two cases
# are the cylinder-like width 32 at 2 hidden layers; the rest cover every
# latent the kernels are built for (_KERNEL_LATENTS) and 1 to 3 hidden layers
_XLA_CASES = [
    pytest.param(0, 32, 2, "float32", id="0"),
    pytest.param(40, 32, 2, "float32", id="40"),
    pytest.param(0, 32, 1, "float32", id="L32-h1-f32"),
    pytest.param(40, 64, 3, "float32", id="L64-h3-f32"),
    pytest.param(0, 128, 2, "float32", id="L128-h2-f32"),
    pytest.param(40, 256, 1, "float32", id="L256-h1-f32"),
    pytest.param(0, 256, 3, "float32", id="L256-h3-f32"),
    pytest.param(40, 64, 2, "bfloat16", id="L64-h2-bf16"),
    pytest.param(0, 128, 2, "bfloat16", id="L128-h2-bf16"),
    pytest.param(40, 256, 3, "bfloat16", id="L256-h3-bf16"),
    # widths the kernels are not built for, which fused_process pads (the
    # reference runs them as they are)
    pytest.param(40, 48, 1, "float32", id="L48-h1-f32"),
    pytest.param(0, 90, 2, "float32", id="L90-h2-f32"),
    pytest.param(40, 200, 2, "bfloat16", id="L200-h2-bf16"),
]


@pytest.mark.parametrize("dead_edges,latent,hidden,dtype", _XLA_CASES)
def test_plain_matches_process_rounds_xla(dead_edges, latent, hidden, dtype):
    """f32: rtol/atol 2e-5 (the two sum the products in other orders).
    bf16, with bf16 inputs on both sides: both round to bf16 at the same
    points (apply_mlp_parts), but the JAX reference sums each node's
    messages in bf16 where the port sums them in f32 (ROADMAP C.1), so after
    3 rounds about half the entries are one bf16 ulp (2^-8 relative) apart:
    relative L2 <= 2e-2 (chip_smoke.py's bf16 processor tolerance; measured
    4.3e-3 to 4.8e-3) and every entry within 2^-5 x max |ref| (measured
    <= 8.4e-3)."""
    proc, s, r, v0, e0, ev, port = _setup(2, dead_edges, latent, hidden)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_v, ref_e = process_rounds_xla(proc, jnp.asarray(v0).astype(jdt),
                                      jnp.asarray(e0).astype(jdt), jnp.asarray(s),
                                      jnp.asarray(r), jnp.asarray(ev).astype(jdt), MPS, jdt, N,
                                      return_edges=True)
    v, e = F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"], port["r"],
                                  port["ev"].to(tdt), MPS, tdt, N, return_edges=True)
    for got, ref in ((v, ref_v), (e, ref_e)):
        got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        else:
            assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
            assert np.abs(got - ref).max() <= 2.0 ** -5 * np.abs(ref).max()
    if dead_edges:  # masked messages leave dead edges and the trash node's e alone
        assert not e.float().numpy()[-dead_edges:].any()


def test_wrappers_on_cpu_run_the_round_in_place():
    """fused_process's round loop, K7 -> K2 -> K1 -> K3 through the wrappers
    (their plain versions on the CPU, which read no weight stream), equals
    the plain reference in its pre-projected form bit for bit."""
    _, _, _, _, _, _, port = _setup(3, dead_edges=16)
    v, e = port["v0"].clone(), port["e0"].clone()
    for rnd in range(MPS):
        em = F.round_params(port["proc"]["edge_mlp"], rnd)
        p, q = F.edge_project(v, em, None)
        msg = F.edge_round(e, p, q, port["s"], port["r"], port["ev"], em, None)
        agg = csr_segment_sum(msg, port["r"], port["row"], N)
        F.node_round(v, agg, F.round_params(port["proc"]["node_mlp"], rnd), None)
    ref_v, ref_e = F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"],
                                          port["r"], port["ev"], MPS, torch.float32, N,
                                          return_edges=True, preproject=True)
    torch.testing.assert_close(v, ref_v, rtol=0, atol=0)
    torch.testing.assert_close(e, ref_e, rtol=0, atol=0)
    out = F.fused_process(port["proc"], port["v0"], port["e0"], port["s"], port["r"],
                          port["row"], port["ev"], MPS)
    torch.testing.assert_close(out, ref_v, rtol=0, atol=0)


def test_round_params_slices_one_round():
    _, _, _, _, _, _, port = _setup(4)
    rp = F.round_params(port["proc"]["edge_mlp"], 1)
    assert tuple(rp["w"][0].shape) == (3 * LATENT, LATENT)
    torch.testing.assert_close(rp["w"][2], port["proc"]["edge_mlp"]["w"][2][1])
    assert tuple(rp["ln_scale"].shape) == (LATENT,)


def _edge_stream_entries(mlp, L, dtype, adjoint=False):
    """Decode the plain edge weight stream with the kernel's own index
    formulas (EdgeTile in csrc/edge_tile.cuh: tf32_core_offset for f32,
    padded rows for bf16): returns (B[k][n] per round and product, the
    padding values, the stream)."""
    ws = F.weight_streams_plain(em=mlp, adjoint=adjoint)[0]
    w = mlp["w"]
    rounds, n_prod = w[0].shape[0], 2 * len(w) + 2 if adjoint else len(w)
    kc = min(128 // (4 if dtype == torch.float32 else 2), L)
    chunks = L // kc
    per = 2 * L * kc if dtype == torch.float32 else L * (kc + 8)
    assert tuple(ws.shape) == (rounds, n_prod * chunks * per)
    n, k = np.meshgrid(np.arange(L), np.arange(kc), indexing="ij")
    if dtype == torch.float32:
        off = ((n >> 3) * (kc >> 2) + (k >> 2)) * 32 + (n & 7) * 4 + (k & 3)
    else:
        off = n * (kc + 8) + k
    got = ws.float().view(rounds, n_prod, chunks, per)
    out = torch.zeros((rounds, n_prod, L, L))  # [r, p, k, n]
    for c in range(chunks):
        vals = got[:, :, c, off.reshape(-1)].view(rounds, n_prod, L, kc)  # [.., n, k]
        if dtype == torch.float32:
            vals = vals + got[:, :, c, L * kc + off.reshape(-1)].view(rounds, n_prod, L, kc)
        out[:, :, c * kc:(c + 1) * kc, :] = vals.transpose(-1, -2)
    pad = None
    if dtype != torch.float32:
        mask = np.ones(per, bool)
        mask[off.reshape(-1)] = False
        pad = got[:, :, :, torch.from_numpy(mask)]
    return out, pad, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_weight_streams_plain_layout(dtype, latent, hidden):
    """K2's weight stream holds every forward product's B[k][n] (the first
    layer's e rows, then each hidden layer) where the edge tile reads it:
    f32 as a TF32 high part (10 mantissa bits) plus a TF32 low part whose
    sum is the weight to 2^-21, bf16 exactly, with zero padding.  K3's holds
    the node MLP's weight rows as they are, each padded with 8 zeros."""
    _, _, _, _, _, _, port = _setup(5, latent=latent, hidden=hidden)
    em = F.cast_mlp(port["proc"]["edge_mlp"], dtype)
    nm = F.cast_mlp(port["proc"]["node_mlp"], dtype)
    got, pad, ws = _edge_stream_entries(em, latent, dtype)
    w = em["w"]
    want = torch.stack([w[0][:, :latent]] + list(w[1:]), 1).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2.0 ** -21, atol=0)
        bits = ws.view(torch.int32)
        assert not (bits & 0x1FFF).any()  # every plane value is a TF32 number
    else:
        assert torch.equal(got, want)
        assert not pad.any()
    edge, node, _ = F.weight_streams_plain(em, nm)
    assert torch.equal(edge, ws)
    assert F._stream_sizes(latent, dtype, len(w), 0)[0] == ws.shape[1]
    rows = node.view(MPS, (2 + hidden) * latent, latent + 8)
    assert torch.equal(rows[:, :2 * latent, :latent], nm["w"][0])
    for i in range(1, hidden + 1):
        assert torch.equal(rows[:, (1 + i) * latent:(2 + i) * latent, :latent], nm["w"][i])
    assert not rows[:, :, latent:].any()


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_loop_with_weight_streams_is_the_plain_rounds(dtype):
    """The round loop through the wrappers, K7, K2 and K3 given their
    prepared weight streams as fused_process gives them, equals
    process_rounds_plain in its pre-projected form bit for bit on the CPU,
    as fused_process does (every path on one thread, on inputs in memory
    torch allocated)."""
    _, _, _, _, _, _, port = _setup(6, dead_edges=16)
    port = dict(port, v0=port["v0"].clone(), e0=port["e0"].clone())
    em = F.cast_mlp(port["proc"]["edge_mlp"], dtype)
    nm = F.cast_mlp(port["proc"]["node_mlp"], dtype)
    ws_e, ws_n, ws_p = F.weight_streams(em, nm)
    assert ws_e.shape[0] == ws_n.shape[0] == ws_p.shape[0] == MPS
    assert F.weight_streams.launches == 0  # the plain version on the CPU
    v, e = port["v0"].to(dtype, copy=True), port["e0"].to(dtype, copy=True)
    ev = port["ev"].to(dtype)
    for rnd in range(MPS):
        em_r = F.round_params(em, rnd)
        p, q = F.edge_project(v, em_r, ws_p[rnd])
        msg = F.edge_round(e, p, q, port["s"], port["r"], ev, em_r, ws_e[rnd])
        agg = csr_segment_sum(msg, port["r"], port["row"], N)
        F.node_round(v, agg, F.round_params(nm, rnd), ws_n[rnd])
    ref_v, ref_e = F.process_rounds_plain(port["proc"], port["v0"], port["e0"], port["s"],
                                          port["r"], ev, MPS, dtype, N, return_edges=True,
                                          preproject=True)
    assert torch.equal(v, ref_v) and torch.equal(e, ref_e)
    out_v, out_e = F.fused_process(port["proc"], port["v0"].to(dtype), port["e0"].to(dtype),
                                   port["s"], port["r"], port["row"], ev, MPS,
                                   return_edges=True)
    assert torch.equal(out_v, ref_v) and torch.equal(out_e, ref_e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_weight_streams_plain_adjoint_layout(dtype, latent, hidden):
    """Made for a gradient, each round's edge stream is K2's forward
    products followed by K4's adjoint products, B = W^T of the hidden layers
    from the last to the first, then of the first layer's three row blocks
    (edge_round_bwd_kernel's product order), in the same chunk layout."""
    _, _, _, _, _, _, port = _setup(8, latent=latent, hidden=hidden)
    em = F.cast_mlp(port["proc"]["edge_mlp"], dtype)
    got, pad, ws = _edge_stream_entries(em, latent, dtype, adjoint=True)
    fwd = F.weight_streams_plain(em=em)[0]
    assert torch.equal(ws[:, :fwd.shape[1]], fwd)  # K2 reads the leading half as it is
    w = em["w"]
    w0 = [w[0][:, p * latent:(p + 1) * latent] for p in range(3)]
    want = torch.stack([x.transpose(-1, -2) for x in list(w[:0:-1]) + w0], 1).float()
    n_fwd = len(w)
    if dtype == torch.float32:
        torch.testing.assert_close(got[:, n_fwd:], want, rtol=2.0 ** -21, atol=0)
        assert not (ws.view(torch.int32) & 0x1FFF).any()
    else:
        assert torch.equal(got[:, n_fwd:], want)
        assert not pad.any()
    assert F._stream_sizes(latent, dtype, len(w), 0, adjoint=True)[0] == ws.shape[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("latent,hidden", [(32, 1), (64, 2), (128, 2), (256, 3)])
def test_weight_streams_plain_node_adjoint_layout(dtype, latent, hidden):
    """Made for a gradient, each round's node stream is K3's rows followed by
    K5's adjoint products, B = W^T of the hidden layers from the last to the
    first, then of the first layer's v and agg row blocks
    (node_round_bwd_kernel's product order), every row padded with 8
    zeros as K3's are."""
    _, _, _, _, _, _, port = _setup(8, latent=latent, hidden=hidden)
    nm = F.cast_mlp(port["proc"]["node_mlp"], dtype)
    ws = F.weight_streams_plain(nm=nm, adjoint=True)[1]
    fwd = F.weight_streams_plain(nm=nm)[1]
    assert torch.equal(ws[:, :fwd.shape[1]], fwd)  # K3 reads the leading half as it is
    w = nm["w"]
    rows = ws[:, fwd.shape[1]:].view(MPS, (2 + hidden) * latent, latent + 8)
    want = [x.transpose(-1, -2) for x in list(w[:0:-1])
            + [w[0][:, p * latent:(p + 1) * latent] for p in range(2)]]
    for i, b in enumerate(want):
        assert torch.equal(rows[:, i * latent:(i + 1) * latent, :latent], b)
    assert not rows[:, :, latent:].any()
    assert F._stream_sizes(latent, dtype, 0, len(w), adjoint=True)[1] == ws.shape[1]
    assert F._stream_sizes(latent, dtype, 0, len(w))[1] == fwd.shape[1]


@pytest.mark.parametrize("parts", [3, 2])
def test_backward_params_point_at_every_output(parts):
    """K4's parameters (3 parts) and K5's (2 parts) carry no transposed
    weights (both read their adjoint products from the weight streams) and
    point at every dh, post and LayerNorm partial buffer the kernels
    write."""
    _, _, _, _, _, _, port = _setup(9)
    mlp = F.cast_mlp(port["proc"]["edge_mlp" if parts == 3 else "node_mlp"], torch.float32)
    rows = F._EDGE_BWD_ROWS if parts == 3 else F._NODE_BWD_ROWS
    saved = F._new_saved(torch.zeros((40, LATENT)), len(mlp["w"]), rows)
    assert saved.ln.shape == (-(-40 // rows), 2 * LATENT)
    q = F._bwd_struct(saved)
    assert [name for name, _ in q._fields_] == ["dh", "post", "ln_part"]
    assert list(q.dh[:len(saved.dh)]) == [d.data_ptr() for d in saved.dh]
    assert list(q.post[:len(saved.post)]) == [p.data_ptr() for p in saved.post]
    assert q.ln_part == saved.ln.data_ptr()
