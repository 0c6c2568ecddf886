"""K2 ``edge_round``: its launch plan on the CPU, the kernel on the card.

``ops.fused.edge_plan`` mirrors ``EdgeRing`` in ``csrc/edge_tile.cuh``: a
64-edge tile a block and a ring of weight chunks as deep as two blocks an
SM allow.  The CPU tests hold the plan to the card's limits and to the
rows it must cover; the card tests
(``requires_cuda``, skipped here) hold the kernel against
``edge_round_plain`` and against the plan the compiled kernel reports.
Run the card tests with ``python -m pytest --noconftest
tests/test_torch_edge_round.py -q``; this module imports nothing of JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from mgn_tpu_torch.models.mgn import MGNConfig, init_mgn
from mgn_tpu_torch.ops import _build
from mgn_tpu_torch.ops import fused as F
from mgn_tpu_torch.probes import k2_split
from tests.torch_support import cuda_device  # noqa: F401  (fixture)

DTYPES = [torch.float32, torch.bfloat16]
LATENTS = [32, 64, 128, 256]
# rows 1, 63, 64, 65, then the padded edge counts of the cylinder
# (make_channel_mesh(1900)), the flag's serving template and the 20k-node
# channel mesh
ROWS = [1, 63, 64, 65, 11264, 10240, 119808]
CYLINDER, FLAG = 11264, 10240
SMEM_LIMIT = 232448  # dynamic shared memory an H100 block can have
PAIR_LIMIT = 115712  # the same for each of two blocks an SM
SMS = 132


def _tile_rows(plan, n_edges):
    """Each block's rows, in launch order, as the kernel assigns them: block
    b owns rows 64 b .. 64 b + 64, cut at n_edges."""
    return [(b, range(min(64 * b, n_edges), min(64 * b + 64, n_edges)))
            for b in range(plan["grid"])]


@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_plan_tiles_cover_every_row_once_in_order(dtype, latent):
    for n in ROWS:
        plan = F.edge_plan(n, latent, dtype)
        rows = [r for _, rs in _tile_rows(plan, n) for r in rs]
        assert rows == list(range(n)), n
        # no block past the last edge
        assert all(len(rs) for _, rs in _tile_rows(plan, n)), n


@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_plan_grid_is_a_block_a_tile(dtype, latent):
    """One block for every 64 edges, whatever the width and dtype, and as
    many waves of the 132 SMs as the blocks an SM make it."""
    for n in ROWS:
        plan = F.edge_plan(n, latent, dtype)
        assert plan["grid"] == -(-n // 64), n
        assert plan["waves"] == -(-plan["grid"] // (SMS * plan["blocks_per_sm"])), n


@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_plan_fits_the_card(dtype, latent):
    plan = F.edge_plan(CYLINDER, latent, dtype)
    assert plan["smem"] <= SMEM_LIMIT
    assert plan["threads"] == 128 * plan["col_groups"] <= 512
    assert plan["stages"] in (2, 3, 4)
    # two blocks an SM where their shared memory allows it
    assert plan["blocks_per_sm"] == (2 if plan["smem"] <= PAIR_LIMIT else 1)
    # the ring holds whole chunks of the weight stream, one stage each
    kc, per = F._stream_chunk(latent, dtype)
    assert plan["stage_bytes"] == per * torch.finfo(dtype).bits // 8
    assert plan["chunks"] == latent // kc
    # a deeper ring would not fit where the plan stops (two blocks an SM
    # for tiles of up to 256 threads)
    room = PAIR_LIMIT if plan["threads"] <= 256 else SMEM_LIMIT
    assert plan["stages"] == 4 or plan["stages"] == 2 and plan["smem"] > room or \
        plan["smem"] + plan["stage_bytes"] + 8 > room


@pytest.mark.parametrize("latent", [32, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_plan_cylinder_and_flag_take_one_wave(dtype, latent):
    for n in (CYLINDER, FLAG):
        plan = F.edge_plan(n, latent, dtype)
        assert plan["blocks_per_sm"] == 2 and plan["waves"] == 1, n
        assert plan["grid"] <= 2 * SMS, n


@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_plan_at_latent_256_keeps_the_parent_waves(dtype):
    """At latent 256 a block's tile and two ring stages do not leave room
    for a second block on its SM, as before: the same 176 blocks at the
    cylinder, two waves of one block an SM."""
    plan = F.edge_plan(CYLINDER, 256, dtype)
    assert plan["blocks_per_sm"] == 1 and plan["grid"] == 176 and plan["waves"] == 2


@pytest.mark.parametrize("dtype,mb", [(torch.float32, 69.2060), (torch.bfloat16, 19.4642)])
def test_edge_plan_weight_bytes_per_launch(dtype, mb):
    """The weight bytes a cylinder launch copies from L2 (3 products, latent
    128): once per 64-edge block, 176 blocks x 3 products x the chunks of
    one."""
    plan = F.edge_plan(CYLINDER, 128, dtype)
    assert plan["l2_weight_bytes"] / 1e6 == pytest.approx(mb, abs=1e-4)
    assert plan["l2_weight_bytes"] == 176 * 3 * plan["chunks"] * plan["stage_bytes"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_round_on_the_cpu_is_the_plain_version(dtype):
    """The CPU wrapper updates e in place and returns the plain version's
    message (no weight stream read)."""
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=32,
                    hidden_layers=2, message_passing_steps=1)
    proc = init_mgn(cfg, torch.Generator().manual_seed(5), device="cpu")["processor"]
    em = F.round_params(F.cast_mlp(proc["edge_mlp"], dtype), 0)
    rng = np.random.default_rng(5)
    n, e_pad = 40, 130
    senders = torch.from_numpy(rng.integers(0, n, e_pad).astype(np.int32))
    receivers = torch.from_numpy(np.sort(rng.integers(0, n, e_pad)).astype(np.int32))
    ev = torch.from_numpy((rng.random(e_pad) > 0.1).astype(np.float32))[:, None].to(dtype)
    e0 = torch.from_numpy(rng.normal(size=(e_pad, 32)).astype(np.float32)).to(dtype) * ev
    p, q = F.edge_project_plain(torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
                                .to(dtype), em)
    e = e0.clone()
    msg = F.edge_round(e, p, q, senders, receivers, ev, em, None)
    ref_e, ref_msg = F.edge_round_plain(e0, p, q, senders, receivers, ev, em)
    assert torch.equal(msg, ref_msg) and torch.equal(e, ref_e)
    assert not msg[ev[:, 0] == 0].any()


@pytest.mark.parametrize("variant", k2_split.VARIANTS)
def test_k2_split_variant_patches_this_tree(variant):
    """Each of the probe's default variants applies to this tree's K2
    sources, every anchor once and inside the definition it targets, and
    changes only the files it names."""
    src = k2_split.sources()
    out = k2_split.patched(src, variant)
    touched = {name for name, *_ in k2_split.PATCHES[variant]}
    assert {n for n in src if out[n] != src[n]} == touched


@pytest.mark.parametrize("variant", k2_split.PARENT_VARIANTS)
def test_k2_split_parent_variant_refuses_this_tree(variant):
    """The variants that split the K2 on K4's EdgeBlock feed raise on this
    tree, whose K2 has a feed of its own, instead of patching K4's ring."""
    with pytest.raises(ValueError, match="anchor found 0 times in fused_round.cu"):
        k2_split.patched(k2_split.sources(), variant)


def test_k2_split_patch_outside_its_target_raises(monkeypatch):
    """A patch whose anchor lies in K4's ring (EdgeBlock) and not in the
    definition it names raises instead of timing an unchanged K2."""
    k4_wait = "      mbar_wait(&bar[cur % S], (cur / S) & 1);\n"
    monkeypatch.setitem(k2_split.PATCHES, "k4_ring",
                        [("edge_tile.cuh", k2_split._RING_FEED, k4_wait, "")])
    with pytest.raises(ValueError, match="outside"):
        k2_split.patched(k2_split.sources(), "k4_ring")


# --- on the card ----------------------------------------------------------------

def _k2_case(dtype, latent, n_edges, seed=0):
    """Seeded K2 inputs: n_edges rows, 10 % of them dead (edge_valid 0, the
    last node's row), P and Q the plain projections of a random v."""
    n = 1920
    cfg = MGNConfig(node_input_dim=9, edge_input_dim=3, output_dim=2, latent_size=latent,
                    hidden_layers=2, message_passing_steps=1)
    proc = init_mgn(cfg, torch.Generator().manual_seed(3), device="cuda")["processor"]
    em_all = F.cast_mlp(proc["edge_mlp"], dtype)
    em = F.round_params(em_all, 0)
    ws = F.weight_streams(em_all)[0][0]
    rng = np.random.default_rng(seed)
    dead = rng.random(n_edges) < 0.1
    receivers = np.sort(rng.integers(0, n - 1, n_edges)).astype(np.int32)
    receivers[dead] = n - 1
    senders = np.where(dead, n - 1, rng.integers(0, n - 1, n_edges)).astype(np.int32)
    ev = torch.from_numpy((~dead).astype(np.float32))[:, None].cuda().to(dtype)
    e0 = (torch.from_numpy(rng.normal(size=(n_edges, latent)).astype(np.float32)).cuda()
          .to(dtype) * ev).contiguous()
    v = torch.from_numpy(rng.normal(size=(n, latent)).astype(np.float32)).cuda().to(dtype)
    p, q = F.edge_project_plain(v, em)
    return (e0, p, q, torch.from_numpy(senders).cuda(), torch.from_numpy(receivers).cuda(), ev,
            em, ws)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_round_kernel_against_plain(cuda_device, dtype, latent):
    """K2 against its plain version at every row count, dead edges giving no
    message; a second run gives the same bits."""
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0.02, atol=0.05)
    for n in ROWS:
        e0, p, q, s, r, ev, em, ws = _k2_case(dtype, latent, n)
        before = F.edge_round.launches
        e = e0.clone()
        msg = F.edge_round(e, p, q, s, r, ev, em, ws)
        assert F.edge_round.launches == before + 1
        ref_e, ref_msg = F.edge_round_plain(e0, p, q, s, r, ev, em)
        torch.testing.assert_close(msg.float(), ref_msg.float(), **tol)
        torch.testing.assert_close(e.float(), ref_e.float(), **tol)
        assert not msg[ev[:, 0] == 0].any(), n
        e2 = e0.clone()
        msg2 = F.edge_round(e2, p, q, s, r, ev, em, ws)
        assert torch.equal(msg2, msg) and torch.equal(e2, e), n


@pytest.mark.requires_cuda
@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_edge_round_kernel_plan_is_edge_plan(cuda_device, dtype, latent):
    """The compiled kernel's own launch shape (mgn_edge_round_plan) is the
    one ops.fused.edge_plan computes."""
    lib = _build.library("fused_round")
    for n in ROWS:
        out = (ctypes.c_int * 5)()
        assert lib.mgn_edge_round_plan(F._DTYPE_CODES[dtype], latent, n, out) == 0
        plan = F.edge_plan(n, latent, dtype)
        assert list(out) == [plan[k] for k in ("col_groups", "stages", "threads", "smem",
                                               "grid")], n
