"""Port: the weight streams of the processor's kernels (``weight_streams``,
``csrc/stream_tile.cuh``) on the CPU.

- The ``defer_first`` form of the training stream is the full adjoint
  stream with each round's last two edge products (K4's ``W0_sᵀ`` and
  ``W0_rᵀ``, which that backward never reads) cut away.
- A model of the kernel's tile-to-output map, written from the kernel's
  index formulas (one block a 32 x 32 (f32) or 64 x 64 (bf16) tile of one
  ``(L, L)`` weight block, each task a 16-byte vector): every stream element is written exactly
  once and the map reproduces ``weight_streams_plain``; its shared-memory
  accesses meet no bank conflict at ``L >= 64``.
- Every image, decoded back to its ``(L, L)`` block (transposed where it is
  an adjoint's), holds the JAX package's weights (``init_mgn``) as
  ``params_from_jax`` carries them across.

The kernel itself is held against ``weight_streams_plain`` byte for byte on
the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""

import functools

import jax
import numpy as np
import pytest
import torch

from mgn_tpu.models.mgn import MGNConfig as JaxMGNConfig
from mgn_tpu.models.mgn import init_mgn as jax_init_mgn
from mgn_tpu_torch.convert import params_from_jax
from mgn_tpu_torch.ops import fused as F

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
LATENTS = [32, 64, 128, 256]
FORMS = {"serving": (False, False), "adjoint": (True, False), "defer": (True, True)}


@functools.lru_cache(maxsize=None)
def _jax_processor(latent, hidden, rounds, seed=0):
    cfg = JaxMGNConfig(node_input_dim=5, edge_input_dim=3, output_dim=2, latent_size=latent,
                       hidden_layers=hidden, message_passing_steps=rounds)
    return jax.tree.map(np.asarray, jax_init_mgn(jax.random.PRNGKey(seed), cfg)["processor"])


def _mlps(latent, hidden, rounds, dtype):
    proc = params_from_jax(_jax_processor(latent, hidden, rounds))
    return F.cast_mlp(proc["edge_mlp"], dtype), F.cast_mlp(proc["node_mlp"], dtype)


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


# --- the kernel's map, modelled -------------------------------------------------

RAW, HI, LO, ZERO = 0, 1, 2, 3


class _Shapes:
    """The compile-time shapes the kernel takes at latent L (StreamTile,
    EdgeTile's KC, NodeTile::PW, ProjLayout)."""

    def __init__(self, L, f32):
        self.L, self.f32 = L, f32
        self.kT = min(L, 32 if f32 else 64)
        self.tiles = L // self.kT
        self.E = 4 if f32 else 8
        self.V = self.kT // self.E
        self.swz_mask = min(self.V, 8) - 1
        self.KC = min(32 if f32 else 64, L)
        self.chunk = 2 * L * self.KC if f32 else L * (self.KC + 8)
        self.prod = (L // self.KC) * self.chunk
        self.PW = L + 8
        self.CN = min(L, 64)
        self.image = L * (self.CN + 8)
        self.slices = L // self.CN

    def swz(self, r):
        return (r ^ ((r >> 3) << 1)) & self.swz_mask

    def at(self, r, c):
        """StreamTile::at: where tile element (r, c) lies in shared memory."""
        return r * self.kT + ((c // self.E) ^ self.swz(r)) * self.E + c % self.E


class _Model:
    """Runs the kernel's map: ``write`` for each element a task stores, with
    the (row, column) of the block's tile it came from (None for padding)
    and what the store makes of it (RAW, the TF32 HI or LO part, ZERO); and
    ``access`` for each warp instruction that reads or writes the tile."""

    def __init__(self, S, sizes, rounds):
        self.S = S
        self.out = {k: np.full((rounds * n, 2), -1, np.int64) for k, n in sizes.items()}
        self.kind = {k: np.full(rounds * n, -1, np.int64) for k, n in sizes.items()}
        self.count = {k: np.zeros(rounds * n, np.int64) for k, n in sizes.items()}
        self.smem = []

    def write(self, stream, index, rows, cols, kind, base):
        index = np.asarray(index).ravel()
        np.add.at(self.count[stream], index, 1)
        self.kind[stream][index] = kind
        if rows is not None:
            self.out[stream][index, 0] = base + np.asarray(rows).ravel() * self.S.L
            self.out[stream][index, 1] = np.asarray(cols).ravel()

    def access(self, words, width):
        """One warp instruction per 32 consecutive tasks: ``words`` (tasks,)
        first word address of each lane, ``width`` words a lane reads."""
        words = np.asarray(words)
        for w0 in range(0, len(words), 32):
            self.smem.append((words[w0:w0 + 32], width))


def _row_image(m, stream, img, tr, tc, CW, trans, base):
    """row_image: rows of M (W^T where trans) in slices of CW columns, each
    row padded to CW + 8."""
    S = m.S
    kT, E, V, P = S.kT, S.E, S.V, CW + 8
    i0, j0 = (tc if trans else tr) * kT, (tr if trans else tc) * kT
    out = img + (j0 // CW) * (S.L * P) + i0 * P + j0 % CW
    e = np.arange(E)
    wpe = 1 if S.f32 else 2  # values a 32-bit word holds
    if not trans:
        q = np.arange(kT * V)
        i, c = q // V, q % V
        idx = out + i[:, None] * P + c[:, None] * E + e
        m.write(stream, idx, i[:, None] + 0 * e, c[:, None] * E + e, RAW, base)
        m.access(S.at(i, c * E) // wpe, 4)
    elif S.f32:
        q = np.arange(kT * V)
        lane, w = q & 31, q >> 5
        i = (w % (kT // 8)) * 8 + (lane & 7)
        c = (w // (kT // 8)) * 4 + (lane >> 3)
        idx = out + i[:, None] * P + 4 * c[:, None] + e
        m.write(stream, idx, 4 * c[:, None] + e, i[:, None] + 0 * e, RAW, base)
        for j in range(4):
            m.access(S.at(4 * c + j, i), 1)
    else:
        q = np.arange(kT * V // 2)
        lane, w = q & 31, q >> 5
        i = (w % (kT // 16)) * 16 + 2 * (lane & 7)
        c = (w // (kT // 16)) * 4 + (lane >> 3)
        for h in range(2):  # rows i and i + 1 of M: the word's low, then high halves
            idx = out + (i[:, None] + h) * P + 8 * c[:, None] + e
            m.write(stream, idx, 8 * c[:, None] + e, i[:, None] + h + 0 * e, RAW, base)
        for j in range(8):
            m.access(S.at(8 * c + j, i) // 2, 1)
    if j0 % CW + kT == CW:
        pad = 8 // E
        q = np.arange(kT * pad)
        idx = out + (q // pad)[:, None] * P + kT + (q % pad)[:, None] * E + e
        m.write(stream, idx, None, None, ZERO, base)


def _edge_image(m, prod, tr, tc, trans_b, base):
    """edge_image: one product B (W^T where trans_b) of the edge stream."""
    S = m.S
    if not S.f32:
        _row_image(m, "edge", prod, tr, tc, S.KC, not trans_b, base)
        return
    kT, KC = S.kT, S.KC
    KQ, per = KC // 4, S.L * KC
    k0, n0 = (tc if trans_b else tr) * kT, (tr if trans_b else tc) * kT
    q = np.arange(kT * kT // 4)
    lane, w = q & 31, q >> 5
    kq, n, cc = w % KQ, (w // KQ) % (kT // 32) * 32 + lane, w // (KQ * (kT // 32))
    k = cc * KC + 4 * kq
    j = np.arange(4)
    chunk = prod + ((k0 + cc * KC) // KC) * 2 * per
    off = (((n0 + n) >> 3) * KQ + kq) * 32 + (lane & 7) * 4
    rows, cols = (n[:, None] + 0 * j, k[:, None] + j) if trans_b else (k[:, None] + j,
                                                                       n[:, None] + 0 * j)
    for plane, kind in ((0, HI), (per, LO)):
        m.write("edge", (chunk + plane + off)[:, None] + j, rows, cols, kind, base)
    if trans_b:
        m.access(S.at(n, k), 4)
    else:
        for jj in range(4):
            m.access(S.at(k + jj, n), 1)


def _run_model(S, n_edge_layers, n_node_layers, rounds, form, sizes, bases):
    """The kernel's grid: per round, per weight block (the edge MLP's W0 e,
    s, r blocks and hidden layers, then the node MLP's W0 v, agg blocks and
    hidden layers), per tile; each block loads its tile, then writes the
    images it feeds."""
    m = _Model(S, sizes, rounds)
    L = S.L
    n_edge = 2 + n_edge_layers if n_edge_layers else 0
    n_node = 1 + n_node_layers if n_node_layers else 0
    for r in range(rounds):
        for blk in range(n_edge + n_node):
            for tile in range(S.tiles ** 2):
                tr, tc = tile // S.tiles, tile % S.tiles
                edge = blk < n_edge
                b = blk if edge else blk - n_edge
                parts = 3 if edge else 2
                layer, part = (0, b) if b < parts else (b - parts + 1, 0)
                nl = n_edge_layers if edge else n_node_layers
                H = nl - 1
                # the tile's source: (stack of the MLP's layer, first row of the tile)
                base = (bases[("edge" if edge else "node", layer)]
                        + ((r * (parts if layer == 0 else 1) + part) * L + tr * S.kT) * L
                        + tc * S.kT)
                q = np.arange(S.kT * S.V)
                m.access(S.at(q // S.V, q % S.V * S.E) // (1 if S.f32 else 2), 4)
                if edge:
                    n_prod = {"serving": nl, "adjoint": 2 * nl + 2, "defer": 2 * nl}[form]
                    oe = r * n_prod * S.prod
                    if layer > 0 or part == 0:
                        _edge_image(m, oe + layer * S.prod, tr, tc, False, base)
                        if form != "serving":
                            _edge_image(m, oe + (nl + (H if layer == 0 else H - layer)) * S.prod,
                                        tr, tc, True, base)
                    else:
                        k_part = S.slices * S.image
                        op = r * (2 if form == "serving" else 4) * k_part
                        _row_image(m, "proj", op + (part - 1) * k_part, tr, tc, S.CN, False, base)
                        if form != "serving":
                            _row_image(m, "proj", op + (part + 1) * k_part, tr, tc, S.CN, True,
                                       base)
                        if form == "adjoint":
                            _edge_image(m, oe + (nl + H + part) * S.prod, tr, tc, True, base)
                else:
                    rows = (1 + nl) * L
                    on = r * (1 if form == "serving" else 2) * rows * S.PW
                    _row_image(m, "node", on + (part if layer == 0 else layer + 1) * L * S.PW,
                               tr, tc, L, False, base)
                    if form != "serving":
                        _row_image(m, "node", on + (rows + (H + part if layer == 0 else H - layer)
                                                    * L) * S.PW, tr, tc, L, True, base)
    return m


def _sources(em, nm):
    """The cast weight stacks flattened into one vector, and where each
    (MLP, layer) stack starts in it."""
    flat, bases, at = [], {}, 0
    for name, mlp in (("edge", em), ("node", nm)):
        if mlp is None:
            continue
        for layer, w in enumerate(mlp["w"]):
            bases[(name, layer)] = at
            flat.append(w.reshape(-1))
            at += w.numel()
    return torch.cat(flat), bases


def _modelled_streams(em, nm, adjoint, defer):
    """What the kernel writes, by the model: (streams, model)."""
    first = (em or nm)["w"][0]
    dtype, rounds, L = first.dtype, first.shape[0], first.shape[-1]
    S = _Shapes(L, dtype == torch.float32)
    form = "defer" if adjoint and defer else "adjoint" if adjoint else "serving"
    sizes = dict(zip(("edge", "node", "proj"), F._stream_sizes(
        L, dtype, len(em["w"]) if em else 0, len(nm["w"]) if nm else 0, adjoint, defer)))
    flat, bases = _sources(em, nm)
    m = _run_model(S, len(em["w"]) if em else 0, len(nm["w"]) if nm else 0, rounds, form,
                   sizes, bases)
    out = {}
    for name in ("edge", "node", "proj"):
        if (nm if name == "node" else em) is None:
            out[name] = None
            assert not m.count[name].any()
            continue
        assert (m.count[name] == 1).all(), f"{name}: elements written {set(m.count[name])}"
        src = torch.from_numpy(m.out[name][:, 0] + m.out[name][:, 1])
        kind = torch.from_numpy(m.kind[name])
        vals = flat[src.clamp(min=0)]
        if S.f32:
            hi = F._tf32(vals)
            vals = torch.where(kind == HI, hi, torch.where(kind == LO, F._tf32(vals - hi), vals))
        vals = torch.where(kind == ZERO, torch.zeros_like(vals), vals)
        out[name] = vals.view(rounds, -1)
    return (out["edge"], out["node"], out["proj"]), m


def _conflicts(model):
    """The most distinct words any bank serves in one pass of an access:
    32-bit accesses in one pass of the warp, 16-byte ones in four of 8
    lanes."""
    worst = 1
    for words, width in model.smem:
        lanes = 32 if width == 1 else 8
        for p0 in range(0, len(words), lanes):
            w = np.unique((words[p0:p0 + lanes, None] + np.arange(width)).ravel())
            worst = max(worst, int(np.bincount(w % 32).max()))
    return worst


# --- tests -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("hidden", [1, 2, 3])
def test_defer_stream_is_the_full_stream_cut(dtype, latent, hidden):
    """The defer_first form's edge stream is the full adjoint stream with
    each round's last two products (K4's W0_s^T and W0_r^T) cut away, so
    every product K4 still reads keeps its offset in the round's row; the
    node and projection streams are the full form's."""
    rounds = 2
    em, nm = _mlps(latent, hidden, rounds, dtype)
    full = F.weight_streams_plain(em, nm, adjoint=True)
    cut = F.weight_streams_plain(em, nm, adjoint=True, defer=True)
    n_layers = hidden + 1
    per_prod = F._stream_sizes(latent, dtype, 1, 0)[0]
    assert full[0].shape[1] == (2 * n_layers + 2) * per_prod
    want = full[0].view(rounds, 2 * n_layers + 2, per_prod)[:, :-2].reshape(rounds, -1)
    assert torch.equal(_bits(cut[0]), _bits(want))
    assert cut[0].shape[1] == F._stream_sizes(latent, dtype, n_layers, 0, True, True)[0]
    assert torch.equal(_bits(cut[1]), _bits(full[1])) and torch.equal(_bits(cut[2]),
                                                                      _bits(full[2]))
    # the forward's leading part of a row is the serving stream's row in every form
    serving = F.weight_streams_plain(em, nm)[0]
    assert torch.equal(_bits(cut[0][:, :serving.shape[1]]), _bits(serving))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("latent", LATENTS)
@pytest.mark.parametrize("form", list(FORMS))
def test_tile_map_writes_each_element_once_as_the_plain_streams(dtype, latent, form):
    """The model of the kernel's grid and tasks covers every element of all
    three streams exactly once, and what it writes is weight_streams_plain's
    bits: two rounds, hidden layers 1-3 by width."""
    hidden = 1 + LATENTS.index(latent) % 3
    em, nm = _mlps(latent, hidden, 2, dtype)
    got, _ = _modelled_streams(em, nm, *FORMS[form])
    want = F.weight_streams_plain(em, nm, *FORMS[form])
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["edge", "node"])
def test_tile_map_with_one_mlp(dtype, which):
    """A launch for one MLP (the other None) writes its streams alone: the
    edge MLP's edge and projection streams, or the node MLP's node stream;
    one round and 15."""
    for rounds, hidden in ((1, 3), (15, 1)):
        em, nm = _mlps(64, hidden, rounds, dtype)
        em, nm = (em, None) if which == "edge" else (None, nm)
        for adjoint, defer in FORMS.values():
            got, _ = _modelled_streams(em, nm, adjoint, defer)
            want = F.weight_streams_plain(em, nm, adjoint, defer)
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("latent", [64, 128])
def test_tile_accesses_meet_no_bank_conflict(dtype, latent):
    """Every shared-memory access of the modelled kernel (the tile's loads
    in, the row reads, the column reads of the transposed and core-matrix
    images) is one pass at L >= 64: the XOR swizzle spreads them over the
    32 banks; without it (swz = 0) the column reads would conflict."""
    em, nm = _mlps(latent, 2, 1, dtype)
    _, model = _modelled_streams(em, nm, True, False)
    assert _conflicts(model) == 1
    plain = _Shapes(latent, dtype == torch.float32)
    plain.swz = lambda r: 0
    flat, bases = _sources(em, nm)
    sizes = dict(zip(("edge", "node", "proj"), F._stream_sizes(latent, dtype, 3, 3, True)))
    assert _conflicts(_run_model(plain, 3, 3, 1, "adjoint", sizes, bases)) > 1


def _decode_rows(stream, rounds, rows, cols, pitch):
    return stream.view(rounds, rows, pitch)[:, :, :cols]


def _decode_edge(stream, rounds, n_prod, L, f32):
    """Each product of the edge stream as B[k][n] (f32: its high and low
    TF32 planes apart), from the core-matrix order or the padded rows."""
    kc = min(32 if f32 else 64, L)
    chunks = stream.view(rounds, n_prod, L // kc, -1)
    n, k = np.meshgrid(np.arange(L), np.arange(kc), indexing="ij")
    if f32:
        off = torch.from_numpy((((n >> 3) * (kc >> 2) + (k >> 2)) * 32 + (n & 7) * 4
                                + (k & 3)).reshape(-1))
        planes = [chunks[..., off + p * L * kc] for p in (0, 1)]
    else:
        planes = [chunks[..., torch.from_numpy((n * (kc + 8) + k).reshape(-1))]]
    # [r, p, c, n, k] -> [r, p, k, n]
    return [x.view(rounds, n_prod, L // kc, L, kc).permute(0, 1, 2, 4, 3)
            .reshape(rounds, n_prod, L, L) for x in planes]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("latent", LATENTS)
def test_every_image_decodes_to_the_jax_weights(dtype, latent):
    """Every image of the three streams in the full adjoint form, decoded
    back to its (L, L) block (transposed where an adjoint's), holds the JAX
    package's init_mgn weights carried across by params_from_jax and cast to
    the compute dtype: bf16 exactly; f32 as the TF32 split hi = rna(w), lo =
    rna(w - hi), computed here in numpy from the JAX arrays."""
    rounds, hidden, L = 2, 2, latent
    f32 = dtype == torch.float32
    jproc = _jax_processor(latent, hidden, rounds)
    em, nm = _mlps(latent, hidden, rounds, dtype)
    edge, node, proj = F.weight_streams_plain(em, nm, adjoint=True)

    def cast(x):  # the JAX weights in the compute dtype, as f32 values
        t = torch.from_numpy(np.array(x, np.float32))
        return t.to(dtype).float()

    def tf32(x):  # round to nearest, ties away from zero, to 10 mantissa bits
        b = np.ascontiguousarray(x.numpy()).view(np.uint32).astype(np.uint64)
        return torch.from_numpy((((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF)
                                .astype(np.uint32).view(np.float32))

    def blocks(mlp, parts):
        w = [cast(x) for x in jproc[mlp]["w"]]
        return [w[0][:, p * L:(p + 1) * L] for p in range(parts)], w[1:]

    e0, eh = blocks("edge_mlp", 3)
    n0, nh = blocks("node_mlp", 2)
    T = lambda x: x.transpose(-1, -2)

    def same(got, want):
        if f32:
            hi = tf32(want)
            assert torch.equal(got[0], hi) and torch.equal(got[1], tf32(want - hi))
        else:
            assert torch.equal(got[0], want)

    # the edge stream: K2's products, then K4's
    products = [e0[0], *eh] + [T(x) for x in reversed(eh)] + [T(x) for x in e0]
    planes = _decode_edge(edge.float(), rounds, len(products), L, f32)
    for i, want in enumerate(products):
        same([p[:, i] for p in planes], want)
    # the node stream: K3's rows, then K5's
    rows = _decode_rows(node.float(), rounds, 2 * (2 + hidden) * L, L, L + 8)
    want = torch.cat([*n0, *nh] + [T(x) for x in reversed(nh)] + [T(x) for x in n0], 1)
    assert torch.equal(rows, want)
    # the projection stream: K7's W0 s and r blocks, then K8's, in column slices
    cn = min(L, 64)
    images = proj.float().view(rounds, 4, L // cn, L, cn + 8)[..., :cn]
    for i, want in enumerate([e0[1], e0[2], T(e0[1]), T(e0[2])]):
        got = images[:, i].permute(0, 2, 1, 3).reshape(rounds, L, L)
        assert torch.equal(got, want)
