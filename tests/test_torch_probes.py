"""K9 and K10, the port's counterparts of the two TPU probes (P7
``benchmarks/probe_dyngather_tpu.py``, P8 ``benchmarks/probe_onehot_dtype_tpu.py``),
against the JAX kernels those probes build.

Each probe's ``main()`` runs once per module at a small size in interpret
mode, with ``pallas_call`` replaced by a recorder that keeps every kernel it
builds (``main`` builds them in a closure and returns nothing), its
``_HERE`` pointed into a temporary directory (its results file and P8's
``.jax_cache`` land there) and its size globals patched; the kernels read
those globals when they are traced, so the patches last for the module.
The recorder runs P7's kernels with zero-filled scratch
(``InterpretParams(uninitialized_memory="zero")``): the TPU kernel never
zeroes its accumulator (ROADMAP C10), and plain ``interpret=True`` fills it
with NaN.  The captured kernels are then called on the tests' own inputs.

The tests marked ``requires_cuda`` hold the kernels against their plain
versions on the card and import nothing of JAX: on the GPU machine run
``python -m pytest --noconftest tests/test_torch_probes.py -q -m requires_cuda``.
"""

import os

import numpy as np
import pytest
import torch

from mgn_tpu_torch.ops import onehot as O
from mgn_tpu_torch.probes import dyngather, onehot_dtype
from tests.torch_support import cuda_device  # noqa: F401  (fixture)

P7_SIZES = dict(CHUNK=64, BAND=32, C=3, R=2, N=256)
P8_SIZES = dict(BAND=32, CHUNK=64, ROUNDS=3)
P7_NAMES = ("onehot_f32", "onehot_bf16", "dyn_f32", "dyn_bf16")  # the JAX probe's order
L = 128


@pytest.fixture(scope="module")
def jax_probes(tmp_path_factory):
    """``{"p7": {name: (kernel, args, kwargs)}, "p8": {...}, "pallas_call",
    "interpret_zero"}``: every kernel the two JAX probes built."""
    jax = pytest.importorskip("jax")
    from jax._src import compilation_cache
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from benchmarks import probe_dyngather_tpu as p7
    from benchmarks import probe_onehot_dtype_tpu as p8

    real = pl.pallas_call
    zero = pltpu.InterpretParams(uninitialized_memory="zero")
    built = []

    def recorder(kernel, *args, **kwargs):
        built.append((kernel, args, kwargs))
        if kwargs.get("interpret") is True:
            kwargs = dict(kwargs, interpret=zero)
        return real(kernel, *args, **kwargs)

    here = str(tmp_path_factory.mktemp("probes") / "sub")
    cache_dir = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recorder)
        for mod, sizes in ((p7, P7_SIZES), (p8, P8_SIZES)):
            mp.setattr(mod, "_HERE", here)
            for name, value in sizes.items():
                mp.setattr(mod, name, value)
        try:
            p7.main()
            n7 = len(built)
            p8.main()
        finally:
            jax.config.update("jax_compilation_cache_dir", cache_dir)
            compilation_cache.reset_cache()
        assert n7 == 4 and len(built) == 12, [b[0] for b in built]
        assert os.path.isdir(os.path.join(os.path.dirname(here), ".jax_cache"))
        yield {"p7": dict(zip(P7_NAMES, built[:4])),
               "p8": dict(zip(onehot_dtype.VARIANTS, built[4:])),
               "pallas_call": real, "interpret_zero": zero}


def p7_case(seed=5):
    """Inputs within both variants' windows: rel in [0, BAND), starts
    multiples of 32 with starts + max(BAND, CHUNK) <= N."""
    s = P7_SIZES
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, s["BAND"], (s["C"], s["CHUNK"])).astype(np.int32)
    starts = np.array([0, 96, s["N"] - s["CHUNK"]], np.int32)
    v = rng.normal(size=(s["N"], L)).astype(np.float32)
    return rel, starts, v


def run_p7(jax_probes, name, rel, starts, v, interpret=None):
    import jax.numpy as jnp

    kernel, args, kwargs = jax_probes["p7"][name]
    kwargs = dict(kwargs, interpret=jax_probes["interpret_zero"] if interpret is None
                  else interpret)
    f = jax_probes["pallas_call"](kernel, *args, **kwargs)
    dtype = jnp.float32 if name.endswith("f32") else jnp.bfloat16
    return np.asarray(f(jnp.asarray(starts), jnp.asarray(v, dtype), jnp.asarray(rel),
                        jnp.asarray(np.ascontiguousarray(rel.T))))


def numpy_window_sum(rel, starts, v, rounds):
    out = np.zeros((rel.shape[1], v.shape[1]), np.float32)
    for _ in range(rounds):
        for c in range(rel.shape[0]):
            out += v[starts[c] + rel[c]]
    return out


@pytest.mark.parametrize("name", P7_NAMES)
def test_p7_kernel_equals_window_gather_plain(jax_probes, name):
    rel, starts, v = p7_case()
    got = run_p7(jax_probes, name, rel, starts, v)
    dtype = torch.float32 if name.endswith("f32") else torch.bfloat16
    win = O.make_window(rel, starts, P7_SIZES["BAND"], "cpu")
    vt = torch.from_numpy(v).to(dtype)
    plain = O.window_gather_plain(vt, win, P7_SIZES["R"]).numpy()
    np.testing.assert_array_equal(got, plain)
    variant = dyngather.COMBOS[name][0]
    np.testing.assert_array_equal(O.window_gather(vt, win, P7_SIZES["R"], variant).numpy(), plain)


def test_p7_kernel_never_zeroes_its_sum(jax_probes):
    """C10: under plain interpret=True the TPU kernel's unzeroed scratch is
    NaN and so is its output; the port's sum starts from zero."""
    rel, starts, v = p7_case(6)
    raw = run_p7(jax_probes, "onehot_f32", rel, starts, v, interpret=True)
    assert np.isnan(raw).all()
    win = O.make_window(rel, starts, P7_SIZES["BAND"], "cpu")
    port = O.window_gather(torch.from_numpy(v), win, P7_SIZES["R"]).numpy()
    assert np.isfinite(port).all()
    np.testing.assert_array_equal(port, numpy_window_sum(rel, starts, v, P7_SIZES["R"]))


@pytest.mark.parametrize("name", onehot_dtype.VARIANTS)
def test_p8_kernel_against_onehot_pair_plain(jax_probes, name):
    """int8 x int8 sums integers, so bitwise; the others gather exactly and
    sum the scatter in f32 in another order: max |d| <= 1e-6 max |ref|."""
    import jax.numpy as jnp

    s = P8_SIZES
    rng = np.random.default_rng(11)
    rel = rng.integers(0, s["BAND"], s["CHUNK"]).astype(np.int32)
    band = (4 * rng.standard_normal((s["BAND"], L))).astype(np.float32)
    msg = (4 * rng.standard_normal((s["CHUNK"], L))).astype(np.float32)
    kernel, args, kwargs = jax_probes["p8"][name]
    f = jax_probes["pallas_call"](kernel, *args, **kwargs)
    ref = np.asarray(f(jnp.asarray(rel)[None], jnp.asarray(band), jnp.asarray(msg)))
    value = onehot_dtype.VARIANTS[name][1]
    inputs = O.make_pair_inputs(rel, band, msg, "cpu")
    got = O.onehot_pair(inputs, s["ROUNDS"], value).numpy()
    np.testing.assert_array_equal(got, O.onehot_pair_plain(inputs, s["ROUNDS"], value).numpy())
    if value == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_p7_run_reads_one_v():
    """C11: every variant gathers from the same v (the TPU probe draws a new
    one per variant), so dyn_f32 is onehot_f32 exactly and the bf16
    variants equal each other; the CPU record holds no timing."""
    rec = dyngather.run(chunk=64, band=32, chunks=3, rounds=2, n=256, device="cpu")
    assert rec["backend"] == "cpu" and rec["device"] is None
    assert rec["rel_err_vs_onehot_f32"]["dyn_f32"] == 0.0
    assert 0 < rec["rel_err_vs_onehot_f32"]["onehot_bf16"] < 2 ** -7
    outs = rec.pop("outputs")
    assert torch.equal(outs["onehot_bf16"], outs["dyn_bf16"])
    assert torch.equal(outs["onehot_f32"], outs["dyn_f32"])
    flat = repr(rec)
    for key in ("us_per_gather", "ms_total", "bound_us", "iters"):
        assert key not in flat
    rel, starts, v = dyngather.inputs(64, 32, 3, 256, L, 0)
    np.testing.assert_array_equal(outs["onehot_f32"].numpy(), numpy_window_sum(rel, starts, v, 2))


def test_p8_run_routes_and_outputs():
    rec = onehot_dtype.run(band=32, chunk=64, rounds=3, device="cpu")
    outs = rec.pop("outputs")
    routes = {name: r["route"] for name, r in rec["variants"].items()}
    assert len(set(routes.values())) == 3
    for name, (_, value) in onehot_dtype.VARIANTS.items():
        assert routes[name] == onehot_dtype.ROUTES[value]
        same = next(n for n, (_, val) in onehot_dtype.VARIANTS.items() if val == value)
        assert torch.equal(outs[name], outs[same])
    assert rec["variants"]["int8_mixed"]["max_abs_diff_vs_bf16"] == 0.0
    assert "max_abs_diff_vs_bf16" not in rec["variants"]["int8_int8"]
    assert rec["flops_per_round"] == 2 * L * 32 * (32 + 64)
    assert "us_per_round" not in repr(rec)


def test_probes_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dyngather.run(chunk=64, band=32, chunks=3, rounds=2, n=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        onehot_dtype.run(band=32, chunk=64, rounds=3)


def test_probe_main_prints_one_json_line(tmp_path, capsys):
    out = tmp_path / "rec.json"
    assert dyngather.main(["--chunk", "64", "--band", "32", "--chunks", "3", "--rounds", "2",
                           "--n", "256", "--only", "onehot_f32,dyn_f32", "--device", "cpu",
                           "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip()
    assert "\n" not in line and out.read_text().strip() == line
    import json

    rec = json.loads(line)
    assert set(rec["rel_err_vs_onehot_f32"]) == {"dyn_f32"} and "onehot_bf16" not in rec


def test_make_window_refuses_reads_outside_the_window():
    rel = np.zeros((2, 64), np.int32)
    with pytest.raises(ValueError, match="0 <= rel < band"):
        O.make_window(rel + 32, [0, 64], 32, "cpu")
    with pytest.raises(ValueError, match="starts >= 0"):
        O.make_window(rel, [0, -32], 32, "cpu")
    win = O.make_window(rel, [0, 64], 32, "cpu")
    assert win.rows == 128  # max(starts) + max(band, chunk)
    with pytest.raises(ValueError, match="N >= 128"):
        O.window_gather(torch.zeros((127, L)), win, 1)
    with pytest.raises(ValueError, match="variant"):
        O.window_gather(torch.zeros((128, L)), win, 1, "dyn")


def test_make_pair_inputs_checks_rel_and_the_int8_range():
    rel = np.arange(64, dtype=np.int32) % 32
    band, msg = np.zeros((32, L), np.float32), np.zeros((64, L), np.float32)
    with pytest.raises(ValueError, match="0 <= rel < band"):
        O.make_pair_inputs(rel + 1, band, msg, "cpu")
    msg[3, 5] = 128.5
    inputs = O.make_pair_inputs(rel, band, msg, "cpu")
    assert not inputs.int8_exact
    with pytest.raises(ValueError, match="int8"):
        O.onehot_pair(inputs, 1, "int8")
    O.onehot_pair(inputs, 1, "bf16")


# --- on the card -----------------------------------------------------------------

P7_CARD_CASES = [dict(chunk=1024, band=384, chunks=11, rounds=15, n=2048),  # P7's defaults
                 dict(chunk=80, band=64, chunks=3, rounds=2, n=256)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", P7_CARD_CASES, ids=["defaults", "small"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", O.WINDOW_VARIANTS)
def test_window_gather_kernel_bitwise(cuda_device, variant, dtype, case):
    rel, starts, v = dyngather.inputs(case["chunk"], case["band"], case["chunks"], case["n"],
                                      L, 3)
    win = O.make_window(rel, starts, case["band"], cuda_device)
    vt = torch.from_numpy(v).to(cuda_device).to(dtype)
    before = O.window_gather.launches
    out = O.window_gather(vt, win, case["rounds"], variant)
    assert O.window_gather.launches == before + 1
    torch.testing.assert_close(out, O.window_gather_plain(vt, win, case["rounds"]),
                               rtol=0, atol=0)


P8_CARD_CASES = [dict(band=512, chunk=1024, rounds=200), dict(band=32, chunk=96, rounds=5)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", P8_CARD_CASES, ids=["defaults", "small"])
@pytest.mark.parametrize("name", onehot_dtype.VARIANTS)
def test_onehot_pair_kernel(cuda_device, name, case):
    rng = np.random.default_rng(4)
    rel = rng.integers(0, case["band"], case["chunk"]).astype(np.int32)
    band = (4 * rng.standard_normal((case["band"], L))).astype(np.float32)
    msg = (4 * rng.standard_normal((case["chunk"], L))).astype(np.float32)
    inputs = O.make_pair_inputs(rel, band, msg, cuda_device)
    value = onehot_dtype.VARIANTS[name][1]
    before = O.onehot_pair.launches
    out = O.onehot_pair(inputs, case["rounds"], value)
    assert O.onehot_pair.launches == before + 1
    ref = O.onehot_pair_plain(inputs, case["rounds"], value)
    if value == "int8":
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
