"""The shard probes of the port (``nsol_tpu_torch/parallel/shard_probe.py``,
``csrc/probes.cu``) against the Pallas probes of
``benchmarks/shard_pallas_diag*.py``.

The scripts are imported by file path; their module constants (``SHAPE``,
``ZB``, ``R``, ``INNER``) are set on the module objects, and the three
``jax.config`` values they set on import are put back. Their kernels run
under ``force_tpu_interpret_mode`` on the CPU: ``diag2.triv``,
``diag4.dma_kernel``, ``diag6.make_variant`` and ``diag7.pallas_matmul``.
The kernels that are closures inside a script's ``main`` (``diag.py``,
``diag3.py``, ``diag5.py``) are held to the same expression in ``jnp``.
Inputs come from numpy seeds. Tolerances:

* the scaling and window forms: exact (one float32 product a voxel);
* "HIGHEST" products: max |Δ| ≤ 1e-6 · max |ref| (float32 sums of up to
  256 products in another order);
* "DEFAULT" products: on the CPU XLA computes DEFAULT in full float32,
  while the port rounds both inputs to bfloat16 as the TPU's matrix unit
  does. So the port is held to the CPU's float32 result within the bound
  of that rounding (2⁻⁷ · Σ|x||m| per output, each input off by at most
  2⁻⁸ of itself), and to the Pallas kernel fed the bf16-rounded inputs
  within 1e-6 · max |ref|.

The ``cuda``-marked cases hold each kernel to its plain version on the card
(K1 and K2 bit for bit, K3 "HIGHEST" within 1e-5 · max |ref| of the
float64 product and "DEFAULT" within 1e-6 · max |ref| of its plain version,
past 384 products a sum of the float64 sum of the bf16-rounded inputs) and
a short probe run's launch counts; they skip on a host without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_shard_probe.py
"""

import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nsol_tpu_torch.parallel import mesh as M  # noqa: E402
from nsol_tpu_torch.parallel import shard_probe as SP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the ``jax.config`` values the scripts set on import
JAX_CONFIG = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes")
SHAPES = ((16, 16, 128), (16, 256, 256))
TINY = (16, 16, 128)
HIGHEST_TOL = 1e-6
DEFAULT_TOL = 1e-6


@pytest.fixture(scope="module")
def diag():
    """``{2: diag2, 4: diag4, 6: diag6, 7: diag7}``, the probe scripts as
    modules."""
    jax = pytest.importorskip("jax")
    saved = {k: getattr(jax.config, k) for k in JAX_CONFIG}
    mods = {}
    try:
        for n in (2, 4, 6, 7):
            path = os.path.join(REPO, "benchmarks",
                                "shard_pallas_diag%d.py" % n)
            spec = importlib.util.spec_from_file_location(
                "shard_pallas_diag%d" % n, path)
            mods[n] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[n])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def _interpret():
    pltpu = pytest.importorskip("jax.experimental.pallas.tpu")
    return pltpu.force_tpu_interpret_mode()


def _volume(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# ----------------------------------------------------- K1 and K2, plain --

@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scale_plain_matches_diag2_triv(diag, shape):
    """``diag2.py::triv`` (2·x over z-blocks of 8) in interpret mode, bit
    for bit."""
    jnp = pytest.importorskip("jax.numpy")
    x = _volume(shape, 1)
    with _interpret():
        want = np.asarray(diag[2].triv(shape, 8)(jnp.asarray(x)))
    got = SP.probe_scale(_t(x), 2.0, 8).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("factor", [2.0, SP.SCALE])
def test_scale_plain_matches_closure_kernels(factor):
    """The kernels inside ``main`` of ``diag.py`` (2·x, :68), ``diag3.py``
    and ``diag4.py`` (1.0000001·x, :48, :90): their expression
    ``x_ref[:] * factor`` in ``jnp``, bit for bit, the factor a number or
    (``diag4.py``'s SMEM input) a float32 tensor."""
    jnp = pytest.importorskip("jax.numpy")
    x = _volume(TINY, 2)
    want = np.asarray(jnp.asarray(x) * factor)
    assert np.array_equal(SP.probe_scale(_t(x), factor).numpy(), want)
    s = torch.full((1, 1), factor, dtype=torch.float32)
    assert np.array_equal(SP.probe_scale(_t(x), s).numpy(), want)


@pytest.mark.parametrize("with_smem", [False, True])
def test_window_plain_matches_diag4_dma_kernel(diag, with_smem):
    """``diag4.py::dma_kernel(ANY, with_smem)`` (the manual DMA of each
    z-block, its factor an immediate or an SMEM input) against K2 at halo
    0, one slot, the factor a number or a float32 tensor, bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    pl = pytest.importorskip("jax.experimental.pallas")
    d4 = diag[4]
    d4.SHAPE, d4.ZB = TINY, 8
    x = _volume(TINY, 3)
    with _interpret():
        want = np.asarray(d4.dma_kernel(pl.ANY, with_smem)(jnp.asarray(x)))
    s = torch.full((1, 1), SP.SCALE, dtype=torch.float32) if with_smem \
        else SP.SCALE
    got = SP.probe_window_scale(_t(x), s, 8, 0, 1).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_halo_variants_match_diag5_expressions(name):
    """``diag5.py``'s g1 (:51-53, the concatenation and the centre scaled)
    and g2 (:68-74, the kernel's ``ext[R:R + ZB] * 1.0000001`` over the
    concatenated input): the same in ``jnp``, bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    c = jnp.asarray(_volume(TINY, 4))
    r = SP.R
    ext = jnp.concatenate([c[-r:], c, c[:r]], axis=0)
    want = np.asarray(ext[r:-r] * SP.SCALE)
    got = SP.apply_variant(name, _t(c)).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------------ K3, plain --

@pytest.mark.parametrize("name,matmuls,double_buf",
                         [("h1", True, False), ("h2", False, True),
                          ("h3", True, True)])
def test_diag6_variants_match_make_variant(diag, name, matmuls, double_buf):
    """``diag6.py::make_variant`` (its scan of one step: the concatenated
    halo, the window DMA single- or double-buffered, the four identity
    matrix pairs at HIGHEST) in interpret mode against the port's step,
    within ``HIGHEST_TOL``."""
    jnp = pytest.importorskip("jax.numpy")
    d6 = diag[6]
    d6.SHAPE, d6.ZB, d6.R, d6.INNER = SHAPES[1], 8, SP.R, 1
    x = _volume(SHAPES[1], 5)
    with _interpret():
        want = np.asarray(d6.make_variant(matmuls, double_buf)(
            jnp.asarray(x)))
    got = SP.apply_variant(name, _t(x)).numpy()
    assert _rel(got, want) <= HIGHEST_TOL


def test_diag6_products_match_its_expression():
    """``diag6.py:53-66``'s products with four random matrices (one ``m``
    on both sides, as there): per matrix ``u ← (uᵀ·mᵀ)ᵀ`` then ``u ←
    u·mᵀ`` at HIGHEST in ``jnp``, against the y side and the x side with
    ``trans``, within ``HIGHEST_TOL``."""
    jnp = pytest.importorskip("jax.numpy")
    lax = pytest.importorskip("jax.lax")
    rs = np.random.RandomState(6)
    x = rs.rand(4, 32, 32).astype(np.float32)
    mats = [((rs.rand(32, 32) - 0.5) / 3).astype(np.float32)
            for _ in range(4)]
    prec = lax.Precision.HIGHEST
    u = jnp.asarray(x) * SP.SCALE
    for m in mats:
        ut = lax.dot_general(jnp.swapaxes(u, 1, 2), jnp.asarray(m),
                             (((2,), (1,)), ((), ())), precision=prec,
                             preferred_element_type=jnp.float32)
        u = lax.dot_general(jnp.swapaxes(ut, 1, 2), jnp.asarray(m),
                            (((2,), (1,)), ((), ())), precision=prec,
                            preferred_element_type=jnp.float32)
    got = _t(x) * SP.SCALE
    for m in mats:
        got = SP.probe_block_matmul(got, _t(m), "y", "HIGHEST", trans=True)
        got = SP.probe_block_matmul(got, _t(m), "x", "HIGHEST", trans=True)
    assert _rel(got.numpy(), u) <= HIGHEST_TOL


def _diag7(diag, precision, x, m):
    jnp = pytest.importorskip("jax.numpy")
    lax = pytest.importorskip("jax.lax")
    d7 = diag[7]
    d7.SHAPE, d7.ZB = x.shape, 8
    with _interpret():
        return np.asarray(d7.pallas_matmul(getattr(lax.Precision, precision))(
            jnp.asarray(m), jnp.asarray(x)))


def test_matmul_highest_plain_matches_diag7(diag):
    """``diag7.py::pallas_matmul(HIGHEST)`` (``x[z]·m`` a block) in
    interpret mode against the x side, within ``HIGHEST_TOL``."""
    rs = np.random.RandomState(7)
    x = rs.rand(*SHAPES[1]).astype(np.float32)
    m = (rs.rand(256, 256) - 0.5).astype(np.float32)
    want = _diag7(diag, "HIGHEST", x, m)
    got = SP.probe_block_matmul(_t(x), _t(m), "x", "HIGHEST").numpy()
    assert _rel(got, want) <= HIGHEST_TOL


def test_matmul_default_plain_matches_diag7(diag):
    """``pallas_matmul(DEFAULT)``: the CPU computes it in float32, so the
    port's bf16-rounded product is held to it within the rounding's bound
    (2⁻⁷ · Σ|x||m| an output), and to the Pallas kernel fed the rounded
    inputs within ``DEFAULT_TOL`` (only the order of the sums differs)."""
    rs = np.random.RandomState(8)
    x = rs.rand(*SHAPES[1]).astype(np.float32)
    m = (rs.rand(256, 256) - 0.5).astype(np.float32)
    got = SP.probe_block_matmul(_t(x), _t(m), "x", "DEFAULT").numpy()
    f32 = _diag7(diag, "DEFAULT", x, m)
    bound = np.abs(x).astype(np.float64) @ np.abs(m).astype(np.float64)
    assert np.all(np.abs(got - f32) <= 2.0 ** -7 * bound)
    assert np.max(np.abs(got - f32)) > 0  # the inputs were rounded
    xb, mb = (SP._bf16(_t(a)).numpy() for a in (x, m))
    assert _rel(got, _diag7(diag, "DEFAULT", xb, mb)) <= DEFAULT_TOL


@pytest.mark.parametrize("side", SP.SIDES)
@pytest.mark.parametrize("trans", [False, True])
def test_matmul_sides_match_float64_einsum(side, trans):
    """The two sides and their ``trans`` forms on non-square planes: ``P·m``
    / ``P·mᵀ`` (x), ``mᵀ·P`` / ``m·P`` (y), against numpy in float64,
    within ``HIGHEST_TOL``."""
    rs = np.random.RandomState(9)
    x = rs.rand(4, 24, 40).astype(np.float32)
    k = 40 if side == "x" else 24
    m = (rs.rand(k, k) - 0.5).astype(np.float32)
    mm = (m.T if trans else m).astype(np.float64)
    x64 = x.astype(np.float64)
    want = np.einsum("zyx,xw->zyw", x64, mm) if side == "x" \
        else np.einsum("ky,zkx->zyx", mm, x64)
    got = SP.probe_block_matmul(_t(x), _t(m), side, "HIGHEST", trans)
    assert _rel(got.numpy(), want) <= HIGHEST_TOL


def test_wrappers_refuse_bad_arguments():
    """An unknown side or precision, a matrix of another size, a window
    with no centre plane and a ring of 3 slots raise ``ValueError`` on
    any device."""
    x = torch.rand(4, 8, 16)
    for call in (lambda: SP.probe_block_matmul(x, torch.rand(16, 16), "z"),
                 lambda: SP.probe_block_matmul(x, torch.rand(16, 16), "x",
                                               "HIGH"),
                 lambda: SP.probe_block_matmul(x, torch.rand(8, 8), "x"),
                 lambda: SP.probe_window_scale(x, 2.0, 32, 2),
                 lambda: SP.probe_window_scale(x, 2.0, 32, 1, 3),
                 lambda: SP.apply_variant("d9", x)):
        with pytest.raises(ValueError):
            call()


# ------------------------------------------------------- variants, runs --

@pytest.mark.parametrize("name", [v.name for v in SP.VARIANTS])
def test_variant_on_a_world1_mesh_equals_plain(name):
    """Each variant's step on a one-rank ``"space"`` mesh (the wrap halo
    from ``exchange_halo_wrap``, the window at row 0) gives its plain
    step's bits."""
    c = _t(_volume(TINY, 10))
    one = M.Mesh.single("cpu")
    assert torch.equal(SP.apply_variant(name, c, one),
                       SP.apply_variant(name, c))


def test_run_probes_rows_and_plain_calls_on_cpu():
    """``run_probes`` on the CPU: a row a variant in order, plain and mesh
    ms, the declared launches (``expect``, none launched on the CPU), and
    the plain versions called as often as the card would launch the
    kernels."""
    one = M.Mesh.single("cpu")
    plains = {"probe_scale": SP.probe_scale_plain,
              "probe_window_scale": SP.probe_window_scale_plain,
              "probe_block_matmul": SP.probe_block_matmul_plain}
    before = {k: f.calls for k, f in plains.items()}
    rows = SP.run_probes(mesh=one, device="cpu", shape=TINY, small=TINY,
                         depth=(1, 2))
    assert [r["name"] for r in rows] == [v.name for v in SP.VARIANTS]
    for r, v in zip(rows, SP.VARIANTS):
        assert r["ms"] > 0 and r["mesh_ms"] > 0 and r["units"] == v.units
        assert r["per"] == "step" and (r["n"], r["inner"]) == (1, 2)
        assert r["expect"] == {k: c * 2 * 2 for k, c in v.kernels.items()}
        assert all(n == 0 for side in r["launches"].values()
                   for n in side.values())
    want = {k: 0 for k in plains}
    for r in rows:
        for k, c in r["expect"].items():
            want["probe_block_matmul" if k.startswith("probe_block")
                 else k] += 2 * c
    assert {k: f.calls - before[k] for k, f in plains.items()} == want
    assert len(SP.table(rows)) == len(rows)


def test_cli_on_cpu_prints_plain_and_mesh(capsys, monkeypatch):
    """``python -m nsol_tpu_torch.parallel.shard_probe --device cpu`` on a
    gloo group of world size 1 it makes and destroys: a line a variant
    with its plain and mesh ms (the 32 × 64 × 64 variants, for time)."""
    tdist = torch.distributed
    if tdist.is_initialized():
        pytest.skip("a process group exists in this process")
    monkeypatch.setattr(SP, "VARIANTS",
                        tuple(v for v in SP.VARIANTS if v.small))
    assert SP.main(["--device", "cpu"]) == 0
    assert not tdist.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["e3/e4", "e5"]
    assert all("plain" in ln and "mesh" in ln and "not run" not in ln
               for ln in lines)


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probes_source():
    with open(os.path.join(REPO, "nsol_tpu_torch", "csrc", "probes.cu")) as f:
        return f.read()


def test_chip_smoke_probe_kernels_are_the_source_s():
    """``chip_smoke.py`` phase 49 reports the ptxas lines of the kernels
    ``csrc/probes.cu`` defines, K3's two among them, and runs both sides of
    an x-side matrix past "DEFAULT"'s 256 resident rows, and a matrix past
    384 products a sum on each side."""
    cs = _load("chip_smoke", "chip_smoke.py")
    src = _probes_source()
    for kernel in cs.PROBE_KERNELS:
        assert re.search(r"__global__[^;{}]*\b%s\(" % kernel, src), kernel
    assert {"probe_sgemm_kernel", "probe_mma_stream_kernel"} <= set(
        cs.PROBE_KERNELS)
    assert any(shape[2] > 256 for shape in cs.PROBE_MATMUL_SHAPES)
    for axis in (1, 2):
        assert any(shape[axis] > cs.PROBE_PLAIN_MAX_K
                   for shape in cs.PROBE_MATMUL_SHAPES)
    assert set(cs.PROBE_MATMUL_FORMS) == {("x", False), ("x", True),
                                          ("y", True)}


def test_chip_smoke_stream_shapes_reach_the_ring_edges():
    """Phase 49 holds K1 and K2 to their plain versions where K2's ring of
    windows turns: zb 4 (2·halo > zb, a window sharing planes with more
    than one neighbour), (5, 24, 40) (fewer planes than a z-block of 8) and
    (3, 512, 512) (65536 16-byte columns a plane: K2's tiles in more than
    one wave)."""
    cs = _load("chip_smoke", "chip_smoke.py")
    assert set(cs.PROBE_STREAM_ZB) == {32, 8, 4}
    assert {(5, 24, 40), (3, 512, 512)} <= set(cs.PROBE_STREAM_SHAPES)


def test_cli_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SP.main([])


# -------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 24, 40), (32, 64, 64), (5, 24, 40),
                                   (3, 512, 512)], ids=str)
@pytest.mark.parametrize("zb", [32, 8, 4])
def test_stream_kernels_match_plain_on_card(cuda_device, shape, zb):
    """K1 and K2 (halo 0 and 6, one slot and two, the factor a number or in
    device memory) bit for bit against their plain versions, one launch a
    call: on a ragged last z-block (40 planes), fewer planes than a z-block
    (5 at zb 8 and 32), a window sharing planes with more than one
    neighbour (halo 6 at zb 4) and a plane of 65536 16-byte columns (K2's
    tiles in more than one wave)."""
    rs = np.random.RandomState(11)
    x = torch.as_tensor(rs.rand(*shape).astype(np.float32),
                        device=cuda_device)
    s_dev = torch.full((1, 1), SP.SCALE, dtype=torch.float32,
                       device=cuda_device)
    for s in (2.0, SP.SCALE, s_dev):
        n = SP.probe_scale.launches
        assert torch.equal(SP.probe_scale(x, s, zb),
                           SP.probe_scale_plain(x, s))
        assert SP.probe_scale.launches == n + 1
        for halo in (0, SP.R):
            ext = torch.as_tensor(rs.rand(shape[0] + 2 * halo, *shape[1:])
                                  .astype(np.float32), device=cuda_device)
            for slots in (1, 2):
                n = SP.probe_window_scale.launches
                assert torch.equal(
                    SP.probe_window_scale(ext, s, zb, halo, slots),
                    SP.probe_window_scale_plain(ext, s, halo))
                assert SP.probe_window_scale.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("side", SP.SIDES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("precision", SP.PRECISIONS)
def test_matmul_kernel_matches_plain_on_card(cuda_device, side, trans,
                                             precision):
    """K3 on tile-edge planes (8 × 48 × 80; 5 × 136 × 200, a ragged last
    tile, band and k step on every axis), rows not 16-byte aligned
    (3 × 37 × 45), the probes' 256², and an x-side matrix past "DEFAULT"'s
    resident budget (4 × 64 × 384: two parts of 256 rows), and a matrix
    past 384 products a sum on the y and the x side (2 × 520 × 136,
    2 × 40 × 520: k in two parts): "HIGHEST" within 1e-5 · max |ref| of
    the float64 product, "DEFAULT" within 1e-6 · max |ref| of its plain
    version (TF32 off), past 384 products a sum of the float64 sum of the
    bf16-rounded inputs (``chip_smoke.py``'s ``probe_matmul_reference``)."""
    cs = _load("chip_smoke", "chip_smoke.py")
    rs = np.random.RandomState(12)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for shape in ((8, 48, 80), (4, 256, 256), (5, 136, 200),
                      (3, 37, 45), (4, 64, 384), (2, 520, 136),
                      (2, 40, 520)):
            x = torch.as_tensor(rs.rand(*shape).astype(np.float32),
                                device=cuda_device)
            k = shape[2] if side == "x" else shape[1]
            m = torch.as_tensor((rs.rand(k, k) - 0.5).astype(np.float32),
                                device=cuda_device)
            got = SP.probe_block_matmul(x, m, side, precision, trans)
            ref = cs.probe_matmul_reference(SP, x, m, side, precision, trans)
            tol = 1e-5 if precision == "HIGHEST" else 1e-6
            assert _rel(got.cpu().numpy(), ref.cpu().numpy()) <= tol
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_short_probe_run_launches_on_card(cuda_device):
    """A short run of every variant plain and on a one-rank mesh: each
    variant launches its probe kernels as often as it declares, and the
    port's units it declares."""
    one = M.Mesh.single(cuda_device)
    rows = SP.run_probes(mesh=one, device=cuda_device, shape=(64, 64, 64),
                         small=(32, 64, 64), depth=(1, 2))
    for r in rows:
        for side in ("plain", "mesh"):
            assert {k: r["launches"][side][k] for k in SP.KERNELS} == \
                {k: r["expect"].get(k, 0) for k in SP.KERNELS}, r["name"]
            assert all(r["launches"][side][u] > 0 for u in r["units"])
