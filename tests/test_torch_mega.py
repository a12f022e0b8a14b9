"""The port's subnet-group megakernel path (``kernels/megakernel.py``,
``ExecutionPlan(fusion="group")``) against ``repro.kernels.megakernel`` and
``repro.api.SREngine`` on the same weights and inputs, on the CPU (the
wrapper takes its plain version there), plus the wrapper's operand checks,
the packed weights, the sizing report and the build key.

Tolerances: the toy chain rtol 1e-4 / atol 1e-5, as tests/test_megakernel.py
holds the JAX megakernel against its reference; the x4 chain and the golden
frame rtol 1e-3 / atol 1e-3, the whole-chain tolerance of
tests/test_kernels.py:77 (12 fp32 layers with intermediates of O(100) sum in
different orders in XLA and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core import pipeline as jpipe
from repro.data.synthetic import degrade, random_image
from repro.kernels import megakernel as jmk
from repro.models.essr import ESSR_X4, essr_forward, essr_macs_per_lr_pixel, init_essr
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core import pipeline
from repro_torch.kernels import _build, ops
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.ref import mega_ref
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.essr import ESSR_X4 as T_X4
from repro_torch.models.essr import ESSRConfig

TOY, JTOY = ESSRConfig(scale=2, n_sfb=2, channels=8), JCfg(scale=2, n_sfb=2, channels=8)
TOY_TOL = dict(rtol=1e-4, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)
GOLDEN_COUNTS = (10, 2, 13)


def _golden_frame(hw: int = 128, seed: int = 1234) -> np.ndarray:
    """The mixed smooth/texture frame of tests/test_fused_dispatch.py."""
    yy, xx = jnp.meshgrid(jnp.linspace(0, 1, hw), jnp.linspace(0, 1, hw), indexing="ij")
    smooth = jnp.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = degrade(jnp.asarray(random_image(seed, 2 * hw, 2 * hw)), 2)
    return np.asarray(jnp.where((yy < 0.5)[..., None], smooth, tex))


def _tree(jcfg, seed: int):
    """The reference's init with seeded non-zero biases (a halo reading
    pw(0) + b instead of 0 would show), as numpy leaves."""
    tree = jax.tree_util.tree_map(np.asarray, init_essr(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (0.1 * r.standard_normal(v.shape)).astype(np.float32) if v.ndim == 1 else v,
        tree)


def _port(tree, cfg):
    return params_from_numpy(tree, cfg).tree()


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_toy_megakernel_matches_pallas_interpret(width, n):
    tree = _tree(JTOY, 0)
    x = np.random.default_rng(n).random((n, 32, 32, 3), dtype=np.float32)
    want = jmk.essr_forward_megakernel(tree, jnp.asarray(x), JTOY, width=width, interpret=True)
    with torch.no_grad():
        got = mk.essr_forward_megakernel(_port(tree, TOY), torch.from_numpy(x), TOY, width=width)
    assert tuple(got.shape) == (n, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOY_TOL)


@pytest.mark.parametrize("width", [27, 54])
def test_x4_megakernel_matches_reference_and_layer_chain(width):
    tree = _tree(ESSR_X4, 4)
    x = np.random.default_rng(width).random((2, 16, 16, 3), dtype=np.float32)
    params = _port(tree, T_X4)
    with torch.no_grad():
        got = mk.essr_forward_megakernel(params, torch.from_numpy(x), T_X4, width=width)
        layer = ops.essr_forward_kernels(params, torch.from_numpy(x), T_X4, width=width)
    want = essr_forward(tree, jnp.asarray(x), ESSR_X4, width=width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
    np.testing.assert_allclose(got.numpy(), layer.numpy(), **CHAIN_TOL)


def test_group_engine_golden_frame_matches_reference():
    ref = JEngine.from_config(JCfg(scale=2), seed=1, backend="ref", plan=JPlan(fusion="group"))
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    eng = SREngine.from_params(tree, ESSRConfig(scale=2), plan=ExecutionPlan(fusion="group"),
                               device="cpu")
    frame = _golden_frame()
    rj, rp = ref.upscale(frame), eng.upscale(frame)
    assert rp.counts == rj.counts == GOLDEN_COUNTS
    assert rp.backend == "cuda-plain" and eng.plan.fusion == "group" and eng.summary() == {}
    np.testing.assert_array_equal(rp.ids, np.asarray(rj.ids))
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **CHAIN_TOL)
    # the warm-up key carries the fusion: the layer plan's first frame pays again
    assert eng.upscale(frame).compiled is True
    assert eng.upscale(frame, plan=ExecutionPlan()).compiled is False


@pytest.mark.parametrize("patch", [48, 64, 80])
def test_group_engine_serves_table1_patches_like_reference(patch):
    # Table I's larger patches, and 80 past it (ROADMAP queue 3, fault 2):
    # the port's group plan serves them on the CPU (its plain version, whole
    # patches) as the reference's group plan does
    jplan = JPlan(patch=patch, overlap=2, fusion="group")
    ref = JEngine.from_config(JCfg(scale=2), seed=2, backend="ref", plan=jplan)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    eng = SREngine.from_params(tree, ESSRConfig(scale=2), device="cpu",
                               plan=ExecutionPlan(patch=patch, overlap=2, fusion="group"))
    frame = _golden_frame(hw=128 if patch == 64 else 96, seed=patch)
    ops.reset_launch_counts()
    rj, rp = ref.upscale(frame), eng.upscale(frame)
    assert rp.counts == rj.counts and sum(rp.counts[1:]) > 0
    assert rp.backend == "cuda-plain" and set(ops.launch_counts().values()) == {0}
    np.testing.assert_array_equal(rp.ids, np.asarray(rj.ids))
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **CHAIN_TOL)


def test_int8_group_engine_at_patch_48_equals_layer_engine():
    ref = JEngine.from_config(JCfg(scale=2), seed=3, backend="ref")
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    frame = _golden_frame(hw=96, seed=48)
    kw = dict(patch=48, overlap=2, quant="int8")
    layer = SREngine.from_params(tree, ESSRConfig(scale=2), plan=ExecutionPlan(**kw),
                                 device="cpu")
    group = SREngine.from_params(tree, ESSRConfig(scale=2), device="cpu",
                                 plan=ExecutionPlan(**kw, fusion="group"))
    a, b = layer.upscale(frame), group.upscale(frame)
    assert b.backend == a.backend == "cuda-plain-int8" and sum(b.counts[1:]) > 0
    np.testing.assert_array_equal(a.ids, b.ids)
    assert torch.equal(a.image, b.image)


def test_resolve_forward_fusion():
    # (backend, quant, fusion): the reference's argument order
    assert pipeline.resolve_forward("cuda", fusion="group") is pipeline._forward_width_mega
    assert pipeline.resolve_forward("cuda") is pipeline._forward_width_cuda
    assert pipeline.resolve_forward("ref", None, "group") is pipeline._forward_width
    with pytest.raises(ValueError) as mine:
        pipeline.resolve_forward("cuda", fusion="tile")
    with pytest.raises(ValueError) as theirs:
        jpipe.resolve_forward("pallas", fusion="tile")
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown backend"):
        pipeline.resolve_forward("pallas", fusion="group")


#: group_report's launch shape at Table I's patches, both widths and scales
#: (cluster, rows per block, threads, floats of pixel padding, blocks an SM):
#: the most strip rows resident on an SM, padded pixels where they fit.
SIZING = {(27, 16): (2, 8, 128, 4, 3), (27, 32): (8, 4, 128, 4, 3), (27, 48): (8, 6, 288, 4, 1),
          (27, 64): (16, 4, 256, 4, 1), (54, 16): (1, 16, 448, 4, 1), (54, 32): (4, 8, 448, 4, 1),
          (54, 48): (16, 3, 256, 4, 1), (54, 64): (16, 4, 448, 0, 1)}


@pytest.mark.parametrize("patch", [16, 32, 48, 64])
@pytest.mark.parametrize("width", [27, 54])
@pytest.mark.parametrize("scale", [2, 4])
def test_group_report_fits_a_block(width, scale, patch):
    rep = mk.group_report(width, patch, scale)
    assert rep["smem_bytes"] <= mk.SMEM_LIMIT == 232_448
    cluster, rows, threads, pad, per_sm = SIZING[width, patch]
    assert (rep["cluster"], rep["rows_per_cta"], rep["threads"], rep["pixel_pad"],
            rep["blocks_per_sm"]) == (cluster, rows, threads, pad, per_sm)
    assert cluster * rows >= patch > (cluster - 1) * rows
    # no other cluster size whose strip fits keeps more rows resident on an
    # SM, and none with padded pixels fits where the pad is 0
    lay = mk.WeightLayout(3, width, 3 * scale * scale, 5)
    for c in mk.MEGA_CLUSTERS:
        other = mk._mega_shape(lay, c, patch, patch, pad)
        assert other["smem"] > mk.SMEM_LIMIT or \
            other["per_sm"] * other["rows"] <= per_sm * rows
        # the SM's shared memory, threads and registers bound the blocks an SM
        if c == cluster:
            assert other["per_sm"] == per_sm >= 1
            assert per_sm * (rep["smem_bytes"] + 1024) <= 233_472
            assert per_sm * threads * 128 <= 65_536
    if pad == 0:
        assert mk._mega_smem(lay, rows, patch, 4) > mk.SMEM_LIMIT
    macs = essr_macs_per_lr_pixel(JCfg(scale=scale, channels=width))
    assert rep["flops_per_patch"] == 2 * macs * patch * patch
    assert rep["bytes_per_patch"] == 4 * patch * patch * (3 + 3 * scale * scale)
    assert rep["bound"] == "operations"
    assert rep["weight_floats"] == lay.size


def test_group_report_sizes_and_limits():
    # C54 x4 at 32x32 is ~1.64 ms of fp32 operations for 1024 patches at 67 TFLOP/s
    rep = mk.group_report(54, 32, 4)
    assert rep["flops_per_patch"] * 1024 / 67e12 * 1e3 == pytest.approx(1.638, abs=1e-3)
    assert rep["weight_bytes"] == 4 * 53_886
    # F and A, B (8 rows x 32 px x (56 + 4) floats each), two halo rows, two
    # ring slots of the largest piece (a C54 1x1: 56 x 56 + 56 floats), the
    # halo rows' mbarrier (16 bytes)
    assert rep["smem_bytes"] == 4 * (3 * 8 * 32 * 60 + 2 * 32 * 60 + 2 * (56 * 56 + 56)) + 16 \
        == 225_232
    big = mk.group_report(54, 64, 4)                # unpadded 56-float pixels, 16 blocks
    assert big["smem_bytes"] == 4 * (3 * 4 * 64 * 56 + 2 * 64 * 56 + 2 * (56 * 56 + 56)) + 16 \
        == 226_256
    odd = mk.group_report(54, (13, 21), 4)          # one block holds the whole patch
    assert (odd["cluster"], odd["rows_per_cta"]) == (1, 13) and odd["smem_bytes"] <= 232_448
    idle = mk.group_report(54, (33, 32), 4)         # 16 blocks of 3 rows: the last five idle
    assert (idle["cluster"], idle["rows_per_cta"], idle["blocks_per_sm"]) == (16, 3, 2)
    assert 11 * 3 >= 33
    # at C27 x4 the recon's 1x1 (28 x 48 + 48 floats) is the largest piece, and
    # the unpadded output (48 floats a pixel) fits in F and A (2 x 36)
    lay = mk.WeightLayout(3, 27, 48, 5)
    assert lay.stage == lay.recon_pw == 28 * 48 + 48
    assert (rep["windows"], rep["window"], rep["work_factor"]) == ([1, 1], [32, 32], 1.0)
    # past 64 the patch is served in recompute-halo windows of at most 64
    # (r = 12 at 5 SFBs), each window's strip sized as a patch of its own
    for patch, windows, window in ((65, [2, 2], [45, 45]), ((64, 65), [1, 2], [64, 45]),
                                   ((80, 32), [2, 1], [52, 32])):
        rep = mk.group_report(54, patch, 4)
        assert (rep["windows"], rep["window"]) == (windows, window)
        h, w = (patch, patch) if isinstance(patch, int) else patch
        assert rep["work_factor"] == windows[0] * window[0] * windows[1] * window[1] / (h * w)
        same = mk.group_report(54, tuple(window), 4)
        assert {k: rep[k] for k in ("cluster", "rows_per_cta", "smem_bytes", "threads")} == \
            {k: same[k] for k in ("cluster", "rows_per_cta", "smem_bytes", "threads")}
        assert rep["flops_per_patch"] == same["flops_per_patch"] * h * w // (window[0] * window[1])
    # C64: no layout holds a 64x64 strip (262,672 B a block of 4 rows), so two
    # windows of 44 rows (3 a block of the 16-block cluster) serve it
    lay = mk.WeightLayout(3, 64, 48, 5)
    assert mk._mega_smem(lay, 4, 64, 0) == 262_672 > mk.SMEM_LIMIT
    c64 = mk.group_report(64, 64, 4)
    assert (c64["windows"], c64["window"], c64["cluster"], c64["rows_per_cta"]) == \
        ([2, 1], [44, 64], 16, 3)
    assert c64["smem_bytes"] == mk._mega_smem(lay, 3, 64, c64["pixel_pad"]) <= mk.SMEM_LIMIT
    with pytest.raises(ValueError, match="positive"):
        mk.group_report(0, 32, 4)


#: Window-planner cases: every Table I edge and a few between, then past 64.
PLAN_EDGES = [16, 24, 32, 40, 48, 56, 64, 65, 72, 80, 96, 128, 200, (80, 32)]


@pytest.mark.parametrize("n_sfb", [5, 2])
@pytest.mark.parametrize("patch", PLAN_EDGES)
def test_window_plan_tiles_the_patch_with_exact_cores(patch, n_sfb):
    """The recompute-halo windows (r = 2 + 2 n_sfb: 12 at 5 SFBs, 6 at 2):
    the cores tile each axis with no gap and no overlap, every kept pixel is
    at least r from a window edge inside the patch, no window is past 64,
    the count is the fewest that keeps W <= 64, and a patch that fits one
    launch today is one window."""
    h, w = (patch, patch) if isinstance(patch, int) else patch
    r = mk.receptive_radius(n_sfb)
    assert r == {5: 12, 2: 6}[n_sfb]
    lay = mk.WeightLayout(3, 54, 48, n_sfb)
    plan = mk.window_plan(h, w, r, mk.MAX_PATCH, lambda a, b: mk._mega_fits(lay, a, b))
    for ax, size in zip(plan, (h, w)):
        assert ax.size == size and ax.radius == r and ax.edge <= mk.MAX_PATCH
        assert len(ax.starts) == len(ax.cores) == ax.k
        assert ax.cores[0][0] == 0 and ax.cores[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(ax.cores, ax.cores[1:]))
        for (lo, hi), s in zip(ax.cores, ax.starts):
            assert 0 <= s and s + ax.edge <= size and s <= lo < hi <= s + ax.edge
            assert lo == 0 or lo - s >= r                  # inner edges: r pixels kept out
            assert hi == size or s + ax.edge - hi >= r
        # the fewest windows of at most 64: one fewer would be wider
        assert ax == mk.axis_windows(size, r, mk.MAX_PATCH)
        if ax.k > 1:
            assert -(-(size + 2 * r * (ax.k - 2)) // (ax.k - 1)) > mk.MAX_PATCH
        assert (ax.k == 1) == (size <= mk.MAX_PATCH)
    if max(h, w) <= mk.MAX_PATCH:
        assert plan[0].edge == h and plan[1].edge == w


def test_window_plan_refuses_when_no_window_fits(monkeypatch):
    """A shape no window holds still raises, before any launch: at a shared
    memory limit that no strip of the smallest windows fits."""
    monkeypatch.setattr(mk, "SMEM_LIMIT", 20_000)
    mk._mega_plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="no.*window fits a launch"):
            mk.group_report(54, 80, 4)
    finally:
        mk._mega_plan.cache_clear()
    with pytest.raises(ValueError, match="keep no core|keeps a core"):
        mk.axis_windows(80, 12, 24)


def test_windows_through_the_plain_version_equal_the_whole_patch():
    """Split-and-stitch at C8, 2 SFBs (r = 6), a 40x40 patch in windows of at
    most 24 (3 x 3 of 22): the stitched mega_ref is the whole patch's within
    the kernels' tolerance, and a radius one short moves pixels."""
    tree = _port(_tree(JTOY, 5), TOY)
    lay = mk.WeightLayout(3, 8, TOY.out_channels, TOY.n_sfb)
    w = mk.unpack_weights(mk.pack_weights(tree, 8), lay)
    x = torch.from_numpy(np.random.default_rng(5).random((2, 40, 40, 3), dtype=np.float32))
    plan = mk.window_plan(40, 40, mk.receptive_radius(TOY.n_sfb), 24, lambda a, b: True)
    assert [(a.k, a.edge) for a in plan] == [(3, 22), (3, 22)]
    calls = []

    def fn(xs):
        calls.append(tuple(xs.shape))
        return mega_ref(xs, w)

    with torch.no_grad():
        whole = mega_ref(x, w)
        got = mk.run_windowed(fn, x, plan)
        short = mk.run_windowed(fn, x, mk.window_plan(40, 40, 5, 24, lambda a, b: True))
    assert calls[0] == (2 * 9, 22, 22, 3)                 # one call over every window
    torch.testing.assert_close(got, whole, **TOY_TOL)
    assert (short - whole).abs().max().item() > 1e-2


def test_pack_unpack_round_trip_and_cache():
    tree = _port(_tree(ESSR_X4, 2), T_X4)
    for width in (27, 54):
        lay = mk.WeightLayout(3, width, 48, 5)
        wbuf = mk.pack_weights(tree, width)
        assert tuple(wbuf.shape) == (lay.size,) and wbuf.dtype == torch.float32
        w = mk.unpack_weights(wbuf, lay)
        first = tree["first"]
        np.testing.assert_array_equal(w["first"]["pw"].numpy(),
                                      first["pw"][0, 0, :, :width].detach().numpy())
        s = tree["sfbs"][3]
        np.testing.assert_array_equal(w["sfbs"][3]["b2_dw"].numpy(),
                                      s["b2"]["dw"][:, :, 0, :width].detach().numpy())
        np.testing.assert_array_equal(w["sfbs"][3]["fuse_b"].numpy(),
                                      s["fuse_b"][:width].detach().numpy())
        np.testing.assert_array_equal(w["recon"]["pw"].numpy(),
                                      tree["recon"]["pw"][0, 0, :width].detach().numpy())
        cp4, cp8 = (width + 3) // 4 * 4, (width + 7) // 8 * 8
        assert lay.padded == (4, cp4, cp8, 48)
        pad = wbuf[lay.first:lay.first + cp4 * cp8].view(cp4, cp8)   # the first SFB's b1 1x1
        assert not pad[width:].any() and not pad[:, width:].any()
        np.testing.assert_array_equal(pad[:width, :width].numpy(),
                                      tree["sfbs"][0]["b1"]["pw"][0, 0, :width, :width]
                                      .detach().numpy())
        # pieces of 16-byte units, the ring's slot the largest of them
        for piece in (lay.first_pw, lay.dw, lay.pw, lay.recon_pw):
            assert piece % 4 == 0 and piece <= lay.stage
    a = mk.packed_weights(mk._TreeKey(tree), 54)
    assert mk.packed_weights(mk._TreeKey(tree), 54) is a
    assert mk.packed_weights(mk._TreeKey(tree), 27) is not a
    with torch.no_grad():
        tree["sfbs"][0]["fuse"].mul_(2.0)          # an in-place update repacks
    assert mk.packed_weights(mk._TreeKey(tree), 54) is not a


def test_mega_wrapper_checks_and_launches_nothing_on_cpu():
    tree = _port(_tree(ESSR_X4, 3), T_X4)
    wbuf = mk.pack_weights(tree, 27)
    x = torch.rand((2, 8, 8, 3))
    kw = dict(width=27, n_sfb=5, out_channels=48)
    ops.reset_launch_counts()
    out = mk.mega_fused(x, wbuf, **kw)
    assert tuple(out.shape) == (2, 8, 8, 48)
    np.testing.assert_allclose(out.numpy(), mega_ref(x, mk.unpack_weights(
        wbuf, mk.WeightLayout(3, 27, 48, 5))).numpy(), rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32"):
        mk.mega_fused(x.double(), wbuf, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mega_fused(x.transpose(1, 2), wbuf, **kw)
    with pytest.raises(ValueError, match="N,H,W,C"):
        mk.mega_fused(x[0], wbuf, **kw)
    with pytest.raises(ValueError, match="wbuf shape"):
        mk.mega_fused(x, wbuf[:-4], **kw)
    with pytest.raises(ValueError, match="wbuf shape"):
        mk.mega_fused(x, wbuf, width=54, n_sfb=5, out_channels=48)
    with pytest.raises(ValueError, match="1..64"):
        mk.mega_fused(x, wbuf, width=72, n_sfb=5, out_channels=48)
    # the plain version serves any patch on the CPU, also one no launch shape holds
    w54 = mk.pack_weights(tree, 54)
    for hw in (64, 72):
        big = torch.rand((1, hw, hw, 3))
        assert torch.equal(mk.mega_fused(big, w54, width=54, n_sfb=5, out_channels=48),
                           mega_ref(big, mk.unpack_weights(w54, mk.WeightLayout(3, 54, 48, 5))))
    with torch.no_grad():
        empty = mk.essr_forward_megakernel(tree, torch.zeros((0, 32, 32, 3)), T_X4, width=54)
        assert tuple(empty.shape) == (0, 128, 128, 3)
        with pytest.raises(ValueError, match="bilinear"):
            mk.essr_forward_megakernel(tree, x, T_X4, width=0)
        with pytest.raises(ValueError, match="outside 1..54"):
            mk.essr_forward_megakernel(tree, x, T_X4, width=60)
    assert ops.launch_counts() == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0,
                                   "quantize": 0, "qbsconv": 0, "qsfb": 0, "qdsconv": 0,
                                   "qmega": 0, "edge": 0}


def test_build_key_of_the_megakernel():
    assert (_build.CSRC / "mega.cu").exists()
    key = _build.source_key("mega")
    assert len(key) == 16 and _build.library_path("mega").name == f"mega-{key}.so"
    assert key not in {_build.source_key(n) for n in ("bsconv", "sfb", "dsconv")}
    src = (_build.CSRC / "mega.cu").read_text()
    # the cluster launch and halo exchange live in the header shared with qmega.cu
    cluster = (_build.CSRC / "cluster.cuh").read_text()
    assert 'extern "C" int mega_forward(' in src and '#include "cluster.cuh"' in src
    assert "cudaLaunchAttributeClusterDimension" in cluster
