"""The port's baselines and the helpers the benchmark scripts call, against
``repro``: bicubic resize, FSRCNN (its SAME deconvolution at scales 2-4),
RLFN (ESA's asymmetric SAME max pool), the weight bridge and parameter /
MAC counts of the published configs, the patching helpers and their loop
oracles, the luma edge score, MAC saving and the threshold search, the
activation-scale init. On the CPU, small widths, one intra-op thread.

Tolerances: one op (resize, the deconvolution, ESA) rtol 1e-4 / atol 1e-5;
whole models rtol 1e-3 / atol 1e-3 (the whole-chain tolerance of
tests/test_kernels.py:77); gathers, overwrites and the loop oracles exact;
overlap-and-average rtol 1e-6; the luma edge score rtol 1e-5 / atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_score as JE
from repro.core import patching as JP
from repro.core import subnet_policy as JSP
from repro.models import fsrcnn as JF
from repro.models import layers as JL
from repro.models import rlfn as JR
from repro.models.essr import ESSR_X2 as J_ESSR_X2
from repro.models.essr import ESSR_X4 as J_ESSR_X4
from repro.models.essr import essr_macs as j_essr_macs
from repro.models.essr import init_essr as j_init_essr
from repro.quant import pams as JQ
from repro_torch.core import edge_score as E
from repro_torch.core import patching as P
from repro_torch.core import subnet_policy as SP
from repro_torch.models import fsrcnn as F
from repro_torch.models import layers as L
from repro_torch.models import rlfn as R
from repro_torch.models.convert import fsrcnn_from_numpy, params_from_numpy, rlfn_from_numpy
from repro_torch.models.essr import ESSR_X2, ESSR_X4, essr_macs, essr_param_count
from repro_torch.quant import pams as Q

OP_TOL = dict(rtol=1e-4, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)
TINY_FSRCNN = dict(d=8, s=4, m=2)
TINY_RLFN = dict(channels=8, n_blocks=2, esa_channels=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _np_params(init, cfg, seed=0, std=0.3):
    """A reference param tree of ``init``'s shapes with seeded normal numpy
    leaves (biases and PReLU slopes too): shapes by ``jax.eval_shape``, so
    nothing is compiled."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: rng.normal(0, std, s.shape).astype(np.float32),
                                  shapes)


# ---------------------------------------------------------------------------
# bicubic resize, the FSRCNN deconvolution, ESA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,out_hw", [((8, 8), (32, 32)), ((30, 30), (120, 120)),
                                       ((16, 16), (24, 24)), ((8, 8), (4, 4)),
                                       ((32, 24), (8, 6)), ((7, 13), (28, 52))])
def test_bicubic_resize_matches_jax_cubic(hw, out_hw):
    x = _rand(0, 2, *hw, 3)
    want = JL.bicubic_resize(jnp.asarray(x), out_hw)
    got = L.bicubic_resize(torch.from_numpy(x), out_hw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("hw", [(6, 6), (5, 9)])
def test_deconvolution_matches_lax_conv_transpose(scale, hw):
    """No transpose_kernel: the dilated input against the unflipped HWIO
    kernel, JAX's SAME pads (k = 9: (6, 5) at x4)."""
    x = _rand(1, 2, *hw, 8)
    w = np.random.default_rng(2).normal(0, 0.1, (9, 9, 8, 1)).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), strides=(scale, scale),
                                  padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = F.conv_transpose_same(torch.from_numpy(x), torch.from_numpy(w), scale)
    assert tuple(got.shape) == (2, hw[0] * scale, hw[1] * scale, 1) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("hw", [(16, 16), (13, 17), (6, 5)])
def test_esa_matches_reference(hw):
    """reduce_window's SAME -inf pads fall (low = total // 2, the rest high)."""
    jp = _np_params(lambda k, _: JR.init_esa(k, 8, 4), None, seed=4)
    x = _rand(5, 2, *hw, 8) - 0.5
    want = JR.esa_forward(jp, jnp.asarray(x))
    got = R.esa_forward(jax.tree_util.tree_map(torch.from_numpy, jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ---------------------------------------------------------------------------
# the whole baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [2, 3, 4])
def test_fsrcnn_matches_reference(scale):
    jcfg, cfg = JF.FSRCNNConfig(scale=scale, **TINY_FSRCNN), F.FSRCNNConfig(scale=scale,
                                                                          **TINY_FSRCNN)
    jp = _np_params(JF.init_fsrcnn, jcfg, seed=6)
    y = _rand(7, 2, 12, 10, 1)
    want = JF.fsrcnn_forward(jp, jnp.asarray(y), jcfg)
    model = fsrcnn_from_numpy(jp, cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(y))
    assert tuple(got.shape) == (2, 12 * scale, 10 * scale, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


@pytest.mark.parametrize("scale,hw", [(2, (16, 16)), (4, (13, 11))])
def test_rlfn_matches_reference(scale, hw):
    jcfg, cfg = JR.RLFNConfig(scale=scale, **TINY_RLFN), R.RLFNConfig(scale=scale, **TINY_RLFN)
    jp = _np_params(JR.init_rlfn, jcfg, seed=8, std=0.15)
    x = _rand(9, 2, *hw, 3)
    want = JR.rlfn_forward(jp, jnp.asarray(x), jcfg)
    model = rlfn_from_numpy(jp, cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


@pytest.mark.parametrize("name", ["FSRCNN", "RLFN_BASE_X2", "RLFN_BASE_X4", "RLFN_PRUNED_X2",
                                  "RLFN_PRUNED_X4"])
def test_published_configs_count_like_reference(name):
    """Parameter counts of the five named configs equal the reference's,
    through the port's modules and through the bridge."""
    if name == "FSRCNN":
        jcfg, cfg = JF.FSRCNNConfig(), F.FSRCNNConfig()
        jp = _np_params(JF.init_fsrcnn, jcfg)
        mine, bridged = F.init_fsrcnn(cfg), fsrcnn_from_numpy(jp, cfg)
    else:
        jcfg, cfg = getattr(JR, name), getattr(R, name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        jp = _np_params(JR.init_rlfn, jcfg)
        mine, bridged = R.init_rlfn(cfg), rlfn_from_numpy(jp, cfg)
        assert R.rlfn_macs_per_lr_pixel(cfg) == JR.rlfn_macs_per_lr_pixel(jcfg)
    want = JL.count_params(jp)
    assert L.count_params(mine) == L.count_params(mine.tree()) == want
    assert L.count_params(bridged) == want


def test_bridge_refuses_a_wrong_tree():
    jp = _np_params(JF.init_fsrcnn, JF.FSRCNNConfig(**TINY_FSRCNN))
    with pytest.raises(ValueError, match="maps: 2 entries != expected 3"):
        fsrcnn_from_numpy(jp, F.FSRCNNConfig(d=8, s=4, m=3))
    with pytest.raises(ValueError, match="shape"):
        fsrcnn_from_numpy(jp, F.FSRCNNConfig(d=9, s=4, m=2))


def test_table56_identities():
    """benchmarks/table56_quality.py's identities, through the port."""
    assert essr_param_count(ESSR_X2) == 51906
    assert essr_param_count(ESSR_X4) == 53886
    assert L.count_params(params_from_numpy(_np_params(j_init_essr, J_ESSR_X4), ESSR_X4)) == 53886
    for cfg, jcfg, hw, gmac in ((ESSR_X2, J_ESSR_X2, (540, 960), 26.1),
                                (ESSR_X4, J_ESSR_X4, (270, 480), 6.8)):
        assert essr_macs(cfg, hw) == j_essr_macs(jcfg, hw)
        assert abs(essr_macs(cfg, hw) / 1e9 - gmac) < 0.3
        for width in (0, 27, 54):
            assert essr_macs(cfg, hw, width) == j_essr_macs(jcfg, hw, width)
    assert F.fsrcnn_macs_per_lr_pixel(F.FSRCNNConfig()) == 12464


# ---------------------------------------------------------------------------
# patching helpers
# ---------------------------------------------------------------------------

SWEEP = [(64, 64, 32, 2, 4), (62, 62, 32, 2, 2), (47, 53, 16, 3, 2), (34, 32, 32, 30, 1),
         (33, 95, 32, 2, 4), (40, 40, 8, 0, 2), (20, 24, 32, 2, 2)]


@pytest.mark.parametrize("h,w,patch,overlap,scale", SWEEP)
def test_extract_and_fuse_match_reference(h, w, patch, overlap, scale):
    img = _rand(10, h, w, 3)
    jp, jpos = JP.extract_patches(jnp.asarray(img), patch, overlap)
    got, pos = P.extract_patches(torch.from_numpy(img), patch, overlap)
    assert pos.dtype == np.int64 and np.array_equal(pos, jpos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp))
    ps = patch * scale
    sr = _rand(11, len(pos), ps, ps, 3)
    out_hw = (h * scale, w * scale)
    want = JP.fuse_patches_average(jnp.asarray(sr), jpos, scale, out_hw)
    fused = P.fuse_patches_average(torch.from_numpy(sr), pos, scale, out_hw)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    if h >= patch and w >= patch:        # else no patch fits the frame: both raise
        crop = P.fuse_patches_crop(torch.from_numpy(sr), pos, scale, out_hw)
        np.testing.assert_array_equal(crop.numpy(), np.asarray(
            JP.fuse_patches_crop(jnp.asarray(sr), jpos, scale, out_hw)))
    # the cartesian path folds as the geometry does
    geom = P.get_geometry(h, w, patch, overlap, scale, "cpu")
    assert torch.equal(fused, geom.fuse_average(torch.from_numpy(sr)))


@pytest.mark.parametrize("h,w,patch,overlap,scale", SWEEP[:-1])
def test_loop_oracles_match_reference(h, w, patch, overlap, scale):
    img = _rand(12, h, w, 3)
    jp, jpos = JP.extract_patches_loop(jnp.asarray(img), patch, overlap)
    got, pos = P.extract_patches_loop(torch.from_numpy(img), patch, overlap)
    assert np.array_equal(pos, jpos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp))
    ps = patch * scale
    sr = _rand(13, len(pos), ps, ps, 3)
    out_hw = (h * scale, w * scale)
    want = JP.fuse_patches_average_loop(jnp.asarray(sr), jpos, scale, out_hw)
    np.testing.assert_array_equal(
        P.fuse_patches_average_loop(torch.from_numpy(sr), pos, scale, out_hw).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("pos,out_hw", [([(0, 0), (2, 5)], (10, 13)),
                                        ([(4, 0), (0, 3), (1, 1)], (12, 12)),
                                        ([(0, 0), (0, 4), (3, 0)], (11, 13))])
def test_fuse_average_scatter_fallback_matches_reference(pos, out_hw):
    """Position lists that are not a cartesian grid; uncovered pixels are 0."""
    pos = np.array(pos, dtype=np.int64)
    sr = _rand(14, len(pos), 8, 8, 2)
    want = JP.fuse_patches_average(jnp.asarray(sr), pos, 1, out_hw)
    got = P.fuse_patches_average(torch.from_numpy(sr), pos, 1, out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    crop = P.fuse_patches_crop(torch.from_numpy(sr), pos, 1, out_hw)
    np.testing.assert_array_equal(crop.numpy(), np.asarray(
        JP.fuse_patches_crop(jnp.asarray(sr), pos, 1, out_hw)))


@pytest.mark.parametrize("patch,overlap", [(32, 2), (16, 0), (64, 4)])
def test_cost_helpers_match_reference(patch, overlap):
    assert P.overlap_mac_overhead(patch, overlap) == JP.overlap_mac_overhead(patch, overlap)
    for args in ((1920, overlap, 54), (960, overlap, 27, 1.0)):
        assert P.boundary_sram_bytes(*args) == JP.boundary_sram_bytes(*args)


# ---------------------------------------------------------------------------
# edge score on luma, MAC saving, the threshold search, activation scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(32, 32), (7, 11)])
def test_edge_score_luma_matches_reference(hw):
    luma = _rand(15, 5, *hw) * 255.0
    want = JE.edge_score_luma(jnp.asarray(luma))
    got = E.edge_score_luma(torch.from_numpy(luma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def _scores_near_thresholds():
    """Uniform scores and float64 scores within 1e-6 of grid thresholds: in
    float32 each rounds onto the threshold."""
    rng = np.random.default_rng(16)
    near = [t + d for t in (8.0, 40.0, 10.0, 2.0, 45.0, 30.0)
            for d in (-2e-7, -1e-7, 1e-7, 2e-7)] + [40.0 - 1e-6, 8.0 - 4e-7]
    return np.concatenate([rng.uniform(0, 120, 300), np.array(near)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mac_saving_and_threshold_search_match_reference(dtype):
    scores = _scores_near_thresholds().astype(dtype)
    for cfg, jcfg in ((ESSR_X4, J_ESSR_X4), (ESSR_X2, J_ESSR_X2)):
        for t1, t2 in ((8.0, 40.0), (2.0, 10.0), (30.0, 45.0)):
            assert SP.mac_saving(scores, t1, t2, cfg) == JSP.mac_saving(scores, t1, t2, jcfg)
    for target in (0.4, 0.6):
        assert (SP.thresholds_for_target_saving(scores, target, ESSR_X4)
                == JSP.thresholds_for_target_saving(scores, target, J_ESSR_X4))
    grid = dict(t1_grid=np.array([2.0, 8.0]), t2_grid=np.array([10.0, 40.0]))
    assert (SP.thresholds_for_target_saving(scores, 0.3, ESSR_X4, 16, **grid)
            == JSP.thresholds_for_target_saving(scores, 0.3, J_ESSR_X4, 16, **grid))


def test_float64_scores_route_as_float32():
    """8 - 2e-7 is 8.0 in float32: C27, as the reference routes it."""
    got = SP.mac_saving(np.array([8.0 - 2e-7, 40.0 - 1e-6]), 8.0, 40.0, ESSR_X4)
    assert got["counts"] == (0, 1, 1)


def test_init_act_scales_match_reference():
    for cfg, jcfg in ((ESSR_X4, J_ESSR_X4), (ESSR_X2, J_ESSR_X2)):
        want = JQ.init_act_scales(jcfg, 1.5)
        got = Q.init_act_scales(cfg, 1.5, device="cpu")
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == torch.float32 and got[k].shape == ()
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
