"""Port parity: layers, the ESSR model and the weight bridge against the JAX
reference, on the same numpy inputs.

Tolerances: single layers rtol 1e-4 / atol 1e-5 (fp32, different summation
order); the whole 5-SFB model rtol 1e-3 / atol 1e-3 (error compounds over
12 layers of random He-normal weights, outputs reach O(100)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import essr as jessr
from repro.models import layers as JL
from repro_torch.models import essr as tessr
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(seed=0, cfg=jessr.ESSR_X4):
    return jax.tree_util.tree_map(np.asarray, jessr.init_essr(jax.random.PRNGKey(seed), cfg))


@pytest.mark.parametrize("cin,cout", [(3, 18), (54, 54), (27, 48)])
def test_pointwise_matches_reference(cin, cout):
    r = _rng(1)
    x = r.random((2, 9, 7, cin), dtype=np.float32)
    w = r.standard_normal((1, 1, cin, cout)).astype(np.float32)
    b = r.standard_normal(cout).astype(np.float32)
    np.testing.assert_allclose(_np(TL.pointwise(torch.from_numpy(x), torch.from_numpy(w),
                                                torch.from_numpy(b))),
                               np.asarray(JL.pointwise(x, w, b)), **TOL)


@pytest.mark.parametrize("h,w", [(8, 8), (5, 11), (34, 34)])
def test_dwconv_shift_matches_reference(h, w):
    r = _rng(2)
    x = r.random((3, h, w, 6), dtype=np.float32)
    k = r.standard_normal((3, 3, 1, 6)).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.dwconv2d(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))),
        np.asarray(JL.dwconv2d(x, k, b)), **TOL)


@pytest.mark.parametrize("layer", ["bsconv", "dsconv"])
def test_bsconv_dsconv_match_reference(layer):
    r = _rng(3)
    x = r.random((2, 16, 16, 12), dtype=np.float32)
    if layer == "bsconv":
        p = {"pw": r.standard_normal((1, 1, 12, 10)), "dw": r.standard_normal((3, 3, 1, 10)),
             "pw_b": r.standard_normal(10), "dw_b": r.standard_normal(10)}
    else:
        p = {"dw": r.standard_normal((3, 3, 1, 12)), "pw": r.standard_normal((1, 1, 12, 10)),
             "dw_b": r.standard_normal(12), "pw_b": r.standard_normal(10)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    got = getattr(TL, layer)({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(getattr(JL, layer)(p, x)), **TOL)


@pytest.mark.parametrize("s", [2, 4])
def test_pixel_shuffle_order_and_parity(s):
    x = np.arange(2 * 3 * 4 * 3 * s * s, dtype=np.float32).reshape(2, 3, 4, 3 * s * s)
    got = _np(TL.pixel_shuffle(torch.from_numpy(x), s))
    np.testing.assert_array_equal(got, np.asarray(JL.pixel_shuffle(x, s)))
    # torch order: output (h*s+i, w*s+j, c) takes input channel c*s^2 + i*s + j
    for i in range(s):
        for j in range(s):
            np.testing.assert_array_equal(got[:, i::s, j::s, 1], x[..., s * s + i * s + j])


@pytest.mark.parametrize("s", [2, 4])
def test_bilinear_matches_jax_resize_incl_borders(s):
    x = _rng(4).random((3, 7, 10, 3), dtype=np.float32)
    got = _np(TL.bilinear_resize(torch.from_numpy(x), s))
    want = np.asarray(JL.bilinear_resize(x, s))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the borders (edge clamp) are where the two conventions could differ
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], rtol=1e-6, atol=1e-6)


def test_rgb_to_luma_bit_exact():
    x = _rng(5).random((4, 9, 9, 3), dtype=np.float32)
    np.testing.assert_array_equal(_np(TL.rgb_to_luma(torch.from_numpy(x))),
                                  np.asarray(JL.rgb_to_luma(x)))


@pytest.mark.parametrize("cfg,count", [(tessr.ESSR_X4, 53886), (tessr.ESSR_X2, 51906)])
def test_param_counts(cfg, count):
    assert tessr.essr_param_count(cfg) == count
    assert sum(p.numel() for p in tessr.ESSR(cfg).parameters()) == count


@pytest.mark.parametrize("width", [None, 0, 27, 54])
def test_macs_match_reference(width):
    for s in (2, 4):
        assert (tessr.essr_macs_per_lr_pixel(tessr.ESSRConfig(scale=s), width)
                == jessr.essr_macs_per_lr_pixel(jessr.ESSRConfig(scale=s), width))


def test_init_is_he_normal_and_seeded():
    a = tessr.ESSR(tessr.ESSR_X4, torch.Generator().manual_seed(3))
    b = tessr.ESSR(tessr.ESSR_X4, torch.Generator().manual_seed(3))
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    w = a.sfbs[0].fuse.detach()
    assert abs(float(w.std()) - (2.0 / 54) ** 0.5) < 0.02
    assert float(a.first.pw_b.detach().abs().sum()) == 0.0


def test_bridge_round_trip_and_shape_errors():
    tree = _tree(0)
    back = params_to_numpy(params_from_numpy(tree, tessr.ESSR_X4))
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree_util.tree_map(lambda v: v, tree)
    bad["first"]["pw"] = bad["first"]["pw"][..., :27]
    with pytest.raises(ValueError, match="first.pw"):
        params_from_numpy(bad, tessr.ESSR_X4)


@pytest.mark.parametrize("width", [0, 27, 54])
def test_essr_forward_matches_reference(width):
    tree = _tree(1, jessr.ESSR_X2)
    model = params_from_numpy(tree, tessr.ESSR_X2)
    x = _rng(6).random((3, 16, 16, 3), dtype=np.float32)
    with torch.no_grad():
        got = _np(model(torch.from_numpy(x), width=width))
    want = np.asarray(jessr.essr_forward(tree, jnp.asarray(x), jessr.ESSR_X2, width=width))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_slice_width_matches_reference():
    tree = _tree(2)
    mine = tessr.slice_width(params_from_numpy(tree, tessr.ESSR_X4).tree(), 27)
    want = jessr.slice_width(tree, 27)
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, mine)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
