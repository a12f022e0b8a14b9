"""Port parity of the routing and patching core against the JAX reference:
edge scores, the subnet decision and MAC accounting, the patch grid,
extraction, overlap-average fusion, and the bounded cache.

Tolerances: scores rtol 1e-5 (luma spans 0-255; a larger error could move a
score across a threshold); fusion rtol 1e-6 / atol 1e-6 (same products,
same summation order, only fp32 rounding of the weights' product differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_score as jedge
from repro.core import patching as jpatch
from repro.core import subnet_policy as jsp
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.core import edge_score as tedge
from repro_torch.core import patching as tpatch
from repro_torch.core import subnet_policy as tsp
from repro_torch.core.caching import BoundedCache, bounded_cache
from repro_torch.models.essr import ESSRConfig


def test_edge_score_matches_reference():
    r = np.random.default_rng(0)
    x = np.concatenate([r.random((6, 32, 32, 3), dtype=np.float32),
                        np.broadcast_to(np.linspace(0, 1, 32, dtype=np.float32)[:, None, None],
                                        (32, 32, 3))[None],
                        0.5 + 0.1 * r.random((3, 32, 32, 3), dtype=np.float32)])
    got = tedge.edge_score(torch.from_numpy(x)).numpy()
    want = np.asarray(jedge.edge_score(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_decide_counts_and_macs_match_reference():
    scores = np.array([0.0, 7.999, 8.0, 39.99, 40.0, 255.0, 20.0], np.float32)
    for t1, t2 in [(8.0, 40.0), (0.0, 0.0), (10.5, 30.25)]:
        got = tsp.decide(scores, t1, t2)
        np.testing.assert_array_equal(got, np.asarray(jsp.decide(scores, t1, t2)))
        assert got.dtype == np.int32
        assert tsp.subnet_counts(got) == jsp.subnet_counts(got)
    for s in (2, 4):
        a = tsp.SubnetMacs.make(ESSRConfig(scale=s), 32)
        b = jsp.SubnetMacs.make(JCfg(scale=s), 32)
        assert a.per_patch == b.per_patch
        assert a.saving_vs_c54((10, 2, 13)) == b.saving_vs_c54((10, 2, 13))
    assert tsp.SubnetMacs.make(ESSRConfig()).saving_vs_c54((0, 0, 0)) == 0.0


@pytest.mark.parametrize("size", [20, 32, 33, 63, 64, 93, 128, 1080])
def test_grid_starts_match_reference(size):
    np.testing.assert_array_equal(tpatch.grid_starts(size, 32, 2),
                                  jpatch.grid_starts(size, 32, 2))


@pytest.mark.parametrize("h,w,s", [(63, 47, 2), (64, 64, 4), (20, 25, 2), (5, 40, 4)])
def test_extract_and_fuse_match_reference(h, w, s):
    """(63, 47): the last start clamps right after the previous one, so a
    pixel takes 3 patches per axis; (20, 25) and (5, 40): frames smaller
    than a patch are reflect/edge-padded and the output cropped."""
    r = np.random.default_rng(h * w)
    frame = r.random((h, w, 3), dtype=np.float32)
    tg = tpatch.get_geometry(h, w, 32, 2, s, "cpu")
    jg = jpatch.get_geometry(h, w, 32, 2, s)
    np.testing.assert_array_equal(tg.pos, jg.pos)
    got = tg.extract(torch.from_numpy(frame)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.extract(jnp.asarray(frame))))
    sr = r.random((tg.n, 32 * s, 32 * s, 3), dtype=np.float32)
    fused = tg.fuse_average(torch.from_numpy(sr)).numpy()
    assert fused.shape == (h * s, w * s, 3)
    np.testing.assert_allclose(fused, np.asarray(jg.fuse_average(jnp.asarray(sr))),
                               rtol=1e-6, atol=1e-6)


def test_fuse_average_of_constant_patches_is_constant():
    g = tpatch.get_geometry(63, 93, 32, 2, 2, "cpu")
    out = g.fuse_average(torch.full((g.n, 64, 64, 3), 0.25))
    torch.testing.assert_close(out, torch.full_like(out, 0.25), rtol=1e-6, atol=1e-6)


def test_geometry_cache_is_per_shape_and_device():
    a = tpatch.get_geometry(64, 64, 32, 2, 2, "cpu")
    assert tpatch.get_geometry(64, 64, 32, 2, 2, "cpu") is a
    assert tpatch.get_geometry(64, 64, 32, 2, 4, "cpu") is not a
    assert a.gather_idx.device.type == "cpu" and not a.pos.flags.writeable


def test_bounded_cache_lru_resize_and_occupancy():
    calls = []

    @bounded_cache(maxsize=2)
    def f(x):
        calls.append(x)
        return x * 2

    assert [f(1), f(2), f(1), f(3)] == [2, 4, 2, 6]
    assert f.occupancy() == {"size": 2, "maxsize": 2, "hits": 1, "misses": 3, "evictions": 1}
    f(2)                                   # 2 was evicted (least recently used)
    assert calls == [1, 2, 3, 2]
    f.resize(1)
    assert f.cache_info().currsize == 1
    with pytest.raises(ValueError):
        BoundedCache(lambda: 0, maxsize=0)
    f.cache_clear()
    assert f.occupancy()["size"] == 0
