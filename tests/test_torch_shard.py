"""The port's sharded patch stream against ``repro``: ``shard_slices``, the
per-shard Algorithm-1 bank, the split per-subnet forward, the ``shards``
plan field and the engine's per-shard routing, demotion and reporting. On
the CPU, x2, a toy supernet (C8, one SFB) and one intra-op thread.

As in tests/test_sharded_pipeline.py, JAX sees one CPU device here, so the
reference engine degrades to one device with its warning; so does the port
(one card or a CPU engine). The split path itself runs on one device named
several times (``devices=("cpu",) * 4``), which is how the port exercises it
without several cards. Tolerances: ids, counts, thresholds, demotions,
warnings and summaries equal; images rtol 1e-3 / atol 1e-3 (fp32 sums in
another order than XLA's); the split forward within rtol 1e-5 / atol 1e-6
of the unsplit one in fp32 and torch.equal in int8.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core.adaptive import ShardSwitcherBank as JBank
from repro.core.adaptive import SwitchingConfig as JSwitching
from repro.core.adaptive import per_shard_config as j_per_shard_config
from repro.core.patching import get_geometry as j_get_geometry
from repro.core.patching import shard_slices as j_shard_slices
from repro.data.synthetic import degrade, random_image
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core.adaptive import ShardSwitcherBank, SwitchingConfig, per_shard_config
from repro_torch.core.patching import get_geometry, shard_slices
from repro_torch.core.pipeline import _sharded_forward, resolve_forward
from repro_torch.launch.mesh import make_patch_devices
from repro_torch.models.essr import ESSRConfig

CFG, JCFG = ESSRConfig(channels=8, n_sfb=1, scale=2), JCfg(channels=8, n_sfb=1, scale=2)
IMG_TOL = dict(rtol=1e-3, atol=1e-3)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TIMING = ("mean_latency_s", "compiled_caches")
CPU4 = (torch.device("cpu"),) * 4


def _mixed_frame(hw: int = 96, seed: int = 7) -> np.ndarray:
    """A smooth top, a textured middle and a noisy bottom: every subnet
    routes, and the strips load their shards unevenly."""
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    smooth = np.stack([yy, xx, (yy + xx) / 2], axis=-1).astype(np.float32)
    tex = np.asarray(degrade(jnp.asarray(random_image(seed, 2 * hw, 2 * hw)), 2))
    noise = np.random.default_rng(seed).random((hw, hw, 3)).astype(np.float32)
    third = hw // 3
    return np.concatenate([smooth[:third], tex[third:2 * third], noise[2 * third:]])


FRAMES = [_mixed_frame(seed=7 + i) for i in range(3)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors beside other test processes: one intra-op thread each
    (put back afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    ref = JEngine.from_config(JCFG, seed=2)
    return ref, jax.tree_util.tree_map(np.asarray, ref.params)


# ---------------------------------------------------------------------------
# shard_slices and the bank, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shards", [(10, 4), (9, 2), (8, 8), (3, 5), (0, 2), (7, 1),
                                      (2304, 4), (25, 8)])
def test_shard_slices_equal_reference(n, shards):
    assert shard_slices(n, shards) == j_shard_slices(n, shards)


def test_shard_slices_and_geometry_refuse_and_match():
    with pytest.raises(ValueError) as mine:
        shard_slices(4, 0)
    with pytest.raises(ValueError) as theirs:
        j_shard_slices(4, 0)
    assert str(mine.value) == str(theirs.value)
    g, jg = get_geometry(96, 64, 32, 2, 2, "cpu"), j_get_geometry(96, 64, 32, 2, 2)
    for k in (1, 3, 4, 8):
        assert g.shard_slices(k) == jg.shard_slices(k)


@pytest.mark.parametrize("shards", [1, 2, 3, 7, 64])
def test_per_shard_config_equals_reference(shards):
    for kw in ({}, dict(frame_low=0), dict(c54_per_sec_budget=5, frame_high=3, frame_low=1)):
        mine = per_shard_config(SwitchingConfig(**kw), shards)
        theirs = j_per_shard_config(JSwitching(**kw), shards)
        assert [getattr(mine, f) for f in vars(theirs)] == list(vars(theirs).values())
    for fn, cfg in ((per_shard_config, SwitchingConfig()), (j_per_shard_config, JSwitching())):
        with pytest.raises(ValueError, match="shards must be >= 1, got 0"):
            fn(cfg, 0)


@pytest.mark.parametrize("shards", [3, 4, 8])
def test_bank_matches_reference_frame_by_frame(shards):
    """Seeded scores with strips of uneven load, a miss every other frame:
    ids, demoted shards and per-shard thresholds equal on every frame."""
    rng = np.random.default_rng(shards)
    kw = dict(c54_per_sec_budget=60, frame_high=12, frame_low=4, fps=5)
    mine, theirs = ShardSwitcherBank(SwitchingConfig(**kw), shards), \
        JBank(JSwitching(**kw), shards)
    n = 50
    slices = shard_slices(n, shards)
    for f in range(24):
        scores = rng.uniform(0.0, 30.0, n).astype(np.float32)
        hot = slices[f % shards]
        scores[hot] = rng.uniform(30.0, 120.0, hot.stop - hot.start)
        ids = mine.assign(scores, slices)
        np.testing.assert_array_equal(ids, theirs.assign(scores, slices))
        costs = [float((ids[sl] == 2).sum() * 10 + (ids[sl] == 1).sum() * 3) for sl in slices]
        if f % 6 == 5:
            costs = [7.0] * shards                 # an even frame: every shard backs off
        assert mine.note_frame(f % 2 == 1, costs) == theirs.note_frame(f % 2 == 1, costs)
        assert mine.thresholds == theirs.thresholds
    assert len(set(mine.thresholds)) > 1           # the shards moved apart


def test_bank_errors_match_reference():
    for make in (ShardSwitcherBank, JBank):
        with pytest.raises(ValueError, match="shards must be >= 1, got 0"):
            make(None, 0)
    for bank in (ShardSwitcherBank(None, 3), JBank(None, 3)):
        with pytest.raises(ValueError, match="got 2 slices for 3 shards"):
            bank.assign(np.zeros(4), shard_slices(4, 2))
        with pytest.raises(ValueError, match="got 1 costs for 3 shards"):
            bank.note_frame(True, [1.0])


def test_make_patch_devices_validates():
    with pytest.raises(ValueError, match="shards must be >= 1, got 0"):
        make_patch_devices(0)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 1} shards but only {n} devices"):
        make_patch_devices(n + 1)


# ---------------------------------------------------------------------------
# the split per-subnet forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_engine(engines):
    _, tree = engines
    return SREngine.from_params(tree, CFG, plan=ExecutionPlan(quant="int8"), device="cpu")


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("fusion", ["layer", "group"])
@pytest.mark.parametrize("n", [1, 6, 7])
def test_sharded_forward_equals_unsplit(engines, int8_engine, quant, fusion, n):
    """N not divisible by 4 pads with the last patch; every patch is computed
    on its own, so the split forward is the unsplit one."""
    eng = int8_engine
    pack = eng.qpack if quant else None
    x = torch.from_numpy(np.random.default_rng(n).random((n, 16, 16, 3), np.float32))
    for width in (0, 4, 8):
        got = _sharded_forward(eng.params, x, CFG, width, devices=CPU4, backend="cuda",
                               quant=pack, fusion=fusion)
        want = resolve_forward("cuda", pack, fusion)(eng.params, x, CFG, width)
        assert got.shape == (n, 32, 32, 3)
        if quant:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **FWD_TOL)


def test_engine_over_repeated_devices_equals_one_device(engines):
    """The engine's host path through the split forward (one device named
    four times): frames equal to the single-device engine's."""
    _, tree = engines
    plan = ExecutionPlan(shards=4, fusion="group")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        split, one = (SREngine.from_params(tree, CFG, plan=plan, device="cpu") for _ in range(2))
    split.devices = CPU4
    a, b = split.upscale(FRAMES[0]), one.upscale(FRAMES[0])
    np.testing.assert_array_equal(a.ids, b.ids)
    torch.testing.assert_close(a.image, b.image, **FWD_TOL)
    a, b = split.serve(FRAMES[1]), one.serve(FRAMES[1])
    assert a.shard_counts == b.shard_counts and a.shard_thresholds == b.shard_thresholds
    torch.testing.assert_close(a.image, b.image, **FWD_TOL)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

def _build_both(tree, ref, plan_kw, **kw):
    with warnings.catch_warnings(record=True) as mine_w:
        warnings.simplefilter("always")
        mine = SREngine.from_params(tree, CFG, plan=ExecutionPlan(**plan_kw), device="cpu",
                                    **kw)
    with warnings.catch_warnings(record=True) as their_w:
        warnings.simplefilter("always")
        theirs = JEngine(ref.params, JCFG, plan=JPlan(**plan_kw), **kw)
    return mine, theirs, [str(w.message) for w in mine_w], [str(w.message) for w in their_w]


@pytest.mark.parametrize("shards", [3, 4, 8])
@pytest.mark.parametrize("deadline", [None, 1e-9])
def test_sharded_engine_matches_reference(engines, shards, deadline):
    ref, tree = engines
    sw = dict(c54_per_sec_budget=10 ** 6, frame_high=6, frame_low=2)
    mine, theirs, mw, tw = _build_both(tree, ref, dict(shards=shards),
                                       switching=SwitchingConfig(**sw), deadline_s=deadline)
    assert mw == tw and len(mw) == 1 and "single-device" in mw[0]
    # upscale: the plan's thresholds, the shard count reported, no strips
    a, b = mine.upscale(FRAMES[0]), theirs.upscale(FRAMES[0])
    assert a.shards == b.shards == shards and a.shard_counts is None
    np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
    np.testing.assert_allclose(a.image.numpy(), np.asarray(b.image), **IMG_TOL)
    assert a.summary()["shards"] == b.summary()["shards"] == shards
    for frame in FRAMES + FRAMES[::-1]:
        a, b = mine.serve(frame), theirs.serve(frame)
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
        assert a.counts == b.counts
        assert a.shard_counts == b.shard_counts
        assert a.shard_thresholds == b.shard_thresholds
        assert a.shard_deadline_missed == b.shard_deadline_missed
        assert a.thresholds == b.thresholds and a.deadline_missed == b.deadline_missed
        np.testing.assert_allclose(a.image.numpy(), np.asarray(b.image), **IMG_TOL)
    assert sum(sum(c) for c in a.shard_counts) == a.n_patches
    if deadline:
        assert all(r.deadline_missed for r in mine.stats)
        assert any(any(r.shard_deadline_missed) for r in mine.stats)
    s, t = mine.summary(), theirs.summary()
    assert set(s) == set(t)
    want = {k: v for k, v in t.items() if k not in TIMING}
    want["backend"] = "cuda-plain"
    assert {k: v for k, v in s.items() if k not in TIMING} == want


def test_straggler_demotion_drops_the_heavy_strip_like_reference(engines):
    """tests/test_sharded_pipeline.py's straggler frame: a noisy top strip
    and a flat bottom under an impossible deadline; the heavy shard is
    demoted, frame after frame, exactly as the reference demotes it."""
    ref, tree = engines
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (32, 64, 3)))
    frame = np.concatenate([noise, np.full((32, 64, 3), 0.5, np.float32)])
    sw = dict(c54_per_sec_budget=10 ** 9, frame_high=10 ** 6, frame_low=0)
    mine, theirs, _, _ = _build_both(tree, ref, dict(shards=3), deadline_s=1e-9,
                                     switching=SwitchingConfig(**sw))
    first = mine.serve(frame)
    heavy = int(np.argmax([c[2] for c in first.shard_counts]))
    assert first.shard_deadline_missed[heavy]
    for i in range(12):
        a, b = (first, theirs.serve(frame)) if i == 0 else (mine.serve(frame), theirs.serve(frame))
        assert a.shard_counts == b.shard_counts and a.shard_thresholds == b.shard_thresholds
        assert a.shard_deadline_missed == b.shard_deadline_missed
    assert a.shard_counts[heavy][2] < first.shard_counts[heavy][2]


def test_fused_dispatch_reports_shard_counts_only(engines):
    ref, tree = engines
    mine, theirs, mw, tw = _build_both(tree, ref, dict(shards=4, dispatch="fused"))
    assert mw == tw
    for frame in FRAMES:
        a, b = mine.serve(frame), theirs.serve(frame)
        assert a.dispatch == b.dispatch == "fused"
        assert a.shard_counts == b.shard_counts and a.shard_counts is not None
        assert a.shard_thresholds is b.shard_thresholds is None
        assert a.shard_deadline_missed is b.shard_deadline_missed is None
        np.testing.assert_array_equal(a.ids.numpy(), np.asarray(b.ids))
    u = mine.upscale(FRAMES[0])
    assert u.dispatch == "fused" and u.shards == 4 and u.shard_counts is None
    s, t = mine.summary(), theirs.summary()
    assert s["shards"] == t["shards"] == 4
    assert s["shard_deadline_misses"] == t["shard_deadline_misses"] == [0] * 4
    assert "final_shard_thresholds" not in s and "final_shard_thresholds" not in t


def test_fused_over_several_devices_is_refused(engines):
    """Fused dispatch and serve_streams over more than one distinct device
    raise (ROADMAP item 12b) instead of running on one device unannounced;
    host dispatch over the same devices is not refused."""
    _, tree = engines
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = SREngine.from_params(tree, CFG, plan=ExecutionPlan(shards=2, dispatch="fused"),
                                   device="cpu")
        mux = SREngine.from_params(tree, CFG, plan=ExecutionPlan(shards=2, dispatch="fused",
                                                                 streams=2), device="cpu")
    two = (torch.device("cuda", 0), torch.device("cuda", 1))
    eng.devices = mux.devices = two
    with pytest.raises(ValueError, match="12b"):
        eng.upscale(FRAMES[0])
    with pytest.raises(ValueError, match="12b"):
        eng.serve(FRAMES[0])
    with pytest.raises(ValueError, match="12b"):
        list(mux.serve_streams([FRAMES[:1], FRAMES[1:2]]))
    eng.devices = CPU4                       # one device named four times: served
    assert eng.upscale(FRAMES[0]).dispatch == "fused"
    r = eng.upscale(FRAMES[0], plan=eng.plan.replace(dispatch="host"))
    assert r.dispatch == "host"


def test_plan_shards_rule_matches_reference():
    for bad in (0, -1, 1.5, True, "2"):
        with pytest.raises(ValueError) as mine:
            ExecutionPlan(shards=bad)
        with pytest.raises(ValueError) as theirs:
            JPlan(shards=bad)
        assert str(mine.value) == str(theirs.value)
    assert ExecutionPlan(shards=4).shards == JPlan(shards=4).shards == 4
