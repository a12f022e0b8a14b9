"""The port's fused single dispatch (``ExecutionPlan(dispatch="fused")``)
against ``repro`` and against its own host dispatch, on the CPU (x2, the
golden mixed frame of tests/test_fused_dispatch.py, counts (10, 2, 13)).
On the CPU the fused frame runs eagerly; on the card it is one CUDA graph
replay (tests/test_torch_cuda.py).

Contract: the capacity helpers equal the reference's; with no spill a
fused frame routes as host dispatch does and its image is ``torch.equal``
to the host frame's (every kernel computes each patch on its own, so the
zero-padded slots change nothing), in fp32, int8 and fxp10; images against
the JAX engine at rtol 1e-3 / atol 1e-3 (tests/test_torch_slice.py);
spills, growth, the stream's C54 ceiling, the in-flight stream and the
bookkeeping as the reference's own tests assert them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core import pipeline as jpl
from repro.data.synthetic import degrade, random_image
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.api import ExecutionPlan, FrameResult, SREngine
from repro_torch.core import pipeline as pl
from repro_torch.core import subnet_policy as sp
from repro_torch.core.adaptive import SwitchingConfig
from repro_torch.core.patching import get_geometry
from repro_torch.models.essr import ESSRConfig
from repro_torch.runtime.guard import PoisonFrameError

CFG, JCFG = ESSRConfig(scale=2), JCfg(scale=2)
GOLDEN_COUNTS = (10, 2, 13)
IMG_TOL = dict(rtol=1e-3, atol=1e-3)


def _golden_frame(hw: int = 128, seed: int = 1234) -> np.ndarray:
    yy, xx = jnp.meshgrid(jnp.linspace(0, 1, hw), jnp.linspace(0, 1, hw), indexing="ij")
    smooth = jnp.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = degrade(jnp.asarray(random_image(seed, 2 * hw, 2 * hw)), 2)
    return np.asarray(jnp.where((yy < 0.5)[..., None], smooth, tex))


def _stable_switching() -> SwitchingConfig:
    """Frozen thresholds: a stream compared across dispatch paths must not
    route differently because the thresholds moved."""
    return SwitchingConfig(frame_high=10 ** 9, frame_low=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors, run beside other test processes: one intra-op thread
    each keeps the CPU's threads from contending (put back afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    ref = JEngine.from_config(JCFG, seed=1, plan=JPlan(dispatch="fused"))
    return ref, jax.tree_util.tree_map(np.asarray, ref.params)


def _port(tree, backend="cuda", **kw):
    switching = kw.pop("switching", None)
    return SREngine.from_params(tree, CFG, backend=backend, device="cpu",
                                plan=ExecutionPlan(**kw), switching=switching)


# ---------------------------------------------------------------------------
# the capacity helpers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kw", [(0, {}), (5, {}), (9, {}), (9, dict(n_total=12)),
                                  (3, dict(buckets=(4, 32))), (5000, {}), (100, dict(n_total=64))])
def test_snap_capacity_matches_reference(n, kw):
    assert pl.snap_capacity(n, **kw) == jpl.snap_capacity(n, **kw)


def test_capacity_route_cascade():
    ids = np.array([2, 2, 1, 2, 0, 2, 1, 2])
    eff, spills = pl.capacity_route(torch.from_numpy(ids), (0, 3, 2))
    assert eff.tolist() == [2, 2, 1, 1, 0, 1, 0, 0]
    assert spills.tolist() == [0, 2, 3] and spills.dtype == torch.int32


@pytest.mark.parametrize("seed,caps", [(0, (0, 3, 2)), (1, (0, 0, 4)), (2, (0, 5, 0)),
                                       (3, (0, 16, 16)), (4, (0, 1, 1))])
def test_capacity_route_dispatch_combine_match_reference(seed, caps):
    rng = np.random.default_rng(seed)
    n = 13
    ids = rng.integers(0, 3, n)
    patches = rng.random((n, 4, 4, 3), np.float32)
    out = rng.random((n, 8, 8, 3), np.float32)
    eff, spills = pl.capacity_route(torch.from_numpy(ids), caps)
    jeff, jspills = jpl.capacity_route(jnp.asarray(ids, jnp.int32), caps)
    np.testing.assert_array_equal(eff.numpy(), np.asarray(jeff))
    np.testing.assert_array_equal(spills.numpy(), np.asarray(jspills))
    for k in (1, 2):
        if caps[k] == 0:
            continue
        disp, slot, member = pl.capacity_dispatch(torch.from_numpy(patches), eff, k, caps[k])
        jdisp, jslot, jmember = jpl.capacity_dispatch(jnp.asarray(patches), jeff, k, caps[k])
        np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(member.numpy(), np.asarray(jmember))
        sr = rng.random((caps[k], 8, 8, 3), np.float32)
        got = pl.capacity_combine(torch.from_numpy(out), torch.from_numpy(sr), slot, member)
        want = jpl.capacity_combine(jnp.asarray(out), jnp.asarray(sr), jslot, jmember)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decide_compares_in_the_scores_precision():
    """The device decide matches the host decide at the threshold's fp32
    rounding: a score equal to float32(t) routes up on both."""
    t1, t2 = 8.1, 40.3
    s = np.array([np.float32(t1), np.nextafter(np.float32(t1), 0), np.float32(t2),
                  np.nextafter(np.float32(t2), 0), 0.0, 255.0], np.float32)
    got = pl._decide(torch.from_numpy(s), torch.tensor(t1), torch.tensor(t2))
    np.testing.assert_array_equal(got.numpy(), sp.decide(s, t1, t2))


# ---------------------------------------------------------------------------
# the fused frame against the reference and against host dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,label", [("cuda", "cuda-plain"), ("ref", "ref")])
def test_fused_upscale_matches_reference(engines, backend, label):
    ref, tree = engines
    frame = _golden_frame()
    rj = ref.upscale(frame)
    rp = _port(tree, backend, dispatch="fused").upscale(frame)
    assert rp.dispatch == rj.dispatch == "fused" and rp.backend == label
    assert rp.counts == rj.counts == GOLDEN_COUNTS
    assert rp.spill_counts == rj.spill_counts == (0, 0, 0)
    np.testing.assert_array_equal(rp.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_allclose(rp.scores.numpy(), np.asarray(rj.scores), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)
    assert rp.mac_saving == pytest.approx(rj.mac_saving, abs=1e-12)
    assert rp.thresholds == rj.thresholds and rp.health == rj.health == (0, 0, 0)


@pytest.mark.parametrize("quant", [None, "int8", "fxp10"])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_fused_frame_equals_host_frame(engines, backend, quant, tmp_path):
    _, tree = engines
    frame = _golden_frame()
    host, fused = (SREngine.from_params(tree, CFG, backend=backend, device="cpu",
                                        quant_cache=str(tmp_path),
                                        plan=ExecutionPlan(quant=quant, dispatch=d))
                   for d in ("host", "fused"))
    assert fused.qpack == host.qpack
    rh, rf = host.upscale(frame), fused.upscale(frame)
    assert rf.backend == rh.backend and rf.dispatch == "fused" and rh.dispatch == "host"
    assert rf.counts == rh.counts == GOLDEN_COUNTS and rf.spill_counts == (0, 0, 0)
    np.testing.assert_array_equal(rf.ids.numpy(), rh.ids)
    np.testing.assert_array_equal(rf.scores.numpy(), rh.scores)
    assert torch.equal(rf.image, rh.image)


def test_direct_fused_frame_forward(engines):
    ref, tree = engines
    eng = _port(tree)
    frame = torch.tensor(_golden_frame())
    g = get_geometry(128, 128, 32, 2, CFG.scale, "cpu")
    caps = tuple(pl.snap_capacity(c, n_total=g.n) for c in GOLDEN_COUNTS)
    img, ids, scores, counts, spills, health = pl._fused_frame_forward(
        eng.params, frame, CFG, geometry=g, caps=caps)
    want = eng.upscale(frame)
    np.testing.assert_array_equal(ids.numpy(), want.ids)
    assert counts.tolist() == list(GOLDEN_COUNTS)
    assert not spills.any() and not health.any()
    assert torch.equal(img, want.image)


# ---------------------------------------------------------------------------
# capacity: spills, growth, the stream's C54 ceiling
# ---------------------------------------------------------------------------

def test_pinned_capacity_spills_as_reference(engines):
    ref, tree = engines
    frame = _golden_frame()
    theirs = JEngine(ref.params, JCFG, plan=JPlan(dispatch="fused", capacity=(0, 8, 4)))
    pin = _port(tree, dispatch="fused", capacity=(0, 8, 4))
    rj, r1, r2 = theirs.upscale(frame), pin.upscale(frame), pin.upscale(frame)
    # C54 wants 13, keeps 4; 9 spill into C27, which keeps 8 of 11
    assert r1.spill_counts == rj.spill_counts == (0, 3, 9)
    assert r1.counts == rj.counts == (13, 8, 4)
    np.testing.assert_array_equal(r1.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_allclose(r1.image.numpy(), np.asarray(rj.image), **IMG_TOL)
    assert torch.equal(r1.ids, r2.ids) and torch.equal(r1.image, r2.image)
    host = _port(tree).upscale(frame)
    np.testing.assert_array_equal(np.flatnonzero(r1.ids.numpy() == sp.C54),
                                  np.flatnonzero(host.ids == sp.C54)[:4])


def test_capacity_grows_after_spill(engines):
    _, tree = engines
    yy, _ = np.meshgrid(np.linspace(0, 1, 128), np.linspace(0, 1, 128), indexing="ij")
    smooth = np.stack([yy] * 3, axis=-1).astype(np.float32)
    eng = _port(tree, dispatch="fused")
    assert eng.upscale(smooth).counts[sp.C54] == 0       # probe: everything bilinear
    busy = eng.upscale(_golden_frame())                  # past the probed profile
    assert any(busy.spill_counts) and busy.compiled
    again = eng.upscale(_golden_frame())                 # the profile grew
    assert again.spill_counts == (0, 0, 0) and again.counts == GOLDEN_COUNTS
    assert again.compiled is False                       # a new profile's first frame


def test_stream_c54_ceiling_even_when_seeded_by_upscale(engines):
    _, tree = engines
    budget = SwitchingConfig(c54_per_sec_budget=4 * 30, fps=30, frame_high=10 ** 9,
                             frame_low=0)
    eng = _port(tree, dispatch="fused", switching=budget)
    up = eng.upscale(_golden_frame())
    assert up.counts == GOLDEN_COUNTS and up.spill_counts == (0, 0, 0)
    st = eng.serve(_golden_frame())
    assert st.counts[sp.C54] <= 4
    assert st.spill_counts[sp.C54] == GOLDEN_COUNTS[sp.C54] - 4
    up2 = eng.upscale(_golden_frame())
    assert up2.counts == GOLDEN_COUNTS and up2.spill_counts == (0, 0, 0)
    # a pinned profile is served verbatim, streaming or not
    pin = _port(tree, dispatch="fused", capacity=(0, 16, 16), switching=budget)
    r = pin.serve(_golden_frame())
    assert r.counts == GOLDEN_COUNTS and r.spill_counts == (0, 0, 0)


def test_plan_capacity_must_match_the_subnets(engines):
    _, tree = engines
    with pytest.raises(ValueError, match="one entry per"):
        _port(tree, dispatch="fused", capacity=(0, 8)).upscale(_golden_frame())


# ---------------------------------------------------------------------------
# the stream: in flight against synchronous, the control delay, records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inflight", [2, 3])
def test_inflight_stream_matches_sync_stream(engines, inflight):
    _, tree = engines
    frames = [_golden_frame(seed=1234 + i) for i in range(4)]

    def run(n):
        return list(_port(tree, dispatch="fused", capacity=(0, 16, 16), inflight=n,
                          switching=_stable_switching()).stream(frames))

    sync, flight = run(1), run(inflight)
    assert len(sync) == len(flight) == 4
    for a, b in zip(sync, flight):
        assert a.counts == b.counts and a.spill_counts == b.spill_counts
        assert torch.equal(a.ids, b.ids) and torch.equal(a.image, b.image)


def test_inflight_control_delay_is_one_frame(engines):
    _, tree = engines
    frames = [_golden_frame(seed=s) for s in (7, 8, 9)]
    trig = SwitchingConfig(frame_high=5, frame_low=0)       # golden C54 = 13 > 5

    def run(n):
        return list(_port(tree, dispatch="fused", capacity=(0, 32, 32), inflight=n,
                          switching=trig).stream(frames))

    sync, flight = run(1), run(2)
    assert sync[0].counts == flight[0].counts
    assert sync[0].thresholds == (sp.DEFAULT_T1 + trig.t1_step, sp.DEFAULT_T2 + trig.t2_step)
    # the in-flight frame 1 was launched before frame 0 finished: it routed
    # at the initial thresholds, as a plain upscale of it does
    plain = _port(tree, dispatch="fused", capacity=(0, 32, 32)).upscale(frames[1])
    assert flight[1].counts == plain.counts


def test_fused_stream_records_and_summary(engines):
    _, tree = engines
    eng = _port(tree, dispatch="fused", inflight=2, stats_window=2,
                switching=_stable_switching())
    out = list(eng.stream([_golden_frame()] * 3))
    assert all(isinstance(r, FrameResult) and r.dispatch == "fused" for r in out)
    assert len(eng.stats) == 2
    s = eng.summary()
    assert s["frames"] == 2 and s["stats_window"] == 2 and s["spilled_patches"] == [0, 0, 0]
    assert all(r.image is None and r.ids is None for r in eng.stats)


# ---------------------------------------------------------------------------
# warm-up and the compiled flag; modes that stay on host dispatch; poison
# ---------------------------------------------------------------------------

def test_warmup_and_compiled_flag(engines):
    _, tree = engines
    eng = _port(tree, dispatch="fused")
    w = eng.warmup((128, 128))
    assert w.compiled is False and w.dispatch == "fused"
    assert all(c > 0 for c in w.counts)
    assert len(eng.stats) == 0
    assert eng.warmup((128, 128)).compiled is True


def test_summary_excludes_warmup_frames(engines):
    _, tree = engines
    eng = _port(tree, dispatch="fused", capacity=(0, 16, 16), switching=_stable_switching())
    out = list(eng.stream([_golden_frame()] * 3))
    assert out[0].compiled is False and out[1].compiled is True
    s = eng.summary()
    assert s["warmup_frames_excluded"] == 1
    assert abs(s["mean_latency_s"] - float(np.mean([r.latency_s for r in out[1:]]))) < 1e-9


def test_fused_falls_back_to_host_for_other_modes(engines):
    _, tree = engines
    eng = _port(tree, dispatch="fused")
    frame = _golden_frame(64)
    r = eng.upscale(frame, mode="all_patches", width=CFG.channels)
    assert r.dispatch == "host" and r.spill_counts is None
    assert eng.upscale(frame, ids_override=np.zeros(r.n_patches, np.int64)).dispatch == "host"
    assert eng.reference(frame).dispatch == "host"
    forced = _port(tree, dispatch="fused", subnet_policy="all_c27").upscale(frame)
    assert forced.dispatch == "host" and forced.mode == "all_patches"


@pytest.mark.parametrize("kind", ["nan", "inf", "range", "dtype"])
def test_on_poison_under_fused_dispatch(engines, kind):
    ref, tree = engines
    clean = np.random.default_rng(0).random((64, 64, 3), np.float32)
    bad = (clean * 255).astype(np.uint8) if kind == "dtype" else clean.copy()
    if kind != "dtype":
        bad[4:12, 4:12, :] = {"nan": np.nan, "inf": np.inf, "range": 3.0e6}[kind]
    eng = {pol: _port(tree, dispatch="fused", on_poison=pol, switching=_stable_switching())
           for pol in ("raise", "sanitize", "bilinear", "off")}
    with pytest.raises(PoisonFrameError):
        eng["raise"].upscale(bad)
    assert eng["raise"].upscale(clean).health == (0, 0, 0)       # not wedged
    assert eng["raise"].summary()["degradations"]["by_kind"] == {"poison": 1}
    for pol in ("sanitize", "bilinear"):
        r = eng[pol].upscale(bad)
        assert bool(torch.isfinite(r.image).all())
        if kind == "dtype":
            assert r.health == (0, 0, 0)
        else:
            assert any(r.health)
            if pol == "bilinear":
                assert not r.ids.any() and r.counts == (9, 0, 0)
    assert eng["off"].upscale(bad if kind == "range" else clean).health is None
    if kind == "nan":
        theirs = JEngine(ref.params, JCFG, plan=JPlan(dispatch="fused", on_poison="bilinear"))
        rj, rp = theirs.upscale(bad), eng["bilinear"].upscale(bad)
        assert rp.health == rj.health and rp.counts == rj.counts
        np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)
        a = _port(tree, dispatch="fused", on_poison="off").upscale(clean)
        b = eng["sanitize"].upscale(clean)
        assert torch.equal(a.image, b.image)                     # bit-equal on clean frames
