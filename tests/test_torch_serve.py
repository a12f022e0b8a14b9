"""The port's streaming half against ``repro``: the Algorithm-1 controller
(``core.adaptive``), ``SREngine.serve`` / ``stream`` under host dispatch,
the reporting (``FrameResult.summary``, ``summarize_stats``), the serving
ledger and the retired ``FrameServer`` shim. On the CPU, x2, the golden
mixed frame of tests/test_fused_dispatch.py.

Tolerances: ids, counts, thresholds and deadline flags equal; scores rtol
1e-5 / atol 1e-5 and images rtol 1e-3 / atol 1e-3, as tests/test_torch_slice.py
holds them (fp32 sums in another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core.adaptive import AdaptiveSwitcher as JSwitcher
from repro.core.adaptive import SwitchingConfig as JSwitching
from repro.data.synthetic import degrade, random_image
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.api import ExecutionPlan, FrameResult, SREngine
from repro_torch.core.adaptive import AdaptiveSwitcher, SwitchingConfig
from repro_torch.models.essr import ESSRConfig

CFG, JCFG = ESSRConfig(scale=2), JCfg(scale=2)
IMG_TOL = dict(rtol=1e-3, atol=1e-3)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
#: Timing fields: compared by presence only.
TIMING = ("mean_latency_s", "compiled_caches")


def _golden_frame(hw: int = 128, seed: int = 1234) -> np.ndarray:
    yy, xx = jnp.meshgrid(jnp.linspace(0, 1, hw), jnp.linspace(0, 1, hw), indexing="ij")
    smooth = jnp.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = degrade(jnp.asarray(random_image(seed, 2 * hw, 2 * hw)), 2)
    return np.asarray(jnp.where((yy < 0.5)[..., None], smooth, tex))


FRAMES = [_golden_frame(seed=1234 + i) for i in range(4)]


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
    ref = JEngine.from_config(JCFG, seed=1)
    return ref, jax.tree_util.tree_map(np.asarray, ref.params)


@pytest.fixture(scope="module")
def ref_streams(engines):
    """The reference's stream of FRAMES, once per deadline."""
    ref, _ = engines
    out = {}
    for deadline in (None, 1e-9):
        eng = JEngine(ref.params, JCFG, deadline_s=deadline)
        out[deadline] = (list(eng.stream(FRAMES)), eng.summary())
    return out


# ---------------------------------------------------------------------------
# the Algorithm-1 controller, frame by frame against the reference
# ---------------------------------------------------------------------------

def _scores(rng, n: int, high: float) -> np.ndarray:
    """n patch scores, a ``high`` share of them past t2 = 40 and the rest
    spread below, float32 like the edge unit's."""
    s = rng.uniform(0.0, 39.0, n)
    s[rng.random(n) < high] = rng.uniform(40.0, 120.0)
    return s.astype(np.float32)


#: name -> (SwitchingConfig kwargs, frames, patches a frame, C54 share
#: per frame as a function of the frame index, straggler severities by frame)
SWITCHER_CASES = {
    # trims up past frame_high and down past frame_low, and holds between
    "trims": (dict(frame_high=60, frame_low=20, fps=30), 24, 200,
              lambda i: (0.5, 0.05, 0.2)[i % 3], {}),
    # a 50-C54 budget a second of 3 frames: the ceiling demotes the rest of
    # a second's C54 patches to C27, and is lifted at each roll-over
    "ceiling": (dict(c54_per_sec_budget=50, fps=3, frame_high=10 ** 6, frame_low=0),
                10, 120, lambda i: 0.25, {}),
    # straggler demotion at several severities between trims
    "straggler": (dict(frame_high=80, frame_low=10), 12, 150,
                  lambda i: (0.02, 0.4, 0.1)[i % 3], {1: 1.0, 4: 0.5, 5: 2.0, 9: 3.0}),
    # thresholds pushed into both bounds, and t2 <= t1 repaired
    "clamp": (dict(t1=6.0, t2=9.0, t1_bounds=(2.0, 12.0), t2_bounds=(1.0, 14.0),
                   frame_high=30, frame_low=25, t2_step=3.0), 20, 100,
              lambda i: 0.9 if i < 12 else 0.0, {3: 4.0}),
}


@pytest.mark.parametrize("case", sorted(SWITCHER_CASES))
def test_switcher_matches_reference(case):
    kw, frames, n, share, demote = SWITCHER_CASES[case]
    mine, theirs = AdaptiveSwitcher(SwitchingConfig(**kw)), JSwitcher(JSwitching(**kw))
    rng = np.random.default_rng(sorted(SWITCHER_CASES).index(case))
    seen = set()
    for i in range(frames):
        s = _scores(rng, n, share(i))
        a, b = mine.assign(s), np.asarray(theirs.assign(s))
        np.testing.assert_array_equal(a, b)
        if i in demote:
            mine.demote_for_straggler(demote[i])
            theirs.demote_for_straggler(demote[i])
        assert mine.thresholds == theirs.thresholds
        seen.add(mine.thresholds)
    assert len(seen) > 1 or case == "ceiling"
    # observe_frame alone (fused dispatch's feedback) moves both alike
    for c54 in (0, 5 * n, n // 4, 10 ** 6):
        mine.observe_frame(c54)
        theirs.observe_frame(c54)
        assert mine.thresholds == theirs.thresholds


def test_switcher_ceiling_and_rollover():
    """The ceiling demotes in raster order and lifts at the second's end."""
    sw = AdaptiveSwitcher(SwitchingConfig(c54_per_sec_budget=5, fps=2, frame_high=10 ** 6,
                                          frame_low=0))
    s = np.full(4, 50.0, np.float32)
    assert sw.assign(s).tolist() == [2, 2, 2, 2]
    assert sw.assign(s).tolist() == [2, 1, 1, 1]      # 1 left in this second
    assert sw.assign(s).tolist() == [2, 2, 2, 2]      # a new second


# ---------------------------------------------------------------------------
# serve / stream against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,label", [("cuda", "cuda-plain"), ("ref", "ref")])
@pytest.mark.parametrize("deadline", [None, 1e-9])
def test_stream_matches_reference(engines, ref_streams, deadline, backend, label):
    _, tree = engines
    theirs, their_summary = ref_streams[deadline]
    eng = SREngine.from_params(tree, CFG, backend=backend, device="cpu", deadline_s=deadline)
    mine = list(eng.stream(FRAMES))
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        assert a.mode == "edge_select" and a.dispatch == "host" and a.backend == label
        assert a.counts == b.counts and a.thresholds == b.thresholds
        assert a.deadline_missed == b.deadline_missed == (deadline is not None)
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
        np.testing.assert_allclose(a.scores, np.asarray(b.scores), **SCORE_TOL)
        np.testing.assert_allclose(a.image.numpy(), np.asarray(b.image), **IMG_TOL)
        assert a.mac_saving == pytest.approx(b.mac_saving, abs=1e-12)
    # the thresholds moved (the default trim lowers them on the golden mix)
    # unless every frame missed its deadline, which puts them back
    assert len({r.thresholds for r in mine}) == (1 if deadline else 4)
    summary = eng.summary()
    assert set(summary) == set(their_summary)
    want = {k: v for k, v in their_summary.items() if k not in TIMING}
    want["backend"] = label
    assert {k: v for k, v in summary.items() if k not in TIMING} == want
    assert all(r.image is None and r.ids is None and r.scores is None for r in eng.stats)


def test_serve_refuses_a_forced_policy(engines):
    ref, tree = engines
    eng = SREngine.from_params(tree, CFG, device="cpu", plan=ExecutionPlan(subnet_policy="all_c27"))
    theirs = JEngine(ref.params, JCFG, plan=JPlan(subnet_policy="all_c27"))
    with pytest.raises(ValueError) as mine:
        eng.serve(FRAMES[0])
    with pytest.raises(ValueError) as their:
        theirs.serve(FRAMES[0])
    assert str(mine.value) == str(their.value)
    with pytest.raises(ValueError, match="forced"):
        next(eng.stream(FRAMES))


def test_iterator_that_raises_retires_the_stream(engines):
    ref, tree = engines
    small = [f[:64, :64].copy() for f in FRAMES[:2]]

    def frames():
        yield from small
        raise OSError("camera unplugged")

    eng = SREngine.from_params(tree, CFG, device="cpu")
    theirs = JEngine(ref.params, JCFG)
    mine, their = list(eng.stream(frames())), list(theirs.stream(frames()))
    assert len(mine) == len(their) == 2
    s, t = eng.summary(), theirs.summary()
    assert s["degradations"] == t["degradations"]
    assert s["degradations"]["by_kind"] == {"retire": 1}
    assert "camera unplugged" in s["degradations"]["events"][0]["reason"]


def test_poison_events_in_the_ledger(engines):
    ref, tree = engines
    frame = FRAMES[0][:64, :64].copy()
    frame[3, 4, 1] = np.nan
    plan = dict(on_poison="bilinear")
    eng = SREngine.from_params(tree, CFG, device="cpu", plan=ExecutionPlan(**plan))
    theirs = JEngine(ref.params, JCFG, plan=JPlan(**plan))
    a, b = eng.serve(frame), theirs.serve(frame)
    assert a.health == b.health == (1, 0, 0) and a.counts == b.counts == (9, 0, 0)
    assert eng.summary()["degradations"] == theirs.summary()["degradations"]
    assert eng.summary()["poison_frames"] == 1


def test_frame_server_shim_raises():
    from repro.runtime.serving import FrameServer as JFrameServer
    from repro_torch.runtime.serving import FrameServer
    with pytest.raises(RuntimeError, match="repro_torch.api.SREngine"):
        FrameServer()
    with pytest.raises(RuntimeError, match="FrameServer was removed"):
        JFrameServer()


def test_frame_result_summary_matches_reference(engines):
    ref, tree = engines
    a = SREngine.from_params(tree, CFG, backend="ref", device="cpu").upscale(FRAMES[0])
    b = ref.upscale(FRAMES[0])
    mine, theirs = a.summary(), b.summary()
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if k not in ("latency_s", "compiled_caches")} == \
        {k: v for k, v in theirs.items() if k not in ("latency_s", "compiled_caches")}
    assert set(mine["compiled_caches"]["get_geometry"]) == \
        set(theirs["compiled_caches"]["get_geometry"])


def test_stats_window_rotation(engines):
    _, tree = engines
    eng = SREngine.from_params(tree, CFG, device="cpu", plan=ExecutionPlan(stats_window=2),
                               switching=SwitchingConfig(frame_high=10 ** 9, frame_low=0))
    frame = FRAMES[0][:64, :64].copy()
    for _ in range(4):
        assert isinstance(eng.serve(frame), FrameResult)
    assert len(eng.stats) == 2
    s = eng.summary()
    assert s["frames"] == 2 and s["stats_window"] == 2 and s["deadline_misses"] == 0
    assert s["final_thresholds"] == (8.0, 40.0)
    assert not hasattr(eng, "stats_total")
