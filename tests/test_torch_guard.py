"""The port's serving resilience (``runtime.guard``: `FaultPlan`,
`FaultInjector`, the degradation ladder, `ResilienceGuard`; the plan fields
``faults``, ``max_retries``, ``quarantine_ticks``, ``watchdog_s``) against
``repro``'s, on the CPU, x2, 64x64 frames: the claims of
tests/test_guard.py on the injector, the ladder, the watchdog and the
multiplexer's quarantine.

Standards: the injector's coins, poisoned frames and schedules equal byte
for byte; the ladders' steps equal (the port's "cuda" backend against the
reference's "pallas" with the interpreter resolved, as on the CPU: neither
has an interpret rung); under the same `FaultPlan` and frames the ledgers
(``summary()["degradations"]``) equal, and so do the per-frame steps,
labels, stream ids and health; a healthy tenant's frames torch.equal to a
run without faults (port against port, capacity pinned). Watchdog events
depend on timing and are only checked for presence.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core.adaptive import SwitchingConfig as JSwitching
from repro.models.essr import ESSRConfig as JCfg
from repro.models.essr import init_essr
from repro.runtime import guard as jguard
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core.adaptive import SwitchingConfig
from repro_torch.models.essr import ESSRConfig
from repro_torch.runtime.guard import (FaultInjector, FaultPlan, InjectedBackendFailure,
                                       PoisonFrameError, ResilienceGuard, build_ladder)

CFG, JCFG = ESSRConfig(scale=2), JCfg(scale=2)
HW = 64
STABLE = dict(frame_high=10 ** 9, frame_low=0)


def _clean_frame(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((HW, HW, 3), np.float32)


FRAMES = [[_clean_frame(100 * s + i) for i in range(4)] for s in range(3)]


class Boom:
    """A tenant iterator that yields one frame, then raises."""

    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        yield self.frames[0]
        raise RuntimeError("tenant iterator died")


#: name -> (engine kwargs (plan kwargs in "plan"), how to serve: "upscale" n
#: frames, "stream", or "mux" with the tenants): the runs held against the
#: JAX engine. "backend" runs the port's "cuda" against the reference's
#: "pallas" (neither compiles a kernel: every level-0 launch fails first);
#: the quant rung's ledger is held by test_guard_run_steps_retries_and_raises
#: and the ladders' equality (a quantized engine here would calibrate twice).
RUNS = {
    "backend": (dict(backend="pallas", plan=dict(faults=dict(seed=4, backend_failure_rate=1.0))),
                "upscale"),
    "fusion": (dict(backend="ref", plan=dict(fusion="group",
                                             faults=dict(seed=4, backend_failure_rate=1.0))),
               "upscale"),
    "partial": (dict(backend="ref", plan=dict(fusion="group",
                                              faults=dict(seed=9, backend_failure_rate=0.4))),
                "upscale"),
    "stream": (dict(backend="ref", plan=dict(on_poison="sanitize", faults=dict(
        seed=5, poison_rate=0.5, poison_kinds=("nan", "range", "dtype"),
        iterator_error_rate=0.15))), "stream"),
    "mux_poison": (dict(backend="ref", plan=dict(streams=3, capacity=(0, 9, 9),
                                                 quarantine_ticks=1, faults=dict(
        seed=7, poison_rate=1.0, poison_kinds=("nan",), target_streams=(1,)))), "mux"),
    "mux_retire": (dict(backend="ref", plan=dict(streams=3, capacity=(0, 9, 9), faults=dict(
        seed=7, poison_rate=1.0, poison_kinds=("inf",), target_streams=(1,)))), "mux"),
    "mux_sanitize": (dict(backend="ref", plan=dict(
        streams=3, capacity=(0, 9, 9), on_poison="sanitize", faults=dict(
            seed=7, poison_rate=1.0, poison_kinds=("nan",), target_streams=(1,)))), "mux"),
    "mux_boom": (dict(backend="ref", plan=dict(streams=3, capacity=(0, 9, 9))), "boom"),
    "mux_chaos": (dict(backend="ref", plan=dict(streams=3, quarantine_ticks=2, fusion="group",
                                                faults=dict(
        seed=11, poison_rate=0.3, poison_kinds=("nan", "inf"), iterator_error_rate=0.1,
        backend_failure_rate=0.5))), "mux"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors, run beside other test processes: one intra-op thread
    each keeps the CPU's threads from contending (put back afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    p = init_essr(jax.random.PRNGKey(0), JCFG)
    return p, jax.tree_util.tree_map(np.asarray, p)


def _serve(eng, how):
    if how == "upscale":
        out = []
        for f in FRAMES[0]:
            out.append(eng.upscale(f))
        return out
    if how == "stream":
        return list(eng.stream(FRAMES[0] + FRAMES[1]))
    if how == "boom":
        return list(eng.serve_streams([FRAMES[0], Boom(FRAMES[1]), FRAMES[2]]))
    return list(eng.serve_streams(FRAMES))


def _run(name, tree=None, p=None):
    """One run of RUNS[name]: the port's engine on ``tree``, or the
    reference's on ``p``; returns (engine, results)."""
    kw, how = RUNS[name]
    plan = dict(kw["plan"], dispatch="fused")
    faults = plan.pop("faults", None)
    if tree is not None:
        backend = {"pallas": "cuda"}.get(kw["backend"], kw["backend"])
        eng = SREngine.from_params(
            tree, CFG, backend=backend, device="cpu", switching=SwitchingConfig(**STABLE),
            plan=ExecutionPlan(faults=FaultPlan(**faults) if faults else None, **plan))
    else:
        eng = JEngine(p, JCFG, backend=kw["backend"], switching=JSwitching(**STABLE),
                      plan=JPlan(faults=jguard.FaultPlan(**faults) if faults else None, **plan))
    return eng, _serve(eng, how)


@pytest.fixture(scope="module")
def ref_runs(params):
    """Every RUNS entry on the JAX engine, once."""
    p, _ = params
    out = {}
    for name in RUNS:
        eng, res = _run(name, p=p)
        out[name] = (eng.summary().get("degradations"),
                     [(r.stream_id, r.degraded, r.backend, r.health, r.counts) for r in res],
                     res)
    return out


# ---------------------------------------------------------------------------
# FaultPlan and the injector
# ---------------------------------------------------------------------------

def test_faultplan_validation_matches_reference():
    for kw in [dict(poison_rate=1.5), dict(poison_rate=True), dict(poison_kinds=("gamma-ray",)),
               dict(poison_kinds=()), dict(delay_rate=0.5, delay_s=-1.0), dict(seed=1.5),
               dict(iterator_error_rate=-0.1), dict(backend_failure_rate="x"),
               dict(target_streams=(-1,)), dict(target_streams=(True,))]:
        with pytest.raises(ValueError) as mine:
            FaultPlan(**kw)
        with pytest.raises(ValueError) as theirs:
            jguard.FaultPlan(**kw)
        assert str(mine.value) == str(theirs.value)
    fp = FaultPlan(seed=3, poison_rate=0.5, poison_kinds=["nan", "inf"], target_streams=[1])
    assert fp.poison_kinds == ("nan", "inf") and fp.target_streams == (1,)
    hash(fp)
    with pytest.raises(ValueError) as mine:
        ExecutionPlan(faults=jguard.FaultPlan())         # the reference's class is not the port's
    assert "ExecutionPlan.faults=" in str(mine.value)


def test_injector_coins_and_schedules_match_reference():
    fp = dict(seed=11, poison_rate=0.5, poison_kinds=("nan", "inf", "range", "dtype"),
              iterator_error_rate=0.2, backend_failure_rate=0.3, target_streams=(0, 2))
    mine, theirs = FaultInjector(FaultPlan(**fp)), jguard.FaultInjector(jguard.FaultPlan(**fp))
    for kind in ("poison", "poison-kind", "poison-y", "iter-error", "backend", "delay"):
        for stream in (0, 1, 3):
            for index in (0, 1, 7, 1000):
                assert mine._coin(kind, stream, index) == theirs._coin(kind, stream, index)
    frame = _clean_frame(2)
    for idx in range(12):
        a, b = mine.poison_frame(frame, 0, idx), np.asarray(theirs.poison_frame(frame, 0, idx))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    def schedule(inj, stream):
        out = []
        try:
            for f in inj.wrap_stream(stream, [frame] * 12):
                out.append(np.asarray(f).tobytes())
        except Exception as e:
            out.append(repr(e))
        return out

    for stream in (0, 1, 2):
        assert schedule(mine, stream) == schedule(theirs, stream)

    def launches(inj):
        out = []
        for index in list(range(40)) + list(range(40)):      # each index fails once
            try:
                inj.maybe_fail_launch(index)
                out.append(None)
            except Exception as e:
                out.append(repr(e))
        return out

    got = launches(mine)
    assert got == launches(theirs) and any(got) and not any(got[40:])
    assert isinstance(InjectedBackendFailure("x"), RuntimeError)


def test_injector_deterministic_across_instances():
    fp = FaultPlan(seed=11, poison_rate=0.5, poison_kinds=("nan", "range"))
    a, b = FaultInjector(fp), FaultInjector(fp)
    frame = _clean_frame(2)
    for idx in range(8):
        assert a.poison_frame(frame, 0, idx).tobytes() == b.poison_frame(frame, 0, idx).tobytes()
    c = FaultInjector(FaultPlan(seed=12, poison_rate=0.5, poison_kinds=("nan", "range")))
    assert any(c.poison_frame(frame, 0, i).tobytes() != a.poison_frame(frame, 0, i).tobytes()
               for i in range(8))


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["layer", "group"])
@pytest.mark.parametrize("quant_on", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_degradation_ladder_matches_reference(backend, quant_on, fusion):
    mine = build_ladder(backend, quant_on, fusion)
    theirs = jguard.build_ladder({"cuda": "pallas"}.get(backend, backend), True, quant_on, fusion)
    assert [v.step for v in mine] == [v.step for v in theirs]
    assert [(v.quant, v.fusion) for v in mine] == [(v.quant, v.fusion) for v in theirs]
    assert mine[0].step == "" and (mine[-1].backend, mine[-1].quant, mine[-1].fusion) == \
        ("ref", False, "layer")
    if backend == "cuda" and quant_on and fusion == "group":
        assert [v.step for v in mine] == ["", "fusion:group->layer", "backend:->ref",
                                          "quant:->fp32"]


def test_guard_run_steps_retries_and_raises():
    g = ResilienceGuard("cuda", True, "layer", max_retries=2)
    seen = []

    def attempt(v):
        seen.append(v.step)
        if len(seen) < 3:
            raise RuntimeError(f"fail {len(seen)}")
        return "ok"

    assert g.run(attempt, 5) == ("ok", ("backend:->ref", "quant:->fp32"))
    assert seen == ["", "backend:->ref", "quant:->fp32"] and g.level == 2
    with pytest.raises(RuntimeError):                  # at the floor: retry, then give up
        g.run(lambda v: (_ for _ in ()).throw(RuntimeError("always")), 6)
    assert [e["kind"] for e in g.events] == ["degrade", "degrade", "degrade", "degrade",
                                             "failure"]
    assert g.events[2]["reason"].startswith("retry: ")
    with pytest.raises(PoisonFrameError):              # a verdict is not a launch failure
        g.run(lambda v: (_ for _ in ()).throw(PoisonFrameError("p")), 7)
    assert len(g.events) == 5
    assert g.note_watchdog(8, 0.5, 0.1) == ()          # nothing left to step
    assert g.events[-1]["reason"] == "floor: tick took 0.5000s > watchdog_s=0.1"
    s = g.summary()
    assert s["by_step"] == {"backend": 1, "quant": 1, "retry": 2, "floor": 1}
    assert s["level"] == 2 and s["variant"] == "quant:->fp32" and s["total"] == 6
    j = jguard.ResilienceGuard("pallas", True, True, "layer", max_retries=2)
    assert j.run(lambda v: "ok", 0) == ("ok", ())
    assert set(j.summary()) == set(s)


@pytest.mark.parametrize("chaos", [False, True])
def test_guard_on_the_card_steps_down_only_for_injected_faults(chaos):
    """``injected_only`` (a CUDA engine): a real error raises at once, its
    "failure" recorded and the rung kept; an injected fault steps down as
    on the CPU; a watchdog overrun steps down only under a fault plan."""
    g = ResilienceGuard("cuda", False, "group", max_retries=2, injected_only=True, chaos=chaos)
    with pytest.raises(RuntimeError, match="capture"):
        g.run(lambda v: (_ for _ in ()).throw(RuntimeError("capture failed")), 0)
    assert g.level == 0 and [e["kind"] for e in g.events] == ["failure"]
    assert g.events[0]["reason"] == ("not stepping down on the card: "
                                     "RuntimeError('capture failed')")
    tries = []

    def attempt(v):
        tries.append(v.step)
        if len(tries) == 1:
            raise InjectedBackendFailure("injected backend failure (launch 1)")
        return v.backend

    assert g.run(attempt, 1) == ("cuda", ("fusion:group->layer",)) and g.level == 1
    if chaos:
        assert g.note_watchdog(2, 0.5, 0.1) == ("backend:->ref",) and g.level == 2
    else:
        assert g.note_watchdog(2, 0.5, 0.1) == () and g.level == 1
        assert g.events[-1]["reason"] == "held: tick took 0.5000s > watchdog_s=0.1"
    assert g.summary()["by_kind"] == {"failure": 1, "degrade": 1, "watchdog": 1}


# ---------------------------------------------------------------------------
# ledgers under injected faults, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RUNS))
def test_ledger_matches_reference(params, ref_runs, name):
    _, tree = params
    eng, res = _run(name, tree=tree)
    ledger, frames, theirs = ref_runs[name]
    mine = [(r.stream_id, r.degraded, r.backend, r.health, r.counts) for r in res]
    mine = [(s, d, b.replace("cuda-plain", "pallas-interpret"), h, c) for s, d, b, h, c in mine]
    assert mine == frames
    assert eng.summary().get("degradations") == ledger
    assert ledger is not None or name == "mux_sanitize"
    for a, b in zip(res, theirs):
        img = a.image.numpy()
        assert np.isfinite(img).all()
        if "-" not in b.backend:           # fp32 frames; quantized codes: test_torch_quant.py
            np.testing.assert_allclose(img, np.asarray(b.image), rtol=1e-3, atol=1e-3)


def test_injected_failures_are_deterministic(params):
    _, tree = params
    runs = [_run("partial", tree=tree) for _ in range(2)]
    (e1, r1), (e2, r2) = runs
    assert e1.summary()["degradations"] == e2.summary()["degradations"]
    assert [r.degraded for r in r1] == [r.degraded for r in r2]
    assert any(r.degraded for r in r1) and not all(r.degraded for r in r1)
    for a, b in zip(r1, r2):
        assert torch.equal(a.image, b.image)


def test_watchdog_records_ladder_step(params):
    _, tree = params
    eng = SREngine.from_params(tree, CFG, device="cpu", switching=SwitchingConfig(**STABLE),
                               plan=ExecutionPlan(dispatch="fused", fusion="group",
                                                  watchdog_s=1e-9))
    outs = list(eng.stream(FRAMES[0][:3]))
    assert len(outs) == 3 and outs[0].degraded == ("fusion:group->layer",)
    assert [o.backend for o in outs] == ["cuda-plain", "cuda-plain", "ref"]
    kinds = eng.summary()["degradations"]["by_kind"]
    assert kinds == {"watchdog": 3} and eng.guard.level == 2
    floor = SREngine.from_params(tree, CFG, backend="ref", device="cpu",
                                 switching=SwitchingConfig(**STABLE),
                                 plan=ExecutionPlan(dispatch="fused", watchdog_s=1e-9))
    assert all(o.degraded == () for o in floor.stream(FRAMES[0][:2]))
    assert floor.summary()["degradations"]["by_step"] == {"floor": 2}


def test_no_fault_plan_moves_no_ladder(params):
    """Without a FaultPlan or a watchdog, nothing steps the ladder: the
    guard's level stays 0 and the ledger holds no degrade event."""
    _, tree = params
    for plan in (dict(fusion="group"), dict(quant="int8", fusion="group"), dict(streams=2)):
        eng = SREngine.from_params(tree, CFG, device="cpu", switching=SwitchingConfig(**STABLE),
                                   plan=ExecutionPlan(dispatch="fused", **plan))
        if eng.plan.streams > 1:
            res = list(eng.serve_streams([FRAMES[0][:2], FRAMES[1][:2]]))
        else:
            res = list(eng.stream(FRAMES[0][:2]))
        assert all(r.degraded == () for r in res) and eng.guard.level == 0
        assert eng.guard.events == [] and "degradations" not in eng.summary()


# ---------------------------------------------------------------------------
# per-tenant isolation (port against port)
# ---------------------------------------------------------------------------

def _by_stream(results):
    out = {}
    for r in results:
        out.setdefault(r.stream_id, []).append(r.image)
    return out


@pytest.mark.parametrize("name", ["mux_poison", "mux_retire"])
def test_mux_poisoned_tenant_leaves_the_others_bit_equal(params, name):
    """A poisoned tenant is dropped from the ticks (quarantined and
    re-admitted, or retired); the healthy tenants' frames are torch.equal
    to a run without faults."""
    _, tree = params
    eng, faulted = _run(name, tree=tree)
    base = SREngine.from_params(tree, CFG, backend="ref", device="cpu",
                                switching=SwitchingConfig(**STABLE),
                                plan=eng.plan.replace(faults=None))
    clean = _by_stream(base.serve_streams(FRAMES))
    got = _by_stream(faulted)
    assert 1 not in got
    for sid in (0, 2):
        assert len(got[sid]) == len(clean[sid]) == 4
        assert all(torch.equal(a, b) for a, b in zip(got[sid], clean[sid]))
    kinds = eng.summary()["degradations"]["by_kind"]
    if name == "mux_poison":
        assert kinds["quarantine"] >= 1 and kinds["readmit"] >= 1
    else:
        assert kinds == {"poison": 1, "retire": 1}


def test_mux_iterator_crash_retires_only_that_stream(params):
    _, tree = params
    eng, outs = _run("mux_boom", tree=tree)
    ids = [o.stream_id for o in outs]
    assert ids.count(1) == 1 and ids.count(0) == 4 and ids.count(2) == 4
    (event,) = eng.guard.events
    assert event["kind"] == "retire" and "tenant iterator died" in event["reason"]


def test_solo_stream_iterator_exception_recorded(params):
    _, tree = params

    def frames():
        yield _clean_frame(0)
        yield _clean_frame(1)
        raise ValueError("camera unplugged")

    eng = SREngine.from_params(tree, CFG, backend="ref", device="cpu",
                               plan=ExecutionPlan(dispatch="fused"))
    outs = list(eng.stream(frames()))
    assert len(outs) == 2
    (retire,) = [e for e in eng.guard.events if e["kind"] == "retire"]
    assert "camera unplugged" in retire["reason"] and retire["index"] == 2
