"""The port's multi-tenant serving (``ExecutionPlan(streams=N)``,
``SREngine.serve_streams``, ``runtime.multiplex``, ``StreamSwitcherBank``)
against ``repro``'s, on the CPU, x2, 64x64 tenants (9 patches a frame), the
claims of tests/test_multiplex.py.

Standards: ids, counts, spills, thresholds, deadline flags and stream ids
equal to the JAX engine's on the same weights and frames; images rtol 1e-3
/ atol 1e-3, the whole-chain tolerance of tests/test_kernels.py:77 (fp32
sums in another order than XLA's); with capacity pinned, a tenant's frames
bit-equal to the same tenant served solo (port against port: every kernel,
and every plain version, computes each patch on its own); quantized ticks
torch.equal to the port's own solo and host frames; error texts word for
word. On the CPU a tick runs eagerly; on the card it is one CUDA graph
(tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core.adaptive import StreamSwitcherBank as JBank
from repro.core.adaptive import SwitchingConfig as JSwitching
from repro.core.adaptive import per_stream_config as j_per_stream_config
from repro.data.synthetic import degrade, random_image
from repro.models.essr import ESSRConfig as JCfg
from repro.models.essr import init_essr
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core import subnet_policy as sp
from repro_torch.core.adaptive import StreamSwitcherBank, SwitchingConfig, per_stream_config
from repro_torch.models.essr import ESSRConfig

CFG, JCFG = ESSRConfig(scale=2), JCfg(scale=2)
HW = 64
IMG_TOL = dict(rtol=1e-3, atol=1e-3)
STABLE = dict(frame_high=10 ** 9, frame_low=0)
OVERLOAD = dict(c54_per_sec_budget=8, fps=1, frame_high=10 ** 9, frame_low=0)


def _texture_frame(seed: int) -> np.ndarray:
    """Degraded random texture: routes (almost) entirely C54."""
    return np.asarray(degrade(jnp.asarray(random_image(seed, 2 * HW, 2 * HW)), 2))


def _smooth_frame() -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(0, 1, HW, dtype=np.float32),
                         np.linspace(0, 1, HW, dtype=np.float32), indexing="ij")
    return np.stack([yy, xx, (yy + xx) / 2], axis=-1)


TENANTS = [[_texture_frame(s * 100 + i) for i in range(3)] for s in range(4)]

#: name -> (plan kwargs, SwitchingConfig kwargs, deadline_s, streams): the
#: serve_streams runs held against the JAX engine
CASES = {
    "ragged": (dict(streams=3), STABLE, None,
               lambda: [TENANTS[0][:3], TENANTS[1][:1], TENANTS[2][:2]]),
    "pinned": (dict(streams=4, capacity=(0, 9, 9)), STABLE, None, lambda: TENANTS),
    "overload": (dict(streams=2, stream_shares=(3.0, 1.0)), OVERLOAD, None,
                 lambda: [TENANTS[0][:2], TENANTS[1][:2]]),
    "isolation": (dict(streams=2, t1=8.0, t2=40.0), STABLE, 1e-9,
                  lambda: [TENANTS[0][:3], [_smooth_frame()] * 3]),
}
#: summary() fields that are timings: compared by presence only
TIMING = ("mean_latency_s", "compiled_caches")


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


@pytest.fixture(scope="module")
def ref_streams(params):
    """The JAX engine's serve_streams of every case, once (it compiles once
    per live count)."""
    p, _ = params
    out = {}
    for name, (kw, sw, deadline, streams) in CASES.items():
        eng = JEngine(p, JCFG, plan=JPlan(dispatch="fused", **kw), switching=JSwitching(**sw),
                      deadline_s=deadline)
        res = list(eng.serve_streams(streams()))
        out[name] = (res, eng.summary())
    return out


def _port(tree, switching=None, deadline_s=None, backend="cuda", quant_cache=None, **kw):
    return SREngine.from_params(tree, CFG, backend=backend, device="cpu",
                                plan=ExecutionPlan(dispatch="fused", **kw),
                                switching=SwitchingConfig(**(switching or STABLE)),
                                deadline_s=deadline_s, quant_cache=quant_cache)


def _strip(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in TIMING and k != "backend"}


# -- against the JAX engine ------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_streams_matches_reference(params, ref_streams, case, backend):
    _, tree = params
    kw, sw, deadline, streams = CASES[case]
    eng = _port(tree, sw, deadline, backend, **kw)
    mine = list(eng.serve_streams(streams()))
    theirs, summary = ref_streams[case]
    assert [r.stream_id for r in mine] == [r.stream_id for r in theirs]
    for a, b in zip(mine, theirs):
        assert a.counts == b.counts and a.spill_counts == b.spill_counts
        assert a.thresholds == b.thresholds and a.deadline_missed == b.deadline_missed
        assert a.dispatch == b.dispatch == "fused" and a.health == b.health
        np.testing.assert_array_equal(a.ids.numpy(), np.asarray(b.ids))
        np.testing.assert_allclose(a.image.numpy(), np.asarray(b.image), **IMG_TOL)
    assert a.backend == {"cuda": "cuda-plain", "ref": "ref"}[backend]
    assert _strip(eng.summary()) == _strip(summary)
    assert set(eng.summary()) == set(summary)


def test_error_texts_match_reference(params):
    p, tree = params
    j = JEngine(p, JCFG, plan=JPlan(dispatch="fused", streams=2))
    mine = _port(tree, streams=2)
    bad = [[_texture_frame(0)], [_texture_frame(1)[:32]]]
    texts = []
    for eng in (mine, j):
        got = []
        for call in (lambda: list(eng.serve_streams(bad)),
                     lambda: eng.serve(_texture_frame(0)),
                     lambda: list(eng.stream([_texture_frame(0)])),
                     lambda: list(eng.serve_streams([[_texture_frame(0)]]))):
            with pytest.raises(ValueError) as e:
                call()
            got.append(str(e.value))
        texts.append(got)
    assert texts[0] == texts[1]
    assert "one admission tick packs one geometry" in texts[0][0]
    assert "use serve_streams()" in texts[0][1] and "serve_streams got 1 streams" in texts[0][3]


# -- port against port ------------------------------------------------------

@pytest.mark.parametrize("fusion", ["layer", "group"])
def test_four_streams_bit_equal_to_solo(params, fusion):
    """Adequate pinned capacity on both sides: no spills, so routing and
    images must match exactly (the shared pool lends no slack)."""
    _, tree = params
    mux = list(_port(tree, streams=4, capacity=(0, 9, 9), fusion=fusion).serve_streams(TENANTS))
    assert len(mux) == 12
    for s in range(4):
        solo = list(_port(tree, capacity=(0, 9, 9), fusion=fusion).stream(TENANTS[s]))
        mine = [r for r in mux if r.stream_id == s]
        assert len(mine) == len(solo) == 3
        for rm, rs in zip(mine, solo):
            assert torch.equal(rm.image, rs.image) and torch.equal(rm.ids, rs.ids)
            assert rm.counts == rs.counts and rm.dispatch == "fused"


@pytest.mark.parametrize("quant,fusion", [("fxp10", "layer"), ("int8", "group")])
def test_streams_quant_equal_to_solo_and_host(params, quant, fusion, tmp_path):
    """The tick shares the engine's calibration: quantized multi-stream
    frames torch.equal to the quantized solo fused frames and to host
    dispatch (the three engines share one calibration through the cache)."""
    _, tree = params
    cache = str(tmp_path)
    eng = _port(tree, streams=2, quant=quant, fusion=fusion, capacity=(0, 9, 9),
                quant_cache=cache)
    mux = list(eng.serve_streams([TENANTS[0][:2], TENANTS[1][:2]]))
    assert eng.qpack is not None
    solo = _port(tree, quant=quant, fusion=fusion, capacity=(0, 9, 9), quant_cache=cache)
    host = SREngine(solo.model, plan=ExecutionPlan(quant=quant, fusion=fusion), device="cpu",
                    quant_cache=cache)
    assert solo.qpack == eng.qpack == host.qpack
    for s in range(2):
        mine = [r for r in mux if r.stream_id == s]
        for rm, frame in zip(mine, TENANTS[s][:2]):
            rs, rh = solo.upscale(frame), host.upscale(frame)
            assert torch.equal(rm.image, rs.image) and torch.equal(rm.image, rh.image)
            assert rm.backend == rs.backend == f"cuda-plain-{quant}"


def test_round_robin_admission_order_and_fairness(params):
    _, tree = params
    eng = _port(tree, streams=4)
    mux = list(eng.serve_streams(TENANTS))
    assert [r.stream_id for r in mux] == [0, 1, 2, 3] * 3
    assert {sid: rec["frames"] for sid, rec in eng.summary()["streams"].items()} == \
        {0: 3, 1: 3, 2: 3, 3: 3}


def test_ragged_streams_shrink_the_tick(params):
    """An exhausted tenant leaves the tick; the rest keep serving, and each
    live count is a fused tick of its own."""
    from repro_torch.core import pipeline as pl
    _, tree = params
    pl._fused_stream_fn.cache_clear()
    eng = _port(tree, streams=3)
    got = [r.stream_id for r in eng.serve_streams(CASES["ragged"][3]())]
    assert got == [0, 1, 2, 0, 2, 0]
    assert eng.summary()["frames"] == 6
    assert sorted(k[2] for k in eng._fused_caps) == [1, 2, 3]
    assert pl._fused_stream_fn.occupancy()["size"] == 3
    pl._fused_stream_fn.cache_clear()


def test_streams_one_serve_streams_is_stream(params):
    _, tree = params
    a, b = _port(tree), _port(tree)
    ra = list(a.serve_streams([TENANTS[0]]))
    rb = list(b.stream(TENANTS[0]))
    for x, y in zip(ra, rb):
        assert torch.equal(x.image, y.image)
        assert x.stream_id is None and y.stream_id is None
        assert x.counts == y.counts and x.thresholds == y.thresholds
    assert a.summary().keys() == b.summary().keys()
    assert "streams" not in a.summary()


def test_share_weighted_c54_degradation_is_deterministic(params):
    """Overload: each tenant's C54 slots degrade to its share of the budget
    (3:1 of 8: quotas 6 and 2), raster-deterministically, nothing dropped."""
    _, tree = params
    runs = []
    for _ in range(2):
        eng = _port(tree, OVERLOAD, streams=2, stream_shares=(3.0, 1.0))
        res = list(eng.serve_streams([TENANTS[0][:2], TENANTS[1][:2]]))
        runs.append([(r.stream_id, r.counts, r.spill_counts) for r in res])
        assert [r.stream_id for r in res] == [0, 1, 0, 1]
        for r in res:
            quota = 6 if r.stream_id == 0 else 2
            native = r.counts[sp.C54] + r.spill_counts[sp.C54]
            assert r.counts[sp.C54] == min(native, quota)
            assert sum(r.counts) == 9
        assert all(a.counts[sp.C54] >= b.counts[sp.C54] for a, b in zip(res[0::2], res[1::2]))
        assert any(r.spill_counts[sp.C54] > 0 for r in res)
    assert runs[0] == runs[1]


def test_per_stream_switcher_isolation(params):
    """A shared tick deadline, blamed by share-weighted cost: the heavy
    tenant is demoted, the light tenant's thresholds never move."""
    _, tree = params
    kw, sw, deadline, streams = CASES["isolation"]
    eng = _port(tree, sw, deadline, **kw)
    res = list(eng.serve_streams(streams()))
    h = [r for r in res if r.stream_id == 0]
    light = [r for r in res if r.stream_id == 1]
    assert all(r.deadline_missed for r in h)
    assert not any(r.deadline_missed for r in light)
    assert h[-1].thresholds > (8.0, 40.0) and light[-1].thresholds == (8.0, 40.0)
    summ = eng.summary()
    assert summ["streams"][0]["deadline_misses"] == 3
    assert summ["streams"][1]["deadline_misses"] == 0


def test_inflight_ticks_match_synchronous(params):
    _, tree = params
    ra = list(_port(tree, streams=4).serve_streams(TENANTS))
    rb = list(_port(tree, streams=4, inflight=3).serve_streams(TENANTS))
    assert [r.stream_id for r in ra] == [r.stream_id for r in rb]
    for x, y in zip(ra, rb):
        assert torch.equal(x.image, y.image) and x.counts == y.counts


# -- the bank, against the reference's --------------------------------------

def test_stream_bank_attribution_matches_reference():
    mine = StreamSwitcherBank(SwitchingConfig(t1=8, t2=40), streams=3, shares=(1.0, 1.0, 2.0))
    theirs = JBank(JSwitching(t1=8, t2=40), streams=3, shares=(1.0, 1.0, 2.0))
    assert mine.shares == theirs.shares == (0.25, 0.25, 0.5)
    assert mine.tick_quotas() == theirs.tick_quotas()
    calls = [(False, [100, 100, 200], None), (True, [100, 100, 200], None),
             (True, [400, 100, 200], None), (True, [100, 500], (1, 2)),
             (True, [0, 0, 0], None), (True, [10 ** 9, 1, 1], None)]
    got = []
    for missed, costs, streams in calls:
        a = mine.note_tick(missed, costs, streams=streams)
        assert a == theirs.note_tick(missed, costs, streams=streams)
        assert mine.thresholds == theirs.thresholds
        got.append(a)
    assert got[:4] == [(False, False, False), (True, True, True), (True, False, False),
                       (False, False, True)]
    for s, n in ((0, 5), (2, 10 ** 4), (1, 0)):
        mine.observe(s, n)
        theirs.observe(s, n)
        assert mine.thresholds == theirs.thresholds
    with pytest.raises(ValueError, match="costs for"):
        mine.note_tick(True, [1.0], streams=(0, 1))


def test_per_stream_config_split_matches_reference():
    kw = dict(c54_per_sec_budget=1000, frame_high=100, frame_low=0, fps=10)
    cfg, jcfg = SwitchingConfig(**kw), JSwitching(**kw)
    for share in (0.5, 1e-6, 0.3, 0.999):
        a, b = per_stream_config(cfg, share), j_per_stream_config(jcfg, share)
        assert (a.c54_per_sec_budget, a.frame_high, a.frame_low) == \
            (b.c54_per_sec_budget, b.frame_high, b.frame_low)
    assert per_stream_config(cfg, 0.5).frame_low == 0
    assert per_stream_config(cfg, 1e-6).c54_per_sec_budget == 1
    assert per_stream_config(cfg, 1.0) is cfg
    for share in (0.0, 1.5):
        with pytest.raises(ValueError) as mine:
            per_stream_config(cfg, share)
        with pytest.raises(ValueError) as theirs:
            j_per_stream_config(jcfg, share)
        assert str(mine.value) == str(theirs.value)
    assert StreamSwitcherBank(cfg, streams=2, shares=(1.0, 1.0)).tick_quotas() == (50, 50)
    for bad in (dict(streams=0), dict(streams=2, shares=(1.0,)),
                dict(streams=2, shares=(1.0, -1.0))):
        with pytest.raises(ValueError) as mine:
            StreamSwitcherBank(cfg, **bad)
        with pytest.raises(ValueError) as theirs:
            JBank(jcfg, **bad)
        assert str(mine.value) == str(theirs.value)
