"""The port's serving slice end to end against ``repro.api.SREngine`` on the
same weights and frames, on the CPU (the "cuda" backend's wrappers take
their plain versions there and say so in the label).

Golden frame: the mixed smooth/texture frame of tests/test_fused_dispatch.py
(x2, full C54 width, 5 SFBs), routing counts (10, 2, 13). Tolerances:
scores rtol 1e-5 / atol 1e-5 (smooth patches score ~1e-5: the Laplacian
cancels luma near 100, whose fp32 spacing is 7.6e-6, and the two Laplacians
sum in different orders); images rtol 1e-3 / atol 1e-3, the whole-chain
tolerance of tests/test_kernels.py:77: with random He-normal weights the 12
fp32 layers carry intermediates of O(100), so outputs near zero differ by
~1e-4 between XLA's and PyTorch's CPU sums (measured 1.4e-4 on 2 of 196608
pixels of the golden frame).
"""
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.data.synthetic import degrade, random_image
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.api.result import summarize_stats
from repro_torch.models.essr import ESSRConfig
from repro_torch.runtime.guard import PoisonFrameError

CFG, JCFG = ESSRConfig(scale=2), JCfg(scale=2)
GOLDEN_COUNTS = (10, 2, 13)
IMG_TOL = dict(rtol=1e-3, atol=1e-3)
ROOT = Path(__file__).resolve().parents[1]


def _golden_frame(hw: int = 128, seed: int = 1234) -> np.ndarray:
    yy, xx = jnp.meshgrid(jnp.linspace(0, 1, hw), jnp.linspace(0, 1, hw), indexing="ij")
    smooth = jnp.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = degrade(jnp.asarray(random_image(seed, 2 * hw, 2 * hw)), 2)
    return np.asarray(jnp.where((yy < 0.5)[..., None], smooth, tex))


@pytest.fixture(scope="module")
def engines():
    ref = JEngine.from_config(JCFG, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    return ref, tree


def _port(tree, backend="cuda", plan=None):
    return SREngine.from_params(tree, CFG, plan=plan, backend=backend, device="cpu")


@pytest.mark.parametrize("backend,label", [("cuda", "cuda-plain"), ("ref", "ref")])
def test_golden_frame_matches_reference(engines, backend, label):
    ref, tree = engines
    frame = _golden_frame()
    rj = ref.upscale(frame)
    rp = _port(tree, backend).upscale(frame)
    assert rp.backend == label and rp.mode == "edge_select" and rp.dispatch == "host"
    assert rp.counts == rj.counts == GOLDEN_COUNTS
    np.testing.assert_array_equal(rp.ids, np.asarray(rj.ids))
    np.testing.assert_allclose(rp.scores, np.asarray(rj.scores), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)
    assert rp.mac_saving == pytest.approx(rj.mac_saving, abs=1e-12)
    assert rp.thresholds == rj.thresholds


@pytest.mark.parametrize("mode,width", [("all_patches", 27), ("all_patches", 0),
                                        ("whole", None)])
def test_other_modes_match_reference(engines, mode, width):
    ref, tree = engines
    frame = _golden_frame(64)
    rj = ref.upscale(frame, mode=mode, width=width)
    rp = _port(tree).upscale(frame, mode=mode, width=width)
    assert rp.mode == rj.mode and rp.counts == rj.counts and rp.scores is None
    assert rp.backend == ("ref" if mode == "whole" else "cuda-plain")
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)


def test_forced_policy_and_ids_override_match_reference(engines):
    ref, tree = engines
    frame = _golden_frame(64)
    plan = ExecutionPlan(subnet_policy="all_c54")
    rj = ref.upscale(frame, plan=JPlan(subnet_policy="all_c54"))
    rp = _port(tree).upscale(frame, plan=plan)
    assert rp.mode == rj.mode == "all_patches" and rp.counts == rj.counts
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)
    ids = np.arange(9) % 3
    rj = ref.upscale(frame, ids_override=ids)
    rp = _port(tree).upscale(frame, ids_override=ids)
    assert rp.counts == rj.counts == (3, 3, 3)
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)


def test_cuda_backend_scores_through_the_edge_kernel(engines, monkeypatch):
    """The "cuda" backend's frame scores its patches through the edge kernel's
    wrapper (on the CPU it takes the plain score inside, and launches
    nothing), routing the golden frame as the reference does; the "ref"
    backend and a forced routing never call it."""
    from repro_torch.core.edge_score import edge_score
    from repro_torch.kernels import edge as tedge
    real, calls = tedge.edge_score_fused, []

    def spy(patches):
        out = real(patches)
        calls.append(torch.equal(out, edge_score(patches)))
        return out

    monkeypatch.setattr(tedge, "edge_score_fused", spy)
    ref, tree = engines
    before = real.launches
    rp = _port(tree).upscale(_golden_frame())
    assert calls == [True] and real.launches == before
    assert rp.counts == GOLDEN_COUNTS
    np.testing.assert_array_equal(rp.ids, np.asarray(ref.upscale(_golden_frame()).ids))
    frame = _golden_frame(64)
    _port(tree, "ref").upscale(frame)
    _port(tree).upscale(frame, ids_override=np.arange(9) % 3)
    assert calls == [True]


def test_sub_patch_size_frame_matches_reference(engines):
    ref, tree = engines
    frame = np.asarray(_golden_frame(64))[:20, :25]
    rj, rp = ref.upscale(frame), _port(tree).upscale(frame)
    assert rp.image.shape == (40, 50, 3) and rp.counts == rj.counts
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)


def test_poison_policies(engines):
    _, tree = engines
    frame = _golden_frame(64).copy()
    frame[3, 4, 1] = np.nan
    frame[5, 6, 0] = 2.0
    with pytest.raises(PoisonFrameError) as e:
        _port(tree).upscale(frame)
    assert e.value.health == (1, 0, 1)
    with pytest.raises(PoisonFrameError, match="not floating"):
        _port(tree).upscale(np.zeros(frame.shape, np.uint8))
    r = _port(tree, plan=ExecutionPlan(on_poison="bilinear")).upscale(frame)
    assert r.health == (1, 0, 1) and r.counts == (9, 0, 0)
    assert bool(torch.isfinite(r.image).all())
    clean = _golden_frame(64)
    a = _port(tree, plan=ExecutionPlan(on_poison="sanitize")).upscale(clean)
    b = _port(tree, plan=ExecutionPlan(on_poison="off")).upscale(clean)
    assert a.health == (0, 0, 0) and b.health is None
    assert torch.equal(a.image, b.image)           # sanitize is bit-exact on clean frames
    u8 = np.round(clean * 255).astype(np.uint8)
    c = _port(tree, plan=ExecutionPlan(on_poison="sanitize")).upscale(u8)
    d = _port(tree).upscale(u8.astype(np.float32) / 255)
    assert torch.equal(c.image, d.image)           # integer frames scale by their range


def test_plan_validation_text_matches_reference():
    for kw in [dict(patch=0), dict(overlap=40), dict(t1=50.0, t2=40.0),
               dict(buckets=(16, 8)), dict(on_poison="loud"), dict(dispatch="gpu"),
               dict(capacity=(0, -1, 4)), dict(capacity=("a", 2)), dict(inflight=0),
               dict(inflight=2), dict(inflight=2, dispatch="host"),
               dict(dispatch="fused", inflight=1.5),
               # multi-stream and resilience fields (field rules, then cross rules)
               dict(streams=0), dict(streams=True), dict(streams=2),
               dict(streams=2, dispatch="fused", subnet_policy="all_c54"),
               dict(streams=2, dispatch="fused", stream_shares=(1.0,)),
               dict(stream_shares=(0.0,)), dict(stream_shares=(float("inf"),)),
               dict(stream_shares=("a",)), dict(stream_shares=()), dict(faults="chaos"),
               dict(max_retries=-1), dict(max_retries=1.0), dict(quarantine_ticks=-2),
               dict(watchdog_s=0.0), dict(watchdog_s=1.0), dict(watchdog_s=True)]:
        with pytest.raises(ValueError) as mine:
            ExecutionPlan(**kw)
        with pytest.raises(ValueError) as theirs:
            JPlan(**kw)
        assert str(mine.value) == str(theirs.value)
    for kw in [dict(), dict(fusion="group"), dict(quant="int8"), dict(quant="fxp10"),
               dict(quant="int8", fusion="group"), dict(dispatch="fused"),
               dict(dispatch="fused", capacity=[0, 8, 4], inflight=2),
               dict(dispatch="fused", quant="fxp10", fusion="group", inflight=3)]:
        mine, theirs = ExecutionPlan(**kw), JPlan(**kw)   # constructs, as in the reference
        assert (mine.fusion, mine.quant, mine.dispatch, mine.capacity, mine.inflight) == \
            (theirs.fusion, theirs.quant, theirs.dispatch, theirs.capacity, theirs.inflight)
    from repro.runtime.guard import FaultPlan as JFaultPlan
    from repro_torch.runtime.guard import FaultPlan
    fields = ("streams", "stream_shares", "max_retries", "quarantine_ticks", "watchdog_s")
    for kw in [dict(), dict(dispatch="fused", streams=3, stream_shares=[2, 1, 1]),
               dict(dispatch="fused", streams=2, max_retries=0, quarantine_ticks=3,
                    watchdog_s=0.25)]:
        mine, theirs = ExecutionPlan(**kw), JPlan(**kw)
        assert [getattr(mine, f) for f in fields] == [getattr(theirs, f) for f in fields]
        assert mine.faults is theirs.faults is None
        hash(mine)                                       # frozen and hashable
    fkw = dict(seed=3, poison_rate=0.5, poison_kinds=["nan", "inf"], target_streams=[1])
    assert ExecutionPlan(faults=FaultPlan(**fkw)).faults == FaultPlan(**fkw)
    assert JPlan(faults=JFaultPlan(**fkw)).faults.poison_kinds == FaultPlan(**fkw).poison_kinds
    # quant under fusion="group": the "cuda" engine serves the quantized
    # megakernel, the "ref" engine (which ignores fusion) the fake-quant model
    plan = ExecutionPlan(quant="int8", fusion="group")
    frame = _golden_frame(64)[:32, :32]
    r = SREngine.from_config(CFG, plan=plan, device="cpu").upscale(frame)
    assert r.backend == "cuda-plain-int8" and tuple(r.image.shape) == (64, 64, 3)
    r = SREngine.from_config(CFG, plan=plan, backend="ref", device="cpu").upscale(frame)
    assert r.backend == "ref-int8" and tuple(r.image.shape) == (64, 64, 3)


def test_public_signatures_accept_the_reference_arguments(engines, tmp_path, capsys):
    """Every parameter of the reference's public SREngine and ExecutionPlan
    methods is a parameter of the port's, under the same name, except the
    documented ones: the constructor's ``(params, cfg)`` (the port's is
    ``from_params``) and ``interpret`` (no interpreter). Then the two that
    were missing, called as the reference's callers call them."""
    import inspect
    exempt = {("__init__", "params"), ("__init__", "cfg")}
    checked = 0
    for mine, theirs in ((SREngine, JEngine), (ExecutionPlan, JPlan)):
        for name, attr in vars(theirs).items():
            if (name.startswith("_") and name != "__init__") or not callable(attr) \
                    and not isinstance(attr, classmethod):
                continue
            want = inspect.signature(getattr(theirs, name)).parameters
            have = inspect.signature(getattr(mine, name)).parameters
            for pname in want:
                if (name, pname) in exempt or pname == "interpret":
                    continue
                assert pname in have, f"{mine.__name__}.{name} lacks {pname!r}"
                checked += 1
    assert checked > 40
    assert inspect.signature(ExecutionPlan.geometry).parameters["device"].default == "cuda"
    g = ExecutionPlan().geometry(64, 64, 2, "cpu")
    jg = JPlan().geometry(64, 64, 2)
    assert g.n == jg.n == 9 and np.array_equal(g.pos, np.asarray(jg.pos))
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    from repro.ckpt.checkpoint import CheckpointManager
    ref, _ = engines
    CheckpointManager(str(tmp_path / "ck")).save(1, {"params": ref.params, "ema": ref.params})
    capsys.readouterr()
    JEngine.from_checkpoint(str(tmp_path / "ck"), cfg=JCFG, bench_cache=None, verbose=True)
    theirs = capsys.readouterr().out
    port = SREngine.from_checkpoint(str(tmp_path / "ck"), cfg=CFG, bench_cache=None,
                                    verbose=True, device="cpu")
    assert capsys.readouterr().out == theirs == f"(restored 'ema' weights from {tmp_path / 'ck'})\n"
    assert port.backend_label == "cuda-plain"


def test_engine_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SREngine.from_config(CFG)
    with pytest.raises(ValueError, match="backend"):
        SREngine.from_config(CFG, backend="pallas", device="cpu")
    e = SREngine.from_config(CFG, device="cpu")
    assert e.backend_label == "cuda-plain" and e.device.type == "cpu"


def test_warmup_and_summary(engines):
    ref, tree = engines
    e = _port(tree)
    w = e.warmup((64, 96))
    assert w.compiled is False and all(c > 0 for c in w.counts)
    assert e.summary() == {} and e.backend_label == "cuda-plain"
    a = e.upscale(_golden_frame(64)[:, :64].copy())
    assert a.compiled is False
    b = e.upscale(_golden_frame(64))
    assert b.compiled is True
    # upscale records nothing, as in the reference: summary() stays {}
    ref.upscale(_golden_frame(64))
    assert e.summary() == ref.summary() == {} and not e.stats
    s = summarize_stats([a, b])
    assert s["frames"] == 2 and s["warmup_frames_excluded"] == 1


def test_bool_frame_served_as_reference():
    frame = np.random.default_rng(0).random((64, 64, 3)) > 0.5
    ref = JEngine.from_config(JCFG, seed=0, plan=JPlan(on_poison="sanitize"))
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    rj = ref.upscale(frame)
    rp = _port(tree, plan=ExecutionPlan(on_poison="sanitize")).upscale(frame)
    assert rp.counts == rj.counts == (0, 0, 9)
    assert tuple(rp.image.shape) == (128, 128, 3)
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **IMG_TOL)


def test_checkpoint_written_by_reference_reads_back(engines, tmp_path):
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    from repro.ckpt.checkpoint import CheckpointManager
    from repro_torch.ckpt.checkpoint import read_manifest, restore_numpy
    ref, tree = engines
    cm = CheckpointManager(str(tmp_path))
    ema = jax.tree_util.tree_map(lambda v: v * 0.5, ref.params)
    cm.save(7, {"params": ref.params, "ema": ema}, meta={"note": "x"})
    assert read_manifest(str(tmp_path))["step"] == 7
    got, meta = restore_numpy(str(tmp_path))
    assert meta == {"note": "x", "step": 7}
    for a, b in zip(jax.tree_util.tree_leaves(got["ema"]), jax.tree_util.tree_leaves(ema)):
        np.testing.assert_array_equal(a, np.asarray(b))
    frame = _golden_frame(64)
    rp = SREngine.from_checkpoint(str(tmp_path), cfg=CFG, prefer="params",
                                  device="cpu").upscale(frame)
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(ref.upscale(frame).image),
                               **IMG_TOL)
    cm2 = CheckpointManager(str(tmp_path / "only"))
    cm2.save(1, {"params": ref.params})
    with pytest.warns(UserWarning, match="no 'ema' tree"):
        SREngine.from_checkpoint(str(tmp_path / "only"), cfg=CFG, device="cpu")


def _ckpt_image(engine_or_result, frame):
    return np.asarray(engine_or_result.upscale(frame).image)


@pytest.mark.parametrize("case", ["ema_only", "truncated_leaf", "bench_cache"])
def test_from_checkpoint_serves_where_the_reference_serves(engines, tmp_path, case):
    """The reference's priority order (engine.py:587-678): a missing
    preferred tree falls back with a warning, a corrupt leaf warns and serves
    fresh init, and without a directory the bench cache's candidate with the
    most steps serves, each failing candidate warned."""
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    from repro.ckpt.checkpoint import CheckpointManager
    ref, tree = engines
    frame = _golden_frame(64)
    cache = str(tmp_path / "bench")
    kw = dict(cfg=CFG, bench_cache=cache)
    if case == "ema_only":
        d = str(tmp_path / "ema")
        CheckpointManager(d).save(1, {"ema": ref.params})
        with pytest.warns(UserWarning, match=r"no 'params' tree \(found \['ema'\]\); "
                                             r"serving 'ema' instead"):
            port = SREngine.from_checkpoint(d, prefer="params", device="cpu", **kw)
        with pytest.warns(UserWarning, match="no 'params' tree"):
            want = JEngine.from_checkpoint(d, prefer="params", cfg=JCFG, bench_cache=cache)
        np.testing.assert_allclose(_ckpt_image(port, frame), _ckpt_image(want, frame), **IMG_TOL)
    elif case == "truncated_leaf":
        d = tmp_path / "cut"
        CheckpointManager(str(d)).save(3, {"params": ref.params, "ema": ref.params})
        (d / "step_3" / "a_0.npy").write_bytes(b"\x93NUMPY junk")
        with pytest.warns(UserWarning, match="checkpoint restore failed .* serving fresh "
                                             "random init"):
            port = SREngine.from_checkpoint(str(d), device="cpu", **kw)
        with pytest.warns(UserWarning, match="checkpoint restore failed"):
            JEngine.from_checkpoint(str(d), cfg=JCFG, bench_cache=cache)
        fresh = SREngine.from_config(CFG, seed=0, device="cpu")
        np.testing.assert_array_equal(_ckpt_image(port, frame), _ckpt_image(fresh, frame))
    else:
        for steps, f in (("800", 0.5), ("6000", 1.0), ("9000", 1.0)):
            cm = CheckpointManager(os.path.join(cache, f"essr_x2_sfb{CFG.n_sfb}_{steps}"))
            cm.save(1, {"params": jax.tree_util.tree_map(lambda v: v * f, ref.params)})
        cut = Path(cache) / f"essr_x2_sfb{CFG.n_sfb}_9000" / "step_1" / "a_0.npy"
        cut.write_bytes(b"junk")                      # the newest candidate is corrupt
        with pytest.warns(UserWarning, match=r"bench-cache restore failed for .*_9000"):
            port = SREngine.from_checkpoint(None, device="cpu", **kw)
        np.testing.assert_allclose(_ckpt_image(port, frame), np.asarray(ref.upscale(frame).image),
                                   **IMG_TOL)
        # the alphas of a quantized engine are cached beside the bench cache
        with pytest.warns(UserWarning, match="bench-cache restore failed"):
            SREngine.from_checkpoint(None, plan=ExecutionPlan(quant="int8"), device="cpu", **kw)
        assert len(list(Path(cache).glob("quant_alphas_int8_x2_*.json"))) == 1
        empty = SREngine.from_checkpoint(None, cfg=CFG, bench_cache=str(tmp_path / "none"),
                                         device="cpu")
        fresh = SREngine.from_config(CFG, seed=0, device="cpu")
        np.testing.assert_array_equal(_ckpt_image(empty, frame), _ckpt_image(fresh, frame))


def test_port_imports_neither_jax_nor_the_reference():
    """The port, its examples and chip_smoke.py run where JAX is not installed."""
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
                     r"from\s+repro(\.|\s))", re.M)
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + examples
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 10
    offenders = [f"{os.path.relpath(f, ROOT)}: {m.group(0).strip()}"
                 for f in files for m in bad.finditer(f.read_text())]
    assert offenders == []
