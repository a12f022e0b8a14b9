"""LM training on the port (``repro_torch.launch.steps``, ``costmodel``,
``roofline``, the LM mode of ``launch/train.py`` and
``examples/torch_dynamic_width_lm.py``) against ``repro``'s.

Every ``ARCH_NAMES`` SMOKE config from the reference's float32 init
(PRNGKey(0)), carried across by the bridge, on tests/test_lm_archs.py's
``_batch`` inputs (B 2, S 16; labels = tokens, as its train test): the loss
and every gradient leaf against ``jax.value_and_grad`` of the reference's
``make_loss_fn(cfg, remat=False)``, then one ``make_train_step`` step with
``make_optimizer()`` and with ``chain_clip(adam(1e-2), 1.0)``, params and
optimizer state leaf by leaf. The reference's side is one jitted call a
config, computed once: the gradient, and both steps as its
``make_train_step`` takes them on that gradient; the bf16 test calls its
``make_train_step`` itself.

Tolerances. fp32: rtol 1e-3, and atol 1e-3 times the largest magnitude of
the reference's leaf: the whole-chain tolerance of tests/test_kernels.py:77
(float32 sums in another order than XLA's), scaled per leaf because a
leaf's gradients (and its moments) span orders of magnitude, so one
absolute floor would check nothing on the small ones. Parameters after a
step: rtol/atol 1e-3 (at lr 1e-2 a step moves each weight by up to 1e-2, so
an update of the wrong sign fails). Adam's first step is ``g / (|g| +
eps)`` per entry: where the reference's gradient is within float noise of
zero its sign is not determined, and those entries are held only to the
step's size, ``|delta| <= lr``. The noise floor is 1e-5 of the leaf's
largest gradient: 4x the largest disagreement of the two packages'
gradients measured over the ten configs (2.4e-6 of the leaf's largest), so
no entry above it can change sign. bf16: rtol/atol 8e-2 (PR 29's bound
for two bf16 computations of the same values, tests/test_torch_lm_archs.py),
on the reference's bf16 init and tokens.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.configs.registry import get_config as jget_config
from repro.launch import costmodel as JC
from repro.launch import roofline as JR
from repro.launch import steps as JST
from repro.models.lm import encdec as JE
from repro.models.lm import transformer as JT
from repro.train import optimizer as JO
from repro_torch.configs import base as tbase
from repro_torch.configs import granite_8b
from repro_torch.configs.registry import ARCH_NAMES, all_configs, get_config
from repro_torch.launch import costmodel as C
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as ST
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (encdec_params_from_numpy, lm_opt_state_from_numpy,
                                        lm_opt_state_to_numpy, lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
B, S = 2, 16
TOL = 1e-3
BF16_TOL = dict(rtol=8e-2, atol=8e-2)
NOISE = 1e-5
ADAM_LR = 1e-2
#: the optimizers a step is held under: make_optimizer() (warmup: its
#: first step is lr 1.5e-7) and a constant 1e-2, whose steps show
OPTS = {"make_optimizer": (ST.make_optimizer, JST.make_optimizer, 3e-4 / 2000),
        "adam": (lambda: O.chain_clip(O.adam(ADAM_LR), 1.0),
                 lambda: JO.chain_clip(JO.adam(ADAM_LR), 1.0), ADAM_LR)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors beside other test processes: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg):
    """tests/test_lm_archs.py:19-26's inputs: tokens, the enc-dec source,
    the VLM prefix (float32)."""
    toks = jax.random.randint(KEY, (B, S), 0, cfg.vocab_size)
    batch = {"tokens": toks, "labels": toks}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = jax.random.normal(KEY, (B, S, cfg.d_model))
    if cfg.frontend == "vision":
        batch["embeds"] = jax.random.normal(KEY, (B, cfg.n_frontend_tokens, cfg.d_model))
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64 if k in ("tokens", "labels")
                                                     else np.asarray(v).dtype))
            for k, v in batch.items()}


def _bridge(tree, cfg):
    return (encdec_params_from_numpy if cfg.is_encoder_decoder else lm_params_from_numpy)(
        tree, cfg)


@pytest.fixture(scope="module")
def reference():
    """name -> the reference's fp32 params, batch, loss, gradients and the
    state after one step under each of OPTS (numpy), from one jitted call."""
    cache = {}

    def get(name):
        if name not in cache:
            jc = jget_config(name, smoke=True)
            init = JE.init_encdec if jc.is_encoder_decoder else JT.init_lm
            jp = jax.jit(init, static_argnums=(1, 2))(KEY, jc, jnp.float32)
            batch = _batch(jc)
            opts = {k: mk() for k, (_, mk, _) in OPTS.items()}

            @jax.jit
            def run(p, batch):
                # make_train_step's body (steps.py:114-118), its gradient
                # taken once for both optimizers (a second backward doubles
                # the compile)
                loss, grads = jax.value_and_grad(JST.make_loss_fn(jc, remat=False))(p, batch)
                steps = {}
                for k, opt in opts.items():
                    updates, opt_state = opt.update(grads, opt.init(p), p)
                    steps[k] = ({"params": JO.apply_updates(p, updates), "opt": opt_state},
                                {"loss": loss})
                return loss, grads, steps

            loss, grads, steps = run(jp, batch)
            cache[name] = {"params": _np(jp), "batch": _np(batch), "loss": float(loss),
                           "grads": _np(grads), "steps": _np(steps)}
        return cache[name]
    return get


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _close_leaf(got, want, where, rtol=TOL, scale=TOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * max(np.abs(want).max(), 1e-30),
                               err_msg=where)


def _close_trees(got, want, where, **kw):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want], where
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, f"{where}{path}"
        _close_leaf(g, w, f"{where}{path}", **kw)


def _port_grads(name, ref, remat=False):
    cfg = get_config(name, smoke=True)
    params = _bridge(ref["params"], cfg)
    loss, grads = value_and_grad(ST.make_loss_fn(cfg, remat=remat), params.tree(),
                                 _to_torch(ref["batch"]))
    return loss, grads


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_gradients_match_reference(name, reference):
    ref = reference(name)
    loss, grads = _port_grads(name, ref)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=TOL, atol=TOL)
    _close_trees(lm_params_to_numpy(grads), ref["grads"], "grad")


@pytest.mark.parametrize("opt_name", list(OPTS))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step_matches_reference(name, opt_name, reference):
    ref = reference(name)
    cfg = get_config(name, smoke=True)
    mk, _, lr = OPTS[opt_name]
    opt = mk()
    params = _bridge(ref["params"], cfg)
    state = {"params": params, "opt": opt.init(params.tree())}
    new, metrics = ST.make_train_step(cfg, opt, remat=False)(state, _to_torch(ref["batch"]))
    jstate, jmetrics = ref["steps"][opt_name]
    assert new["params"] is params                     # updated in place
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=TOL,
                               atol=TOL)
    got_opt = lm_opt_state_to_numpy(new["opt"])
    assert int(got_opt["step"]) == int(jstate["opt"]["step"]) == 1
    for k in ("m", "v"):
        _close_trees(got_opt[k], jstate["opt"][k], f"opt.{k}")
    before, grads = _leaves(ref["params"]), _leaves(ref["grads"])
    for (path, p0), (_, g), (_, got), (_, want) in zip(
            before, grads, _leaves(lm_params_to_numpy(params)), _leaves(jstate["params"])):
        noise = np.abs(g) < NOISE * max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(got[~noise], want[~noise], rtol=TOL, atol=TOL,
                                   err_msg=f"params{path}")
        assert (np.abs(got - p0)[noise] <= lr * (1 + TOL)).all(), f"params{path}"


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_gradients_equal_no_remat(name, reference):
    """torch.utils.checkpoint recomputes each layer in its backward: the
    same ops on the same inputs, so the gradients are bit-equal on the CPU."""
    ref = reference(name)
    l0, g0 = _port_grads(name, ref, remat=False)
    l1, g1 = _port_grads(name, ref, remat=True)
    assert torch.equal(l0, l1)
    flat0, flat1 = lm_params_to_numpy(g0), lm_params_to_numpy(g1)
    for (path, a), (_, b) in zip(_leaves(flat0), _leaves(flat1)):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", ["granite-8b", "deepseek-v3-671b", "zamba2-1.2b"])
def test_bf16_train_step_matches_reference(name, reference):
    """The trained dtype: the reference's own bf16 init at PRNGKey(0) (its
    float32 init at the same key, cast, as ``init_lm`` draws it) and its
    tokens, one step of ``chain_clip(adam(1e-2), 1.0)`` (the
    reference's train test's optimizer, tests/test_lm_archs.py:48) in both
    packages: loss, parameters and moments within rtol/atol 8e-2 (moments
    scaled per leaf as above), leaf dtypes equal."""
    jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
    shapes = jax.eval_shape(lambda: JT.init_lm(KEY, jc))
    jp = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a, s.dtype),
                                reference(name)["params"], shapes)
    batch = _batch(jc)
    jopt, opt = OPTS["adam"][1](), OPTS["adam"][0]()
    jstate, jm = jax.jit(JST.make_train_step(jc, jopt, remat=False))(
        {"params": jp, "opt": jopt.init(jp)}, batch)
    params = lm_params_from_numpy(_np(jp), cfg)
    assert any(p.dtype == torch.bfloat16 for p in params.parameters())
    state = {"params": params, "opt": opt.init(params.tree())}
    new, m = ST.make_train_step(cfg, opt, remat=False)(state, _to_torch(_np(batch)))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **BF16_TOL)
    got = lm_params_to_numpy(params)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(_np(jstate["params"]))):
        where = f"params{jax.tree_util.keystr(path)}"
        assert g.dtype == w.dtype, where
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   err_msg=where, **BF16_TOL)
    got_opt = lm_opt_state_to_numpy(new["opt"])
    for k in ("m", "v"):
        _close_trees(got_opt[k], _np(jstate["opt"][k]), f"opt.{k}", rtol=8e-2, scale=8e-2)


def test_opt_state_bridge_round_trip(reference):
    cfg = get_config("deepseek-v3-671b", smoke=True)
    jstate = reference("deepseek-v3-671b")["steps"]["adam"][0]["opt"]
    back = lm_opt_state_to_numpy(lm_opt_state_from_numpy(jstate, cfg))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jstate)
    for a, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    with pytest.raises(ValueError, match="leading axis"):
        lm_opt_state_from_numpy(jstate, dataclasses.replace(cfg, n_layers=1))


def test_serve_steps_record_no_graph(reference):
    """After a train step the leaves take gradients; the prefill and decode
    steps still record no graph, and give what the model functions give."""
    cfg = get_config("granite-8b", smoke=True)
    params = _bridge(reference("granite-8b")["params"], cfg)
    opt = ST.make_optimizer()
    batch = _to_torch(reference("granite-8b")["batch"])
    ST.make_train_step(cfg, opt)({"params": params, "opt": opt.init(params.tree())}, batch)
    logits, caches = ST.make_prefill_step(cfg, tbase.ShapeSpec("p", 24, B, "prefill"))(
        params, batch)
    assert logits.grad_fn is None and logits.shape == (B, cfg.vocab_padded)
    with torch.no_grad():
        want, _ = T.lm_prefill(params, cfg, batch["tokens"], 24)
    assert torch.equal(logits, want)
    tok = logits.argmax(-1, keepdim=True)
    out, caches = ST.make_decode_step(cfg)(params, caches, tok, S)
    assert out.grad_fn is None and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# abstract specs, the cost model, the roofline
# ---------------------------------------------------------------------------

def _shapes(tree):
    return jax.tree_util.tree_map(lambda t: tuple(t.shape), tree)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_batches_and_caches_match_reference(name):
    """The meta batches and caches of every full config and shape cell have
    the reference's shapes (tokens int64 here, int32 there) and the caches
    its dtypes."""
    cfg, jc = get_config(name), jget_config(name)
    for shape, jshape in zip(tbase.ALL_SHAPES, jbase.ALL_SHAPES):
        for fn, jfn in ((ST.train_batch_abstract, JST.train_batch_abstract),
                        (ST.decode_batch_abstract, JST.decode_batch_abstract)):
            got, want = fn(cfg, shape), jfn(jc, jshape)
            assert _shapes(got) == _shapes(want), (name, shape.name, fn.__name__)
            assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(got))
        got, want = ST.abstract_caches(cfg, shape), JST.abstract_caches(jc, jshape)
        assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got) == \
            jax.tree_util.tree_map(lambda t: (tuple(t.shape), np.dtype(t.dtype).name), want)


def test_abstract_train_state_sizes_granite_8b_without_a_card():
    cfg = granite_8b.FULL
    state = ST.abstract_train_state(cfg, ST.make_optimizer())
    params = jax.tree_util.tree_leaves(state["params"])
    n = sum(p.numel() for p in params)
    assert all(p.device.type == "meta" for p in params)
    # param_count_estimate leaves out the norm weights: 2 a layer and the final one
    assert n - tbase.param_count_estimate(cfg) == (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == 8_254_689_280
    for k in ("m", "v"):
        mom = jax.tree_util.tree_leaves(state["opt"][k])
        assert [tuple(t.shape) for t in mom] == [tuple(t.shape) for t in params]
        assert {t.dtype for t in mom} == {torch.float32}
    assert sum(p.numel() * p.element_size() for p in params) == 2 * n


@pytest.mark.parametrize("smoke", [False, True])
def test_cell_cost_equals_reference(smoke):
    for name, cfg in all_configs(smoke).items():
        jc = jget_config(name, smoke)
        for shape, jshape in zip(tbase.ALL_SHAPES, jbase.ALL_SHAPES):
            for chips in (1, 4, 256):
                got = C.cell_cost(cfg, shape, chips).as_dict()
                want = JC.cell_cost(jc, jshape, chips).as_dict()
                assert got.keys() == want.keys()
                for k in ("flops_global", "hbm_bytes_global"):
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=name)
                n = tbase.active_param_count_estimate(cfg)
                assert R.model_flops(cfg, shape, n) == JR.model_flops(jc, jshape, n)


def test_roofline_terms_math_on_h100_constants():
    """tests/test_roofline_distributed.py:77-84 on the port's constants,
    which are the H100's data sheet figures."""
    assert (R.PEAK_FLOPS, R.HBM_BW, R.ICI_BW) == (989e12, 3.35e12, 450e9)
    t = R.roofline(R.PEAK_FLOPS, R.HBM_BW, R.ICI_BW * 2, 4, R.PEAK_FLOPS * 4)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 1.0) < 1e-9
    assert abs(t.collective_s - 2.0) < 1e-9
    assert t.dominant == "collective"
    assert abs(t.useful_flops_ratio - 1.0) < 1e-9
    assert R.roofline(1e12, 1e9, 0, 1, 0).dominant == "compute"
    assert R.roofline(0, 0, 0, 1, 0).useful_flops_ratio == 0.0


def test_analytic_flops_cross_check_flop_counter():
    """tests/test_roofline_distributed.py:87-126's twin: the analytic
    prefill FLOPs of granite-3-2b SMOKE (B 2, S 64) against PyTorch's
    FlopCounterMode over the port's unrolled forward (layers, final norm,
    head on every position). Blockwise attention computes masked chunks
    too, and the counter counts only matmuls: the same order of magnitude,
    and not undercounted by layers."""
    cfg = get_config("granite-3-2b", smoke=True)
    params = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        x = params["embed"][toks]
        for lp in params["layers"]:
            x, _ = T.block_forward(lp, x, cfg)
        x = A.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        (x @ T.head_weight(params)).float()
    analytic = C.cell_cost(cfg, tbase.ShapeSpec("t", 64, 2, "prefill"), 1).flops_global
    ratio = analytic / fc.get_total_flops()
    assert 0.5 < ratio < 2.0, (analytic, fc.get_total_flops())


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-8b", "seamless-m4t-medium"])
def test_train_lm_smoke_runs_on_the_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--smoke", "--steps", "5", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == [f"step {i}" for i in range(5)]
    assert all(np.isfinite(float(ln.rsplit(" ", 1)[1])) for ln in lines)


def test_train_lm_smoke_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        launch_train.main(["--arch", "granite-8b", "--smoke", "--steps", "1"])


def test_dynamic_width_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_dynamic_width_lm", ROOT / "examples" / "torch_dynamic_width_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    dyn = dataclasses.replace(granite_8b.SMOKE, dynamic_width=True)
    losses = ex.run(dyn, steps=2, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    ex.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "static  FFN width  128: loss" in out and "FFN MAC saving: 25%" in out
