"""The port's LM stacks (``repro_torch.models.lm``) against ``repro``'s, per
architecture: every ``ARCH_NAMES`` SMOKE config initialised by the
reference in float32 (once per architecture), carried across by the
bridge, then prefill logits and every cache leaf, one decode step (logits
and caches) and the loss value. Inputs are seeded numpy, ``B, S, ML = 2,
16, 24`` as tests/test_lm_archs.py:15.

Tolerance: rtol 1e-3 / atol 1e-3, the whole-chain tolerance of
tests/test_kernels.py:77 (float32 sums in another order than XLA's, the
SSM recurrences step by step where the reference scans associatively).
Also: each config equal field by field to the reference's, the parameter
estimates equal, the port's init against the reference's (shapes, dtypes
and scales), the bridge's round trip, and the bf16 decode-vs-prefill check
of tests/test_lm_archs.py:65-94 on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import granite_8b as jgranite
from repro.configs.registry import get_config as jget_config
from repro.models.lm import encdec as JE
from repro.models.lm import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.configs import granite_8b as tgranite
from repro_torch.configs.registry import ARCH_NAMES, all_configs, get_config
from repro_torch.models.convert import (encdec_params_from_numpy, encdec_params_to_numpy,
                                        lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models.lm import encdec as E
from repro_torch.models.lm import transformer as T

B, S, ML = 2, 16, 24
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors beside other test processes: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    src = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pe = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
          if cfg.frontend == "vision" else None)
    return toks, src, pe


@pytest.fixture(scope="module")
def built():
    """name -> (reference params, port params), built once per architecture."""
    cache = {}

    def get(name):
        if name not in cache:
            jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
            init = JE.init_encdec if cfg.is_encoder_decoder else JT.init_lm
            jp = jax.jit(init, static_argnums=(1, 2))(jax.random.PRNGKey(0), jc, jnp.float32)
            bridge = encdec_params_from_numpy if cfg.is_encoder_decoder else lm_params_from_numpy
            cache[name] = (jp, bridge(_np_tree(jp), cfg))
        return cache[name]
    return get


def _close(got, want, where):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=where, **TOL)


def _close_tree(got, want, where):
    assert set(got) == set(want), f"{where}: {sorted(got)} != {sorted(want)}"
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], f"{where}.{k}")
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), f"{where}.{k}"
            _close(got[k], want[k], f"{where}.{k}")


@pytest.fixture(scope="module")
def served(built):
    """name -> `_serve`'s results, computed once per architecture."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _serve(name, built)
        return cache[name]
    return get


def _serve(name, built):
    """Prefill S tokens, then decode token S, in both packages."""
    jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
    jp, tp = built(name)
    toks, src, pe = _inputs(cfg)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            jl, jcache = JE.encdec_prefill(jp, jc, src, toks[:, :S], ML)
            tl, tcache = E.encdec_prefill(tp, cfg, torch.from_numpy(src), t[:, :S], ML)
            pre = (jl, jcache, tl, {k: v.clone() for k, v in tcache.items()})
            jd, jcache2 = JE.encdec_decode_step(jp, jc, toks[:, S:], jcache, jnp.asarray(S))
            td, tcache2 = E.encdec_decode_step(tp, cfg, t[:, S:], tcache, S)
        else:
            off = 0 if pe is None else pe.shape[1]
            tpe = None if pe is None else torch.from_numpy(pe)
            jl, jcache = JT.lm_prefill(jp, jc, toks[:, :S], ML + off, pe)
            tl, tcache = T.lm_prefill(tp, cfg, t[:, :S], ML + off, tpe)
            pre = (jl, jcache, tl, jax.tree_util.tree_map(torch.clone, tcache))
            jd, jcache2 = JT.lm_decode_step(jp, jc, toks[:, S:], jcache, jnp.asarray(S + off))
            td, tcache2 = T.lm_decode_step(tp, cfg, t[:, S:], tcache, S + off)
    return pre, (jd, jcache2, td, tcache2)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_logits_and_caches_match_reference(name, served):
    (jl, jcache, tl, tcache), _ = served(name)
    assert tuple(tl.shape) == (B, get_config(name, smoke=True).vocab_padded)
    assert tl.dtype == torch.float32
    _close(tl, jl, "prefill logits")
    _close_tree(tcache, jcache, "caches")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_step_matches_reference(name, served):
    _, (jd, jcache, td, tcache) = served(name)
    _close(td, jd, "decode logits")
    _close_tree(tcache, jcache, "caches after decode")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_matches_reference(name, built):
    jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
    jp, tp = built(name)
    toks, src, pe = _inputs(cfg, seed=1)
    tok, lab = toks[:, :S], toks[:, 1:]
    t, lt = torch.from_numpy(tok).long(), torch.from_numpy(lab).long()
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            want = JE.encdec_loss(jp, jc, src, tok, lab, remat=False)
            got = E.encdec_loss(tp, cfg, torch.from_numpy(src), t, lt)
        else:
            want = JT.lm_loss(jp, jc, tok, lab, pe, remat=False)
            got = T.lm_loss(tp, cfg, t, lt, None if pe is None else torch.from_numpy(pe))
    assert np.isfinite(float(got)) and float(got) > 0
    _close(got, want, "loss")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_matches_reference_shapes_dtypes_and_scales(name, built):
    """The port's own init against the reference's: the same tree, shapes
    and dtypes; constant leaves equal; random leaves of the same scale."""
    cfg = get_config(name, smoke=True)
    jp, _ = built(name)
    init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
    to_np = encdec_params_to_numpy if cfg.is_encoder_decoder else lm_params_to_numpy
    want = _np_tree(jp)
    g = torch.Generator().manual_seed(0)
    got = to_np(init(cfg, generator=g, device="cpu", dtype=torch.float32))
    bf = to_np(init(cfg, generator=g, device="cpu"))
    jbf = jax.eval_shape(lambda: (JE.init_encdec if cfg.is_encoder_decoder else JT.init_lm)(
        jax.random.PRNGKey(0), jget_config(name, smoke=True)))
    for (path, w), (_, a), (_, b), (_, jb) in zip(
            jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(bf), jax.tree_util.tree_leaves_with_path(jbf)):
        where = jax.tree_util.keystr(path)
        assert a.shape == w.shape and a.dtype == w.dtype, where
        assert b.shape == jb.shape and np.dtype(b.dtype) == np.dtype(jb.dtype), where
        if np.ptp(w) == 0 or "A_log" in where:
            np.testing.assert_allclose(a, w, rtol=1e-6, err_msg=where)
        elif "dt_bias" in where:                     # softplus^-1 of U(1e-3, 1e-1)
            dt = np.log1p(np.exp(a))
            assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4), where
        else:
            assert abs(a.std() / w.std() - 1) < 0.25 and abs(a.mean()) < 4 * w.std() / \
                np.sqrt(w.size) + 1e-3, where


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bridge_round_trip(name, built):
    cfg = get_config(name, smoke=True)
    jp, tp = built(name)
    to_np = encdec_params_to_numpy if cfg.is_encoder_decoder else lm_params_to_numpy
    back = to_np(tp)
    want = _np_tree(jp)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    # bfloat16 leaves cross bit for bit
    jb = _np_tree(jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), jp))
    bridge = encdec_params_from_numpy if cfg.is_encoder_decoder else lm_params_from_numpy
    tb = bridge(jb, cfg)
    assert all(p.dtype == torch.bfloat16 for p in tb.parameters())
    for a, w in zip(jax.tree_util.tree_leaves(to_np(tb)), jax.tree_util.tree_leaves(jb)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(w, np.float32))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_caches_match_reference(name):
    """Empty caches: the reference's keys, layer-stacked shapes and dtypes;
    and a prefill's caches have the same tree."""
    jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
    if cfg.is_encoder_decoder:
        want = jax.eval_shape(lambda: JE.init_encdec_caches(jc, B, ML, S))
        got = E.init_encdec_caches(cfg, B, ML, S, device="cpu")
    else:
        want = jax.eval_shape(lambda: JT.init_caches(jc, B, ML))
        got = T.init_caches(cfg, B, ML, device="cpu")
        toks, _, _ = _inputs(cfg)
        if cfg.frontend != "vision":
            p = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
            with torch.no_grad():
                _, pre = T.lm_prefill(p, cfg, torch.from_numpy(toks[:, :S]).long(), ML)
            assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), pre) == \
                jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), got)
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), np.dtype(t.dtype).name), want)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got) == shapes


def test_bridge_refuses_a_wrong_tree():
    cfg = get_config("granite-8b", smoke=True)
    tree = lm_params_to_numpy(T.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                                        device="cpu", dtype=torch.float32))
    short = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "ln2"})
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(short, cfg)
    one = dataclasses.replace(cfg, n_layers=1)
    with pytest.raises(ValueError, match="leading axis"):
        lm_params_from_numpy(tree, one)
    wide = dict(tree, final_norm=np.ones(cfg.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(wide, cfg)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference_field_by_field(smoke):
    for name, cfg in all_configs(smoke).items():
        want = jget_config(name, smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), name
        assert (cfg.vocab_padded, cfg.resolved_head_dim, cfg.d_inner, cfg.dt_rank,
                cfg.has_attention, cfg.subquadratic) == \
            (want.vocab_padded, want.resolved_head_dim, want.d_inner, want.dt_rank,
             want.has_attention, want.subquadratic), name
        assert tbase.param_count_estimate(cfg) == jbase.param_count_estimate(want), name
        assert tbase.active_param_count_estimate(cfg) == \
            jbase.active_param_count_estimate(want), name
        for shape, jshape in zip(tbase.ALL_SHAPES, jbase.ALL_SHAPES):
            assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
            assert tbase.shape_applicable(cfg, shape) == jbase.shape_applicable(want, jshape)
    for a, b in ((tgranite.FULL_DYNWIDTH, jgranite.FULL_DYNWIDTH),
                 (tgranite.SMOKE_DYNWIDTH, jgranite.SMOKE_DYNWIDTH)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert hash(tgranite.FULL) == hash(dataclasses.replace(tgranite.FULL))


def test_granite_8b_full_is_the_served_model():
    cfg = get_config("granite-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff) == \
        (36, 4096, 32, 8, 14336)
    assert tbase.param_count_estimate(cfg) == 8_254_390_272
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("granite-9b")


@pytest.mark.parametrize("name", ["granite-8b", "deepseek-v3-671b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium", "qwen2-0.5b"])
def test_bf16_decode_matches_prefill_next_token(name, built):
    """tests/test_lm_archs.py:65-94 on the port alone, with that test's
    data (the reference's bf16 init at PRNGKey(0), its tokens and source):
    prefill S tokens, decode token S, against a prefill of S+1: rtol/atol
    8e-2, and the argmax a near-tie (<= 0.1). (Its data matters: bf16
    rounding can flip an MoE routing choice between the two runs, which
    the reference's own check does on other draws too.) The reference's
    bf16 init is its float32 init at the same key, cast."""
    jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
    key = jax.random.PRNGKey(0)
    init = JE.init_encdec if cfg.is_encoder_decoder else JT.init_lm
    shapes = jax.eval_shape(lambda: init(key, jc))
    tree = jax.tree_util.tree_map(lambda a, s: np.asarray(a).astype(s.dtype), built(name)[0],
                                  shapes)
    toks = torch.from_numpy(np.asarray(jax.random.randint(key, (B, S + 1), 0, cfg.vocab_size)
                                       ).astype(np.int64))
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            src = torch.from_numpy(np.array(jax.random.normal(key, (B, 8, cfg.d_model))))
            p = encdec_params_from_numpy(tree, cfg)
            _, caches = E.encdec_prefill(p, cfg, src, toks[:, :S], ML)
            ld, _ = E.encdec_decode_step(p, cfg, toks[:, S:S + 1], caches, S)
            lr, _ = E.encdec_prefill(p, cfg, src, toks, ML)
        else:
            p = lm_params_from_numpy(tree, cfg)
            _, caches = T.lm_prefill(p, cfg, toks[:, :S], ML)
            ld, _ = T.lm_decode_step(p, cfg, toks[:, S:S + 1], caches, S)
            lr, _ = T.lm_prefill(p, cfg, toks, ML)
    ld, lr = ld.numpy(), lr.numpy()
    np.testing.assert_allclose(ld, lr, rtol=8e-2, atol=8e-2)
    chosen = np.take_along_axis(lr, ld.argmax(-1)[..., None], -1)[..., 0]
    assert (lr.max(-1) - chosen <= 0.1).all(), "decode picked a non-near-tie token"


@pytest.mark.parametrize("name", ["granite-8b", "deepseek-v3-671b", "zamba2-1.2b"])
def test_bf16_prefill_and_decode_match_reference(name):
    """The served dtype against the reference: the reference's own bf16
    init (PRNGKey(0)) carried across, then both packages' prefill of S
    tokens and one decode step on tests/test_lm_archs.py:71's tokens;
    logits and every cache leaf within rtol/atol 8e-2. That is the
    reference's own bound for two bf16 computations of the same logits
    that round in another order (decode against prefill,
    tests/test_lm_archs.py:89): a bf16 rounding is up to 2^-8 relative (one
    unit is 1.6e-2 at the |3.9| these logits and caches reach), and the two
    packages round the same values at other points of the chain (XLA fuses
    casts that the port makes one by one). Leaf dtypes are held equal."""
    jc, cfg = jget_config(name, smoke=True), get_config(name, smoke=True)
    key = jax.random.PRNGKey(0)
    jp = jax.jit(JT.init_lm, static_argnums=(1,))(key, jc)
    tp = lm_params_from_numpy(_np_tree(jp), cfg)
    assert any(p.dtype == torch.bfloat16 for p in tp.parameters())
    toks = jax.random.randint(key, (B, S + 1), 0, cfg.vocab_size)
    t = torch.from_numpy(np.asarray(toks).astype(np.int64))
    jl, jcache = JT.lm_prefill(jp, jc, toks[:, :S], ML)
    jd, jcache2 = JT.lm_decode_step(jp, jc, toks[:, S:], jcache, jnp.asarray(S))
    with torch.no_grad():
        tl, tcache = T.lm_prefill(tp, cfg, t[:, :S], ML)
        pre = jax.tree_util.tree_map(torch.clone, tcache)
        td, tcache2 = T.lm_decode_step(tp, cfg, t[:, S:], tcache, S)
    bf = dict(rtol=8e-2, atol=8e-2)
    for where, got, want in (("prefill", (tl, pre), (jl, jcache)),
                             ("decode", (td, tcache2), (jd, jcache2))):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want), where
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(want)):
            key_ = f"{where}{jax.tree_util.keystr(path)}"
            assert str(g.dtype).replace("torch.", "") == np.dtype(w.dtype).name, key_
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       err_msg=key_, **bf)
