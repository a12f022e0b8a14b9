"""The port's training half against ``repro``: the layers and init it
needs, the data stream, every optimizer and schedule, the losses, the
supernet trainer, gradient accumulation, the GAN phase, the megakernel's
gradient, the checkpoint writer and the two launchers. On the CPU, x2, a
toy supernet (C8, one SFB), one intra-op thread.

Tolerances: optimizers rtol 1e-5 / atol 1e-7 over three steps (bf16
moments 1e-3); losses rtol 1e-5 (SSIM 1e-4); four supernet steps: losses
rtol 1e-4, params and EMA within 1e-4 of each leaf's max magnitude; the
megakernel's gradients at the normalized atol 1e-3 of
tests/test_megakernel.py; checkpoints bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from repro.core import supernet as JS
from repro.data import synthetic as JD
from repro.models import layers as JL
from repro.models.essr import ESSRConfig as JCfg
from repro.models.essr import init_essr as j_init_essr
from repro.train import gan as JG
from repro.train import losses as JLs
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro_torch.api import SREngine
from repro_torch.core import supernet as S
from repro_torch.core.tree import tree_leaves
from repro_torch.data import synthetic as D
from repro_torch.kernels.megakernel import essr_forward_megakernel
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.essr import ESSR, ESSRConfig, essr_forward, init_essr
from repro_torch.train import gan as G
from repro_torch.train import losses as Ls
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T

CFG, JCFG = ESSRConfig(channels=8, n_sfb=1, scale=2), JCfg(channels=8, n_sfb=1, scale=2)
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
jleaves = jax.tree_util.tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    """A numpy (or jnp) tree as CPU tensors."""
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _np(tree):
    return [np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)
            for x in (tree_leaves(tree) if not isinstance(tree, list) else tree)]


def _close_per_leaf(got, want, tol=1e-4):
    """Each leaf within ``tol`` of that leaf's max magnitude."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= tol * max(float(np.max(np.abs(b))), 1e-12)


@pytest.fixture(scope="module")
def weights():
    return jax.tree_util.tree_map(np.asarray, j_init_essr(jax.random.PRNGKey(3), JCFG))


# ---------------------------------------------------------------------------
# layers, init, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(8, 8), (9, 9), (24, 25), (7, 12)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (0, 1))])
def test_conv2d_matches_lax(hw, stride, padding):
    """XLA's SAME pads (0, 1) at stride 2 on an even size, not (1, 1)."""
    rng = np.random.default_rng(hw[0] * 7 + stride)
    x = rng.random((2, *hw, 5), np.float32)
    w = rng.normal(size=(3, 3, 5, 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    want = np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                padding=padding))
    got = L.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=stride,
                   padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_counts_equal_reference():
    g = torch.Generator().manual_seed(0)
    for cin, cout in ((3, 54), (27, 48)):
        for bias in (True, False):
            mine = L.init_bsconv(cin, cout, g, bias=bias)
            theirs = JL.init_bsconv(jax.random.PRNGKey(0), cin, cout, bias=bias)
            assert {k: tuple(v.shape) for k, v in mine.items()} == \
                {k: tuple(v.shape) for k, v in theirs.items()}
            mine = L.init_dsconv(cin, cout, g, bias=bias)
            theirs = JL.init_dsconv(jax.random.PRNGKey(0), cin, cout, bias=bias)
            assert {k: tuple(v.shape) for k, v in mine.items()} == \
                {k: tuple(v.shape) for k, v in theirs.items()}
    for scale, want in ((4, 53886), (2, 51906)):
        model = init_essr(ESSRConfig(scale=scale), torch.Generator().manual_seed(1))
        assert isinstance(model, ESSR)
        jp = j_init_essr(jax.random.PRNGKey(1), JCfg(scale=scale))
        assert L.count_params(model) == L.count_params(model.tree()) == \
            JL.count_params(jp) == want
        for leaf in tree_leaves(model.tree()):
            if leaf.ndim == 1:
                assert not leaf.any()           # zero biases
    a = init_essr(CFG, torch.Generator().manual_seed(5)).tree()
    b = init_essr(CFG, torch.Generator().manual_seed(5)).tree()
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_eval_set_and_patch_batches_equal_reference():
    # the smooth tiles come from a bicubic resize, within 4e-7 of JAX's
    want = np.asarray(JD.make_eval_set(3, 2, hr=64))
    got = D.make_eval_set(3, 2, hr=64, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    mine = D.patch_batches(4, 3, 8, 2, pool=3, pool_hw=48, device="cpu")
    theirs = JD.patch_batches(4, 3, 8, 2, pool=3, pool_hw=48)
    for _ in range(3):
        (lr, hr), (jlr, jhr) = next(mine), next(theirs)
        assert lr.shape == (3, 8, 8, 3) and hr.shape == (3, 16, 16, 3)
        np.testing.assert_allclose(hr.numpy(), np.asarray(jhr), atol=1e-6)   # same crops
        np.testing.assert_allclose(lr.numpy(), np.asarray(jlr), atol=1e-6)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_cases():
    f32, bf = (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)
    return {
        "sgd": lambda m: (m.sgd(0.1), 1e-5),
        "sgd_momentum": lambda m: (m.sgd(m.constant(0.05), momentum=0.9), 1e-5),
        "adam": lambda m: (m.adam(1e-2), 1e-5),
        "adam_bf16": lambda m: (m.adam(1e-2, moment_dtype=bf[m is O]), 1e-3),
        "adamw": lambda m: (m.adamw(m.cosine_decay(1e-2, 10, warmup=2)), 1e-5),
        "lamb": lambda m: (m.lamb(m.cosine_decay(3e-3, 10)), 1e-5),
        "lamb_wd": lambda m: (m.lamb(m.multistep(3e-3, [1, 2]), weight_decay=0.1), 1e-5),
        "adafactor": lambda m: (m.adafactor(m.multistep(1e-2, [1, 2], gamma=0.3)), 1e-5),
        "chain_clip": lambda m: (m.chain_clip(m.adam(1e-2), 0.5), 1e-5),
        "f32_moments": lambda m: (m.adam(1e-3, moment_dtype=f32[m is O]), 1e-5),
    }


@pytest.mark.parametrize("name", list(_opt_cases()))
def test_optimizer_three_steps_match_reference(name):
    """Seeded numpy trees (matrices, vectors, a 4-D conv weight), three
    updates from seeded gradients: params and every state leaf."""
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    tree = {"w": rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(6, 4)).astype(np.float32)]}
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
             for _ in range(3)]
    (jo, _), (to, rtol) = _opt_cases()[name](JO), _opt_cases()[name](O)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, tree), _t(tree)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = to.update(_t(g), ts, tp)
        tp = O.apply_updates(tp, tu)
    tol = dict(rtol=rtol, atol=OPT_TOL["atol"] if rtol == 1e-5 else rtol)
    for a, b in zip(_np(tp), jleaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)
    assert len(tree_leaves(ts)) == len(jleaves(js))
    for a, b in zip(_np(ts), jleaves(js)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3


@pytest.mark.parametrize("sched", ["constant", "cosine", "cosine_warmup", "multistep"])
def test_schedules_match_reference(sched):
    make = {"constant": lambda m: m.constant(3e-3),
            "cosine": lambda m: m.cosine_decay(3e-3, 20, final_scale=0.1),
            "cosine_warmup": lambda m: m.cosine_decay(1e-2, 20, warmup=5),
            "multistep": lambda m: m.multistep(1e-4, [5, 15], gamma=0.5)}[sched]
    mine, theirs = make(O), make(JO)
    for step in range(0, 25):
        np.testing.assert_allclose(float(mine(torch.tensor(step, dtype=torch.int32))),
                                   float(theirs(jnp.asarray(step, jnp.int32))), **OPT_TOL)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(9)
    tree = {"a": rng.normal(size=(4, 4)).astype(np.float32), "b": [rng.normal(size=3)
                                                                   .astype(np.float32)]}
    np.testing.assert_allclose(float(O.global_norm(_t(tree))),
                               float(JO.global_norm(tree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        got, g = O.clip_by_global_norm(_t(tree), max_norm)
        want, jg = JO.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        np.testing.assert_allclose(float(g), float(jg), rtol=1e-6)
        for a, b in zip(_np(got), jleaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **OPT_TOL)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _images(seed=0, n=2, hw=32):
    rng = np.random.default_rng(seed)
    hr = np.stack([JD.random_image(seed + i, hw, hw) for i in range(n)])
    sr = np.clip(hr + 0.05 * rng.normal(size=hr.shape), 0, 1).astype(np.float32)
    return sr, hr


@pytest.mark.parametrize("name", ["l1_loss", "charbonnier", "psnr", "psnr_y", "ssim",
                                  "artifact_loss", "perceptual", "d_loss_fn", "g_adv_loss_fn"])
def test_losses_match_reference(name):
    sr, hr = _images()
    feat = jax.tree_util.tree_map(np.asarray, JLs.init_feature_net(jax.random.PRNGKey(7)))
    fns = {
        "perceptual": (lambda a, b: JLs.perceptual_distance(feat, a, b),
                       lambda a, b: Ls.perceptual_distance(feat, a, b)),
        "d_loss_fn": (lambda a, b: JLs.d_loss_fn(a.mean((1, 2, 3)), b.mean((1, 2, 3)) - 0.5),
                      lambda a, b: Ls.d_loss_fn(a.mean((1, 2, 3)), b.mean((1, 2, 3)) - 0.5)),
        "g_adv_loss_fn": (lambda a, b: JLs.g_adv_loss_fn(a.mean((1, 2, 3)) - b.mean((1, 2, 3))),
                          lambda a, b: Ls.g_adv_loss_fn(a.mean((1, 2, 3)) - b.mean((1, 2, 3)))),
    }
    jf, tf = fns[name] if name in fns else (getattr(JLs, name), getattr(Ls, name))
    want = float(jf(jnp.asarray(sr), jnp.asarray(hr)))
    got = float(tf(torch.tensor(sr), torch.tensor(hr)))
    np.testing.assert_allclose(got, want, rtol=1e-4 if name == "ssim" else 1e-5)


def test_feature_net_from_a_generator():
    a, b = (Ls.init_feature_net(torch.Generator().manual_seed(7)) for _ in range(2))
    assert [tuple(p["w"].shape) for p in a["convs"]] == [(3, 3, 3, 16), (3, 3, 16, 32),
                                                          (3, 3, 32, 64)]
    sr, hr = _images(1)
    d = Ls.perceptual_distance(None, torch.tensor(sr), torch.tensor(hr))
    assert float(d) == float(Ls.perceptual_loss(a, torch.tensor(sr), torch.tensor(hr))) > 0
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_artifact_loss_stops_the_map_gradient():
    sr, hr = _images(2)
    x = torch.tensor(sr, requires_grad=True)
    g_torch = torch.autograd.grad(Ls.artifact_loss(x, torch.tensor(hr)), x)[0]
    g_jax = jax.grad(JLs.artifact_loss)(jnp.asarray(sr), jnp.asarray(hr))
    np.testing.assert_allclose(g_torch.numpy(), np.asarray(g_jax), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the supernet and the trainer
# ---------------------------------------------------------------------------

def test_supernet_helpers_match_reference(weights):
    for cfg, jcfg in ((CFG, JCFG), (ESSRConfig(), JCfg())):
        np.testing.assert_array_equal(S.subnet_sampling_probs(cfg),
                                      JS.subnet_sampling_probs(jcfg))
    g = torch.Generator().manual_seed(0)
    draws = [S.sample_width(g, CFG) for _ in range(200)]
    assert set(draws) == {4, 8} and draws.count(8) > draws.count(4)
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    y = np.random.default_rng(1).random((2, 16, 16, 3), np.float32)
    for width in (4, 8):
        want = JS.supernet_loss_fn(JLs.l1_loss, JCFG)(weights, jnp.asarray(x), jnp.asarray(y),
                                                       width=width)
        got = S.supernet_loss_fn(Ls.l1_loss, CFG)(_t(weights), torch.tensor(x),
                                                   torch.tensor(y), width=width)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    ema = S.ema_init(_t(weights))
    other = jax.tree_util.tree_map(lambda a: a + 1.0, weights)
    got = S.ema_update(ema, _t(other), 0.9)
    want = JS.ema_update(JS.ema_init(weights), other, 0.9)
    for a, b in zip(_np(got), jleaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def test_train_essr_supernet_four_steps_match_reference(weights):
    """Four steps from the same numpy weights on the same batches: widths
    (from the log lines, one a step), losses, params and EMA."""
    it = JD.patch_batches(0, 2, 8, 2, pool=2, pool_hw=32)
    batches = [next(it) for _ in range(4)]
    jlog, tlog = [], []
    jp, jema, jh = JT.train_essr_supernet(jax.tree_util.tree_map(jnp.asarray, weights), JCFG,
                                          iter(batches), 4, seed=5, log_every=1,
                                          log_fn=jlog.append)
    model = params_from_numpy(weights, CFG)
    tb = iter([(torch.tensor(np.asarray(a)), torch.tensor(np.asarray(b))) for a, b in batches])
    m, ema, h = T.train_essr_supernet(model, CFG, tb, 4, seed=5, log_every=1,
                                      log_fn=tlog.append)
    assert m is model
    widths = [line.split()[3] for line in tlog]
    assert widths == [line.split()[3] for line in jlog] and len(set(widths)) == 2
    np.testing.assert_allclose(h, jh, rtol=1e-4)
    _close_per_leaf(jax.tree_util.tree_leaves(params_to_numpy(m)), jleaves(jp))
    _close_per_leaf(_np(ema), jleaves(jema))


def test_grad_accum_step_equals_full_batch(weights):
    """Two microbatches of two: the accumulated gradient is the full
    batch's (the loss is a mean), so the step lands where one full-batch
    step does; and both land where the reference's accumulation does."""
    it = JD.patch_batches(1, 4, 8, 2, pool=2, pool_hw=32)
    lr, hr = (np.asarray(a) for a in next(it))
    loss = S.supernet_loss_fn(Ls.l1_loss, CFG)
    fn = lambda p, a, b: loss(p, a, b, width=8)
    opt = O.sgd(0.5)
    accum = _t(weights)
    batch = (torch.tensor(lr).reshape(2, 2, 8, 8, 3), torch.tensor(hr).reshape(2, 2, 16, 16, 3))
    accum, _, val = T.make_grad_accum_step(fn, opt, 2)(accum, opt.init(accum), batch)
    full = _t(weights)
    v, grads = T.value_and_grad(fn, full, torch.tensor(lr), torch.tensor(hr))
    full = O.apply_updates(full, opt.update(grads, opt.init(full), full)[0])
    for a, b in zip(_np(accum), _np(full)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    jloss = JS.supernet_loss_fn(JLs.l1_loss, JCFG)
    jfn = lambda p, a, b: jloss(p, a, b, width=8)
    jopt = JO.sgd(0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jp, _, jval = JT.make_grad_accum_step(jfn, jopt, 2)(
        jp, jopt.init(jp), (jnp.asarray(lr).reshape(2, 2, 8, 8, 3),
                            jnp.asarray(hr).reshape(2, 2, 16, 16, 3)))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    _close_per_leaf(_np(accum), jleaves(jp), 1e-5)


def test_gan_step_matches_reference(weights):
    """One generator step and one discriminator step from the same weights,
    discriminator and feature net (the reference's, as numpy)."""
    d_np = jax.tree_util.tree_map(np.asarray, JG.init_discriminator(jax.random.PRNGKey(0)))
    f_np = jax.tree_util.tree_map(np.asarray, JLs.init_feature_net(jax.random.PRNGKey(7)))
    lr, hr = (np.asarray(a) for a in next(JD.patch_batches(2, 2, 16, 2, pool=2, pool_hw=48)))
    jg, jd = JG.make_gan_steps(JCFG, JO.adam(1e-3), JO.adam(1e-3), f_np)
    tg, td = G.make_gan_steps(CFG, O.adam(1e-3), O.adam(1e-3), _t(f_np))
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jdp = jax.tree_util.tree_map(jnp.asarray, d_np)
    jp, _, jsr, jgl = jg(jp, JO.adam(1e-3).init(jp), jdp, jnp.asarray(lr), jnp.asarray(hr),
                         width=8)
    jdp, _, jdl = jd(jdp, JO.adam(1e-3).init(jdp), jsr, jnp.asarray(hr))
    tp, tdp = _t(weights), _t(d_np)
    tp, _, tsr, tgl = tg(tp, O.adam(1e-3).init(tp), tdp, torch.tensor(lr), torch.tensor(hr),
                         width=8)
    tdp, _, tdl = td(tdp, O.adam(1e-3).init(tdp), tsr, torch.tensor(hr))
    np.testing.assert_allclose(float(tgl), float(jgl), rtol=1e-5)
    np.testing.assert_allclose(float(tdl), float(jdl), rtol=1e-5)
    np.testing.assert_allclose(tsr.numpy(), np.asarray(jsr), rtol=1e-4, atol=1e-5)
    _close_per_leaf(_np(tp), jleaves(jp))
    _close_per_leaf(_np(tdp), jleaves(jdp))


@pytest.mark.parametrize("hw", [16, 17, 24])
def test_discriminate_matches_reference(hw):
    d_np = jax.tree_util.tree_map(np.asarray, JG.init_discriminator(jax.random.PRNGKey(1)))
    x = np.random.default_rng(hw).random((2, hw, hw, 3), np.float32)
    want = np.asarray(JG.discriminate(d_np, jnp.asarray(x)))
    got = G.discriminate(_t(d_np), torch.tensor(x)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    mine = G.init_discriminator(torch.Generator().manual_seed(1))
    assert [tuple(p["w"].shape) for p in mine["convs"]] == \
        [tuple(p["w"].shape) for p in d_np["convs"]]
    assert L.count_params(mine) == JL.count_params(d_np)


def test_train_essr_gan_runs_and_moves_the_weights():
    model = init_essr(CFG, torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    data = D.patch_batches(0, 2, 8, 2, pool=2, pool_hw=32, device="cpu")
    logs = []
    m, d_params, hist = G.train_essr_gan(model, CFG, data, 2, log_every=1, log_fn=logs.append)
    assert m is model and len(hist) == 2 and len(logs) == 2
    assert all(np.isfinite(h).all() for h in hist)
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# the megakernel's gradient (the plain forward's, recomputed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [4, 8])
def test_megakernel_grad_and_jvp_match_plain(weights, width):
    """The CPU path of tests/test_megakernel.py:112-135: reverse mode for x
    and every weight leaf, forward mode for x and for the weights, against
    the plain forward at the normalized atol 1e-3."""
    params = _t(weights)
    with torch.no_grad():
        for p in tree_leaves(params):
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    x = torch.from_numpy(np.random.default_rng(2).random((2, 12, 12, 3), np.float32))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    xg = x.clone().requires_grad_(True)

    def loss(fwd, p, v):
        return torch.sum(fwd(p, v, CFG, width=width) ** 2)

    got = torch.autograd.grad(loss(essr_forward_megakernel, params, xg), [xg] + leaves)
    want = torch.autograd.grad(loss(essr_forward, params, xg), [xg] + leaves)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-6)
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=1e-3)
    dx = torch.ones_like(x) * 0.1
    with fwAD.dual_level():
        t = fwAD.unpack_dual(loss(essr_forward_megakernel, params,
                                  fwAD.make_dual(x, dx))).tangent
    t_ref = torch.sum(want[0] * dx)
    np.testing.assert_allclose(float(t.detach()), float(t_ref), rtol=1e-3)
    # a tangent on one weight leaf
    w = params["sfbs"][0]["fuse"]
    dw = torch.full_like(w, 0.01)
    with fwAD.dual_level():
        dual = dict(params, sfbs=[dict(params["sfbs"][0], fuse=fwAD.make_dual(w.detach(), dw))])
        t = fwAD.unpack_dual(loss(essr_forward_megakernel, dual, x)).tangent
    k = [i for i, leaf in enumerate(leaves) if leaf is w][0]
    np.testing.assert_allclose(float(t.detach()), float(torch.sum(want[1 + k] * dw)), rtol=1e-3)


def test_megakernel_repacks_after_an_in_place_update(weights):
    params = _t(weights)
    x = torch.from_numpy(np.random.default_rng(3).random((1, 10, 10, 3), np.float32))
    with torch.inference_mode():
        a = essr_forward_megakernel(params, x, CFG)
    assert not a.requires_grad
    O.apply_updates(params, {k: v for k, v in
                             zip(["first", "sfbs", "recon"],
                                 [jax.tree_util.tree_map(lambda t: torch.full_like(t, 0.01),
                                                         params[k])
                                  for k in ("first", "sfbs", "recon")])})
    b = essr_forward_megakernel(params, x, CFG)
    torch.testing.assert_close(b, essr_forward(params, x, CFG), rtol=1e-5, atol=1e-5)
    assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# the checkpoint writer
# ---------------------------------------------------------------------------

def test_checkpoints_cross_restore_both_ways(weights, tmp_path):
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    from repro.ckpt.checkpoint import CheckpointManager as JManager
    from repro_torch.ckpt.checkpoint import CheckpointManager
    opt, jopt = O.lamb(3e-3), JO.lamb(3e-3)
    tp = _t(weights)
    state = T.TrainState(params=tp, opt_state=opt.init(tp), ema=S.ema_init(tp), step=7)
    mine = CheckpointManager(str(tmp_path / "port"), keep=2)
    mine.save(7, state.tree(), meta={"who": "port"})
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jstate = JT.TrainState(params=jp, opt_state=jopt.init(jp), ema=JS.ema_init(jp), step=7)
    theirs_back, meta = JManager(str(tmp_path / "port")).restore(jstate.tree())
    assert meta == {"who": "port", "step": 7}
    for a, b in zip(jleaves(theirs_back), tree_leaves(state.tree())):
        assert np.array_equal(np.asarray(a), np.asarray(b.detach() if isinstance(
            b, torch.Tensor) else b))
    JManager(str(tmp_path / "jax")).save(3, jstate.tree(), meta={"who": "jax"})
    back, meta = CheckpointManager(str(tmp_path / "jax")).restore(state.tree())
    assert meta == {"who": "jax", "step": 3}
    assert back["opt_state"]["step"].dtype == torch.int32
    for a, b in zip(tree_leaves(back), jleaves(jstate.tree())):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the same layout: template, leaf files, dtypes and shapes
    a, b = mine.read_manifest(), JManager(str(tmp_path / "jax")).read_manifest()
    assert a["tree_template"] == b["tree_template"] and a["leaves"] == b["leaves"]
    assert a["treedef"] == b["treedef"]


def test_bf16_moments_cross_restore(tmp_path):
    """Adam's bf16 moments: written as the reference writes them (2-byte
    patterns, "bfloat16" in the manifest) and read back bit for bit, from
    either package's checkpoint."""
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    from repro.ckpt.checkpoint import CheckpointManager as JManager
    from repro_torch.ckpt.checkpoint import CheckpointManager
    tree = {"w": np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)}
    grads = {"w": np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)}
    opt, jopt = O.adam(1e-2, moment_dtype=torch.bfloat16), JO.adam(1e-2,
                                                                   moment_dtype=jnp.bfloat16)
    _, state = opt.update(_t(grads), opt.init(_t(tree)), _t(tree))
    _, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                            jopt.init(jax.tree_util.tree_map(jnp.asarray, tree)), tree)
    CheckpointManager(str(tmp_path / "port")).save(1, state)
    JManager(str(tmp_path / "jax")).save(1, jstate)
    mine = CheckpointManager(str(tmp_path / "port"))
    theirs = CheckpointManager(str(tmp_path / "jax"))
    assert mine.read_manifest()["leaves"] == theirs.read_manifest()["leaves"]
    for d in ("port", "jax"):
        back, _ = CheckpointManager(str(tmp_path / d)).restore(state)
        assert back["m"]["w"].dtype == torch.bfloat16
        for a, b in zip(tree_leaves(back), tree_leaves(state)):
            assert torch.equal(a, b)


def test_checkpoint_async_keep_and_atomic(tmp_path):
    from repro_torch.ckpt.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "opt": None,
            "t": (torch.ones(2), 5)}
    for step in range(1, 5):
        mgr.save(step, tree, blocking=False)
        tree["w"].add_(1.0)                     # the snapshot was taken already
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    back, meta = mgr.restore(tree, step=3)
    assert meta["step"] == 3 and back["opt"] is None and isinstance(back["t"], tuple)
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32).reshape(2, 3) + 2)
    assert int(back["t"][1]) == 5
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": tree["w"]})


def test_engine_serves_a_port_checkpoint_equal_to_from_params(weights, tmp_path):
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    from repro.api import SREngine as JEngine
    from repro_torch.ckpt.checkpoint import CheckpointManager
    tp = _t(weights)
    ema = S.ema_update(S.ema_init(tp), jax.tree_util.tree_map(lambda t: t * 0.5, tp), 0.5)
    CheckpointManager(str(tmp_path)).save(1, {"params": tp, "ema": ema})
    frame = np.random.default_rng(0).random((40, 40, 3), np.float32)
    a = SREngine.from_checkpoint(str(tmp_path), cfg=CFG, device="cpu").upscale(frame)
    b = SREngine.from_params(jax.tree_util.tree_map(lambda t: t.numpy(), ema), CFG,
                             device="cpu").upscale(frame)
    assert torch.equal(a.image, b.image)
    c = JEngine.from_checkpoint(str(tmp_path), cfg=JCFG, bench_cache=None).upscale(frame)
    np.testing.assert_allclose(a.image.numpy(), np.asarray(c.image), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# an engine built from a model under training
# ---------------------------------------------------------------------------

def test_engine_from_a_training_model_serves_a_detached_copy():
    """Train a step, build an engine from the model, train another step:
    the trainer's tensors still take gradients and move, and the engine's
    frame is the one of the weights it was built from."""
    model = init_essr(CFG, torch.Generator().manual_seed(4))
    data = D.patch_batches(0, 2, 8, 2, pool=2, pool_hw=32, device="cpu")
    opt = O.adam(1e-2)
    tree = model.tree()
    state, ema = opt.init(tree), S.ema_init(tree)
    step = T.make_supernet_step(CFG, opt)
    tree, state, ema, _ = step(tree, state, ema, *next(data), width=8)
    frame = np.random.default_rng(1).random((40, 40, 3), np.float32)
    eng = SREngine(model, device="cpu")
    assert eng.model is not model and all(p.requires_grad for p in model.parameters())
    before = eng.upscale(frame).image.clone()
    snap = [p.detach().clone() for p in model.parameters()]
    tree, state, ema, val = step(tree, state, ema, *next(data), width=8)
    assert torch.isfinite(val)
    assert all(not torch.equal(a, b) for a, b in zip(snap, model.parameters()))
    assert torch.equal(eng.upscale(frame).image, before)
    # from_params takes tensors that take gradients, too
    again = SREngine.from_params(tree, CFG, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    assert not torch.equal(again.upscale(frame).image, before)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launch_train_and_serve_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train
    ck = str(tmp_path / "ck")
    train.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--patch", "8",
                "--scale", "2", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "PSNR phase: 3 steps" in out and out.count("eval width=") == 3
    assert os.listdir(ck) == ["step_3"]
    with pytest.warns(UserWarning, match="single-device"):
        serve.main(["--device", "cpu", "--frames", "2", "--hw", "48", "--scale", "2",
                    "--shards", "2", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "(restored 'ema' weights" in out and "serving backend: cuda-plain" in out
    assert out.count("shard_c54=") == 2 and "'shards': 2" in out
    # a non-essr arch takes the LM mode, which knows only ARCH_NAMES (as the
    # reference's registry does)
    with pytest.raises(KeyError, match="unknown arch 'gpt-smoke'"):
        train.main(["--arch", "gpt-smoke", "--device", "cpu"])
