"""The port's training supervisor and straggler monitor against
``repro.runtime.fault_tolerance``, the supervisor around the port's
supernet step, and the port's three examples, on the CPU.

The reference's scenarios run in both packages: restarts and ``failures``
strings equal, final states equal (crash at 47, restore from 40; the
elastic reshard hook; the restart budget; a crash before the first
checkpoint). Around the supernet step (C8, one SFB, x2) a run with an
injected failure is ``torch.equal`` to one without, and to
`train_essr_supernet` on the same draws.
"""
import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime import fault_tolerance as JFT
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core import supernet as S
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import patch_batches
from repro_torch.models.essr import ESSRConfig, init_essr
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T

ROOT = Path(__file__).resolve().parents[1]
TOY = ESSRConfig(channels=8, n_sfb=1, scale=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the reference's scenarios, in both packages
# ---------------------------------------------------------------------------

def _scenario(pkg, directory, *, steps, ckpt_every, fail_at=(), max_restarts=8,
              async_ckpt=False, reshard=None):
    """One supervisor run: the state ``w`` sums the steps; ``fail_at`` lists
    the steps whose failure hook raises (each once, in order of arrival)."""
    if pkg == "jax":
        ft, cm = JFT, JCheckpointManager(str(directory), keep=3)
        state, batch = {"w": jnp.zeros(())}, (lambda s: jnp.asarray(float(s)))
    else:
        ft, cm = FT, CheckpointManager(str(directory), keep=3)
        state, batch = {"w": torch.zeros(())}, (lambda s: torch.tensor(float(s)))
    sup = ft.TrainSupervisor(lambda st, b: ({"w": st["w"] + b}, {}), batch, cm,
                             ft.SupervisorConfig(ckpt_every=ckpt_every,
                                                 max_restarts=max_restarts,
                                                 async_ckpt=async_ckpt))
    pending = list(fail_at)

    def hook(step):
        if pending and step == pending[0]:
            pending.pop(0)
            raise ft.InjectedFailure(f"simulated node loss at {step}")

    try:
        out = sup.run(state, 0, steps, failure_hook=hook, reshard=reshard)
        result = float(np.asarray(out["w"]))
    except (RuntimeError, ft.InjectedFailure) as e:
        result = f"{type(e).__name__}: {e}"
    return result, sup.restarts, sup.failures, cm.all_steps()


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_crash_at_47_replays_like_the_reference(tmp_path, async_ckpt):
    """Crash at 47, restore from 40, the same final state as a crash-free run."""
    kw = dict(steps=60, ckpt_every=10, async_ckpt=async_ckpt)
    want = _scenario("jax", tmp_path / "j", fail_at=[47], **kw)
    got = _scenario("torch", tmp_path / "t", fail_at=[47], **kw)
    clean = _scenario("torch", tmp_path / "c", **kw)
    assert got == want
    assert got[:2] == (clean[0], 1) and got[2] == ["step 47: simulated node loss at 47"]
    assert got[0] == float(sum(range(60)))


def test_reshard_hook_runs_on_each_recovery(tmp_path):
    calls = {"jax": [], "torch": []}
    got = {pkg: _scenario(pkg, tmp_path / pkg, steps=20, ckpt_every=5, fail_at=[7, 13],
                          reshard=lambda s, pkg=pkg: (calls[pkg].append(1), s)[1])
           for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    assert calls["torch"] == calls["jax"] == [1, 1]


def test_restart_budget_is_enforced_like_the_reference(tmp_path):
    kw = dict(steps=30, ckpt_every=5, fail_at=[6, 7, 12, 12, 13], max_restarts=3)
    want = _scenario("jax", tmp_path / "j", **kw)
    got = _scenario("torch", tmp_path / "t", **kw)
    assert got == want
    assert got[0] == "RuntimeError: restart budget exhausted" and got[1] == 4


def test_crash_before_the_first_checkpoint_reraises(tmp_path):
    kw = dict(steps=30, ckpt_every=10, fail_at=[4])
    want = _scenario("jax", tmp_path / "j", **kw)
    got = _scenario("torch", tmp_path / "t", **kw)
    assert got == want
    assert got[0] == "InjectedFailure: simulated node loss at 4" and got[3] == []


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = FT.StragglerMonitor(6, k=1.3, decay=0.7), JFT.StragglerMonitor(6, k=1.3,
                                                                               decay=0.7)
    assert ours.stragglers().tolist() == ref.stragglers().tolist() == []
    slow = np.array([1.0, 1.0, 1.0, 1.0, 2.5, 1.0])
    for _ in range(40):
        shard = int(rng.integers(0, 6))
        dt = float(rng.gamma(4.0, 0.25) * slow[shard])
        ours.record(shard, dt)
        ref.record(shard, dt)
        assert ours.stragglers().tolist() == ref.stragglers().tolist()
        np.testing.assert_array_equal(ours.t, ref.t)
    assert 4 in ours.stragglers().tolist()


# ---------------------------------------------------------------------------
# the supervisor around the port's supernet step
# ---------------------------------------------------------------------------

def _supervised(directory, draws, fail_at=None, steps=12):
    model = init_essr(TOY, torch.Generator().manual_seed(1))
    opt = O.lamb(O.cosine_decay(3e-3, steps))
    tree = model.tree()
    state = {"params": tree, "opt_state": opt.init(tree), "ema": S.ema_init(tree)}
    sup = FT.TrainSupervisor(T.make_supervised_step(TOY, opt), draws.__getitem__,
                             CheckpointManager(str(directory)),
                             FT.SupervisorConfig(ckpt_every=4))

    def hook(step):
        if step == fail_at and not sup.restarts:
            raise FT.InjectedFailure("lost the card")

    return sup.run(state, 0, steps, failure_hook=hook), sup


def test_supervised_supernet_replay_is_bit_equal(tmp_path):
    steps = 12
    data = patch_batches(0, batch=2, lr_patch=8, scale=TOY.scale, pool=2, pool_hw=32,
                         device="cpu")
    draws = list(itertools.islice(T.supernet_draws(data, TOY, seed=0), steps))
    crashed, sup = _supervised(tmp_path / "a", draws, fail_at=10, steps=steps)
    clean, _ = _supervised(tmp_path / "b", draws, steps=steps)
    assert sup.restarts == 1 and sup.failures == ["step 10: lost the card"]
    for a, b in zip(tree_leaves(crashed), tree_leaves(clean)):
        assert torch.equal(a, b)
    # the uninterrupted supervisor is train_essr_supernet on the same draws
    model = init_essr(TOY, torch.Generator().manual_seed(1))
    _, ema, _ = T.train_essr_supernet(model, TOY, iter([(lr, hr) for lr, hr, _ in draws]),
                                      steps, opt=O.lamb(O.cosine_decay(3e-3, steps)), seed=0,
                                      log_every=0)
    for a, b in zip(tree_leaves({"p": model.tree(), "e": ema}),
                    tree_leaves({"p": clean["params"], "e": clean["ema"]})):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the examples, in process, on the CPU
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_run_on_the_cpu(tmp_path, capsys):
    _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "routing: bilinear=" in out and "bilinear reference:" in out
    ck = str(tmp_path / "ck")
    _example("torch_train_essr").main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                       "--patch", "8", "--scale", "2", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "PSNR phase: 2 steps" in out and f"checkpoints in {ck}" in out
    assert CheckpointManager(ck).latest_step() == 2
    _example("torch_serve_8k").main(["--device", "cpu", "--frames", "2", "--hw", "48",
                                     "--scale", "2", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "frame 1: PSNR_Y" in out and "mean PSNR_Y" in out
