"""The train step's sharded arithmetic on a real mesh: granite-8b,
deepseek-v3 and zamba2 SMOKE on a (2, 2) mesh of four CPU processes over
gloo (``tests/_torch_gloo_mesh.py``), the loss and every gathered gradient
leaf held to the plain one-process step at rtol 1e-4 (of each leaf's
largest value). The dry run runs the same code on meta tensors, where
nothing checks its numbers."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_gloo_mesh import launch  # noqa: E402

ARCHS = ("granite-8b", "deepseek-v3-671b", "zamba2-1.2b")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("train", ARCHS, str(tmp_path_factory.mktemp("gloo") / "train.json"))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_equal_the_plain_step(results, arch):
    r = results[arch]
    assert r["leaves"] > 0
    assert r["loss"] <= 1e-4, r
    assert r["grads"] <= 1e-4, r
