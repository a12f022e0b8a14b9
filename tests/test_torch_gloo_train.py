"""The train step's sharded arithmetic on a real mesh: SMOKE configs on
meshes of four CPU processes over gloo (``tests/_torch_gloo_mesh.py``), the
loss and every gathered gradient leaf held to the plain one-process step at
rtol 1e-4 (of each leaf's largest value). The dry run runs the same code on
meta tensors, where nothing checks its numbers.

On (2, 2): granite-8b, deepseek-v3 and zamba2, then deepseek-v3 with the
explicit shard_map MoE in both modes (its capacity raised so that no shard
drops a token, the plain step's aux the mean of each shard's). On (1, 4),
item 16d's mesh (tensor and sequence parallelism over the model axis, no
data split): granite-8b, zamba2 and deepseek-v3, and deepseek-v3 under
``moe_impl="shard_map"``, ``moe_mode="expert_tp"`` at its own capacity
factor, where per-shard capacity and aux are the global ones, so the plain
step is the einsum step itself. Also on (1, 4): qwen2 SMOKE with 14 query
heads, which the model axis does not divide (the attention splits its query
rows), and falcon-mamba, whose merged in_proj is read as two halves."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_gloo_mesh import launch  # noqa: E402

ARCHS = ("granite-8b", "deepseek-v3-671b", "zamba2-1.2b")
CASES = ARCHS + ("deepseek-v3-671b+expert_tp", "deepseek-v3-671b+ep_alltoall",
                 "granite-8b@1x4", "zamba2-1.2b@1x4", "deepseek-v3-671b@1x4",
                 "deepseek-v3-671b@1x4+expert_tp", "qwen2-14h@1x4", "falcon-mamba-7b@1x4")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("train", CASES, str(tmp_path_factory.mktemp("gloo") / "train.json"))


@pytest.mark.parametrize("arch", CASES)
def test_sharded_loss_and_gradients_equal_the_plain_step(results, arch):
    r = results[arch]
    assert r["leaves"] > 0
    assert r["loss"] <= 1e-4, r
    assert r["grads"] <= 1e-4, r


def test_shardmap_step_on_the_model_axis_alone_is_the_einsum_step(results):
    """On (1, 4) the shard_map MoE's step is the einsum step's: the same
    loss to the last bit of its sum, and both within 1e-4 of the plain step
    (deepseek-v3 SMOKE at its capacity factor 1.25, so tokens drop)."""
    sm, es = results["deepseek-v3-671b@1x4+expert_tp"], results["deepseek-v3-671b@1x4"]
    assert sm["loss_value"] == es["loss_value"]
    assert max(sm["loss"], sm["grads"], es["loss"], es["grads"]) <= 1e-4
