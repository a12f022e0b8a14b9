"""Prefill and decode's sharded arithmetic on a real mesh: SMOKE configs on
meshes of four CPU processes over gloo (``tests/_torch_gloo_mesh.py``): a
prefill of 32 tokens into 64 positions, its caches laid out by
``cache_specs``, then one decode step; the gathered logits and every cache
leaf held to the plain one-process steps at rtol 1e-4 (of each tensor's
largest value). On (2, 2): granite-8b, deepseek-v3 and zamba2, and
deepseek-v3 through the explicit shard_map MoE in both modes (decode's one
token a sequence is padded to the model axis under expert parallelism); on
(1, 4): granite-8b (its decode merges the sequence-split cache's partial
softmaxes), qwen2 with 14 query heads and falcon-mamba."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_gloo_mesh import launch  # noqa: E402

ARCHS = ("granite-8b", "deepseek-v3-671b", "zamba2-1.2b")
CASES = ARCHS + ("deepseek-v3-671b+expert_tp", "deepseek-v3-671b+ep_alltoall", "granite-8b@1x4",
                 "qwen2-14h@1x4", "falcon-mamba-7b@1x4")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("serve", CASES, str(tmp_path_factory.mktemp("gloo") / "serve.json"))


@pytest.mark.parametrize("arch", CASES)
def test_sharded_prefill_and_decode_equal_the_plain_steps(results, arch):
    r = results[arch]
    assert r["leaves"] > 0
    for what in ("prefill logits", "prefill caches", "decode logits", "decode caches"):
        assert r[what] <= 1e-4, (what, r)
