"""The dry run on one rank (a 1 x 1 mesh) against the same step run for real
on the CPU: the counted FLOPs equal ``FlopCounterMode``'s count of the real
step, and the argument bytes the real state's and batch's, for granite-8b
SMOKE's train, prefill and decode at batch 4 x 64. On one rank nothing is
sharded, so the dry run must count exactly what runs. Then a MoE cell whose
tokens do not divide the ranks."""
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.models.lm import transformer as T

KINDS = ("train", "prefill", "decode")
SHAPES = {k: ShapeSpec(k, 64, 4, k) for k in KINDS}
CFG = get_config("granite-8b", smoke=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells():
    with fake_world(1):
        mi = SH.mesh_info(make_test_mesh((1, 1)))
        out = {k: ST.lower_cell(CFG, SHAPES[k], mi) for k in KINDS}
    assert not dist.is_initialized()
    return out


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tr in trees for t in tree_leaves(tr))


def _real(kind: str):
    """(FLOPs counted by FlopCounterMode, argument bytes) of one real step
    on the CPU, from seeded weights in the model dtype (bf16)."""
    g = torch.Generator().manual_seed(0)
    shape = SHAPES[kind]
    params = T.init_lm(CFG, generator=g, device="cpu")
    tokens = torch.randint(0, CFG.vocab_size, (shape.global_batch, shape.seq_len + 1), generator=g)
    if kind == "train":
        opt = ST.make_optimizer()
        state = {"params": params, "opt": opt.init(params.tree())}
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        args, run = (state["params"].tree(), state["opt"], batch), \
            lambda: ST.make_train_step(CFG, opt)(state, batch)
    elif kind == "prefill":
        batch = {"tokens": tokens[:, :-1]}
        args, run = (params.tree(), batch), lambda: ST.make_prefill_step(CFG, shape)(params, batch)
    else:
        caches = T.init_caches(CFG, shape.global_batch, shape.seq_len, device="cpu")
        token = tokens[:, :1]
        args, run = (params.tree(), caches, token), \
            lambda: ST.make_decode_step(CFG)(params, caches, token, shape.seq_len - 1)
    nbytes = _nbytes(*args)
    with FlopCounterMode(display=False) as fc:
        run()
    return fc.get_total_flops(), nbytes


@pytest.mark.parametrize("kind", KINDS)
def test_one_rank_counts_what_runs(cells, kind):
    flops, nbytes = _real(kind)
    assert cells[kind].flops == flops
    assert cells[kind].argument_bytes == nbytes
    assert cells[kind].collectives["count"] == 0
    assert cells[kind].temp_bytes > 0


def test_moe_tokens_that_do_not_divide_the_ranks():
    """deepseek-v3 SMOKE's train step at batch 2 on the (2, 2) mesh: the
    MTP block's 2 x 63 tokens do not divide the four ranks. DTensor split
    their gradient over every axis unevenly and could not view it back
    (ROADMAP fault 6, deepseek-v3 FULL train_4k on the multi-pod mesh);
    the MoE now takes it back over dp alone."""
    with fake_world(4):
        mi = SH.mesh_info(make_test_mesh((2, 2)))
        c = ST.lower_cell(get_config("deepseek-v3-671b", smoke=True),
                          ShapeSpec("t", 64, 2, "train"), mi)
    assert c.flops > 0 and c.collectives["count"] > 0
