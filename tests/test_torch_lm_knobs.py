"""The dry run's three model knobs against the reference, function by function
on the CPU in fp32 (rtol/atol 1e-4): Mamba-2's SSD form, the lazy MLA
expansion and the MoE's token-sharded dispatch; and ``apply_opts``, which
selects them, flag by flag against the reference's."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LMConfig as JConfig
from repro.configs.registry import get_config as jget_config
from repro.models.lm import attention as JA
from repro.models.lm import ffn as JF
from repro.models.lm import ssm as JS
from repro_torch.configs.base import LMConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.launch.dryrun import apply_opts
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import ffn as F
from repro_torch.models.lm import ssm as S

TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)

MLA = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=4, n_kv_heads=4, head_dim=8,
           d_ff=32, vocab_size=64, attn_chunk=5, use_mla=True, q_lora_rank=12,
           kv_lora_rank=10, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=6)
MOE = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
           vocab_size=64, n_experts=4, n_experts_per_tok=2, moe_d_ff=32, capacity_factor=2.0)
HYB = dict(name="t", family="hybrid", n_layers=1, d_model=16, n_heads=0, n_kv_heads=0, d_ff=0,
           vocab_size=64, ssm_state=4, ssm_chunk=5, ssm_head_dim=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def J(f, *static):
    return jax.jit(f, static_argnums=static)


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def tt(tree):
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(got, want, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=where, **TOL)


def cfgs(**kw):
    return JConfig(**kw), LMConfig(**kw)


@pytest.mark.parametrize("s", [10, 13])
def test_mamba2_ssd_forward_matches_reference_and_scan(s):
    """The SSD block-matmul form against the reference's (output and final
    state), and against the port's own scan form; 13 pads the last chunk."""
    jc, cfg = cfgs(**dict(HYB, mamba2_impl="ssd"))
    p = J(JS.init_mamba2, 1, 2)(KEY, jc, jnp.float32)
    u = rnd(2, s, 16, scale=0.5)
    want, wst = J(JS.mamba2_ssd_forward, 2, 3)(p, u, jc, True)
    got, gst = S.mamba2_forward(tt(p), torch.from_numpy(u), cfg, return_state=True)
    close(got, want)
    for k in wst:
        close(gst[k], wst[k], k)
    scan, sst = S.mamba2_forward(tt(p), torch.from_numpy(u),
                                 dataclasses.replace(cfg, mamba2_impl="scan"), return_state=True)
    close(got, scan)
    close(gst["h"], sst["h"])


@pytest.mark.parametrize("s,offset", [(11, 0), (7, 3)])
def test_lazy_mla_matches_reference_and_eager(s, offset):
    jc, cfg = cfgs(**dict(MLA, mla_lazy_kv=True))
    p = J(JA.init_mla, 1, 2)(KEY, jc, jnp.float32)
    x = rnd(2, s, 16)
    want = jax.jit(JA.mla_self_attention, static_argnums=2,
                   static_argnames="q_offset")(p, x, jc, q_offset=offset)
    got = A.mla_self_attention(tt(p), torch.from_numpy(x), cfg, q_offset=offset)
    close(got, want)
    eager = A.mla_self_attention(tt(p), torch.from_numpy(x),
                                 dataclasses.replace(cfg, mla_lazy_kv=False), q_offset=offset)
    close(got, eager)


@pytest.mark.parametrize("shared,cf", [(0, 2.0), (1, 0.5)])
def test_moe_token_shard_matches_reference_and_knob_off(shared, cf):
    """Without a mesh the token-sharded dispatch's constraints change
    nothing: the reference's output, and bit for bit the knob off."""
    jc, cfg = cfgs(**dict(MOE, n_shared_experts=shared, capacity_factor=cf,
                          moe_dispatch_token_shard=True))
    p = J(JF.init_moe, 1, 2)(KEY, jc, jnp.float32)
    x = rnd(2, 16, 16)
    want, waux = J(JF.moe_forward, 2)(p, x, jc)
    got, gaux = F.moe_forward(tt(p), torch.from_numpy(x), cfg)
    close(got, want)
    close(gaux, waux)
    off, off_aux = F.moe_forward(tt(p), torch.from_numpy(x),
                                 dataclasses.replace(cfg, moe_dispatch_token_shard=False))
    assert torch.equal(got, off) and torch.equal(gaux, off_aux)


@pytest.fixture(scope="module")
def ref_apply_opts():
    """The reference's ``apply_opts``. Its module sets XLA_FLAGS to fake 512
    devices when imported: the backend is made first (so the flag cannot
    reach it) and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import apply_opts as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.mark.parametrize("opts", ["token_shard", "mla_lazy", "ssd", "cf1", "chunk64",
                                  "attnchunk256", "token_shard,ssd,cf1", "", "moe_shardmap",
                                  "moe_shardmap,token_shard,cf1"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-1.2b"])
def test_apply_opts_matches_reference(ref_apply_opts, arch, opts):
    want = dataclasses.asdict(ref_apply_opts(jget_config(arch), opts))
    assert dataclasses.asdict(apply_opts(get_config(arch), opts)) == want


def test_apply_opts_errors_like_reference(ref_apply_opts):
    """An unknown flag is a ValueError in both; the shard_map MoE the
    reference selects is selected here too, field for field."""
    with pytest.raises(ValueError, match="unknown opt bogus"):
        ref_apply_opts(jget_config("granite-8b"), "bogus")
    with pytest.raises(ValueError, match="unknown opt bogus"):
        apply_opts(get_config("granite-8b"), "bogus")
    want = ref_apply_opts(jget_config("deepseek-v3-671b"), "moe_shardmap")
    got = apply_opts(get_config("deepseek-v3-671b"), "moe_shardmap")
    assert want.moe_impl == got.moe_impl == "shard_map"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_knobs_reach_every_config():
    """Every config takes the three knobs (they are inert where the family
    has no such layer)."""
    for arch in ARCH_NAMES:
        cfg = apply_opts(get_config(arch), "token_shard,mla_lazy,ssd")
        assert (cfg.moe_dispatch_token_shard, cfg.mla_lazy_kv, cfg.mamba2_impl) == (True, True, "ssd")
