"""The port's LM substrate (``repro_torch.models.lm.{attention,ffn,ssm}``)
against ``repro``'s, function by function, on the CPU: the reference's
params initialised in float32 and carried across as tensors, the same
seeded numpy inputs through both.

Tolerance: rtol 1e-4 / atol 1e-5 (tests/test_kernels.py:17); rtol 1e-4 /
atol 1e-4 where a sum runs over a whole chunk or sequence in another order
(the SSM recurrences, stepped where the reference scans associatively, and
the MoE's scatter-adds). Routing (the dynamic-width FFN's split, MoE's
dropped tokens) is held equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LMConfig as JConfig
from repro.models.lm import attention as JA
from repro.models.lm import ffn as JF
from repro.models.lm import ssm as JS
from repro_torch.configs.base import LMConfig
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import ffn as F
from repro_torch.models.lm import ssm as S
from repro_torch.models.lm import transformer as T
from repro_torch.models.lm.params import ParamTree

TOL = dict(rtol=1e-4, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)

DENSE = dict(name="t", family="dense", n_layers=1, d_model=16, n_heads=4, n_kv_heads=2,
             head_dim=8, d_ff=32, vocab_size=64, attn_chunk=5, qkv_bias=True)
MLA = dict(DENSE, family="moe", n_kv_heads=4, use_mla=True, q_lora_rank=12, kv_lora_rank=10,
           qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=6, qkv_bias=False)
MOE = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
           vocab_size=64, n_experts=4, n_experts_per_tok=2, moe_d_ff=32, capacity_factor=2.0)
SSM = dict(name="t", family="ssm", n_layers=1, d_model=16, n_heads=0, n_kv_heads=0, d_ff=0,
           vocab_size=64, ssm_state=4, ssm_chunk=5)
HYB = dict(SSM, family="hybrid", ssm_head_dim=8)


def J(f, *static, names=()):
    """The reference function compiled once (eager JAX compiles op by op,
    many times slower at these sizes)."""
    return jax.jit(f, static_argnums=static, static_argnames=names)


def cfgs(**kw):
    return JConfig(**kw), LMConfig(**kw)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors beside other test processes: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def tt(tree):
    """numpy/JAX leaves -> torch tensors (nested dicts)."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(got, want, tol=TOL, where=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=where, **tol)


def close_tree(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], tol, k)


def with_biases(p, seed=7):
    """Non-zero qkv biases (the reference inits them to zero)."""
    out = dict(p)
    for i, k in enumerate(("bq", "bk", "bv")):
        out[k] = jnp.asarray(rnd(*p[k].shape, seed=seed + i, scale=0.3))
    return out


# ---------------------------------------------------------------------------
# norms, RoPE, attention
# ---------------------------------------------------------------------------

def test_rmsnorm():
    x, w = rnd(3, 5, 16), rnd(16, seed=1)
    close(A.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5), JA.rmsnorm(x, w, 1e-5))


def test_rmsnorm_keeps_the_cast_order_in_bf16():
    """(x * rsqrt(var + eps)) is cast to x's dtype before the weight."""
    x = torch.from_numpy(rnd(4, 64, seed=2)).bfloat16()
    w = torch.from_numpy(rnd(64, seed=3)).bfloat16()
    got = A.rmsnorm(x, w)
    var = x.float().square().mean(-1, keepdim=True)
    assert torch.equal(got, (x.float() * torch.rsqrt(var + 1e-5)).bfloat16() * w)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("offset", [0, 9])
def test_rope(offset):
    pos = np.arange(offset, offset + 7)
    jc, js = JA.rope_freqs(8, 1e4, jnp.asarray(pos))
    c, s = A.rope_freqs(8, 1e4, torch.from_numpy(pos))
    close(c, jc)
    close(s, js)
    x = rnd(2, 7, 3, 8)
    close(A.apply_rope(torch.from_numpy(x), c, s), JA.apply_rope(x, jc, js))


@pytest.mark.parametrize("sq,sk,chunk,h,g,dv,offset,causal", [
    (16, 16, 4, 8, 2, 8, 0, True),       # GQA rep 4
    (13, 13, 5, 4, 4, 8, 0, True),       # a sequence not a multiple of the chunk
    (13, 13, 5, 4, 2, 6, 0, True),       # MLA-style d_v != d
    (4, 13, 5, 4, 2, 8, 9, True),        # queries at an offset (the tail of a prefill)
    (8, 12, 5, 4, 2, 8, 0, False),       # bidirectional over a padded chunk
])
def test_blockwise_attention(sq, sk, chunk, h, g, dv, offset, causal):
    q, k, v = rnd(2, sq, h, 8), rnd(2, sk, g, 8, seed=1), rnd(2, sk, g, dv, seed=2)
    want = J(JA.blockwise_attention, names=("causal", "chunk", "q_offset"))(
        q, k, v, causal=causal, chunk=chunk, q_offset=offset)
    got = A.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, chunk=chunk,
                                q_offset=offset)
    close(got, want)


def test_decode_attention():
    q, k, v = rnd(2, 1, 8, 8), rnd(2, 10, 2, 8, seed=1), rnd(2, 10, 2, 8, seed=2)
    for length in (1, 5, 10):
        close(A.decode_attention(*map(torch.from_numpy, (q, k, v)), length),
              JA.decode_attention(q, k, v, jnp.asarray(length)))


def test_gqa_self_attention_and_decode():
    jc, cfg = cfgs(**DENSE)
    p = with_biases(J(JA.init_gqa, 1, 2)(KEY, jc, jnp.float32))
    x = rnd(2, 11, 16)
    close(A.gqa_self_attention(tt(p), torch.from_numpy(x), cfg),
          J(JA.gqa_self_attention, 2)(p, x, jc))
    close(A.gqa_self_attention(tt(p), torch.from_numpy(x), cfg, causal=False, q_offset=3),
          J(JA.gqa_self_attention, 2, names=("causal", "q_offset"))(
              p, x, jc, causal=False, q_offset=3))
    cache = {"k": rnd(2, 14, 2, 8, seed=3), "v": rnd(2, 14, 2, 8, seed=4)}
    xd = rnd(2, 1, 16, seed=5)
    want, wcache = J(JA.gqa_decode, 2)(p, xd, jc, cache, jnp.asarray(6))
    got, gcache = A.gqa_decode(tt(p), torch.from_numpy(xd), cfg, tt(cache), 6)
    close(got, want)
    close_tree(gcache, wcache)


def test_mla_self_attention_and_decode():
    jc, cfg = cfgs(**MLA)
    p = J(JA.init_mla, 1, 2)(KEY, jc, jnp.float32)
    x = rnd(2, 11, 16)
    close(A.mla_self_attention(tt(p), torch.from_numpy(x), cfg),
          J(JA.mla_self_attention, 2)(p, x, jc))
    cache = {"ckv": rnd(2, 14, 10, seed=3), "kr": rnd(2, 14, 4, seed=4)}
    xd = rnd(2, 1, 16, seed=5)
    want, wcache = J(JA.mla_decode, 2)(p, xd, jc, cache, jnp.asarray(6))
    got, gcache = A.mla_decode(tt(p), torch.from_numpy(xd), cfg, tt(cache), 6)
    close(got, want)
    close_tree(gcache, wcache)


# ---------------------------------------------------------------------------
# FFN, MoE, dynamic width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp(act):
    p = J(JF.init_mlp, 1, 2, 3, 4)(KEY, 16, 32, act, jnp.float32)
    x = rnd(2, 7, 16)
    close(F.mlp(tt(p), torch.from_numpy(x), act), J(JF.mlp, 2)(p, x, act))


@pytest.mark.parametrize("shared,cf", [(0, 2.0), (1, 2.0), (0, 0.1), (1, 1.25)])
def test_moe_forward(shared, cf):
    jc, cfg = cfgs(**dict(MOE, n_shared_experts=shared, capacity_factor=cf))
    p = J(JF.init_moe, 1, 2)(KEY, jc, jnp.float32)
    x = rnd(2, 16, 16)
    want, waux = J(JF.moe_forward, 2)(p, x, jc)
    got, gaux = F.moe_forward(tt(p), torch.from_numpy(x), cfg)
    assert F.moe_capacity(32, cfg) == JF.moe_capacity(32, jc)
    close(got, want, SUM_TOL)
    close(gaux, waux)
    if cf < 1 and not shared:        # the dropped tokens are the reference's
        zero = lambda y: np.flatnonzero(np.abs(np.asarray(y)).sum(-1).reshape(-1) == 0)  # noqa
        assert zero(want).size > 0
        np.testing.assert_array_equal(zero(got.numpy()), zero(want))


def test_moe_capacity_pads_to_eight():
    _, cfg = cfgs(**MOE)
    for n in (1, 7, 40, 4096):
        want = JF.moe_capacity(n, JConfig(**MOE))
        assert F.moe_capacity(n, cfg) == want and want % 8 == 0


def test_token_edge_score():
    x = rnd(5, 16)
    close(F.token_edge_score(torch.from_numpy(x)), JF.token_edge_score(x))


@pytest.mark.parametrize("act,frac", [("silu", 0.5), ("relu2", 0.5), ("silu", 0.25),
                                      ("silu", 1.0)])
def test_dynamic_width_ffn(act, frac, monkeypatch):
    p = J(JF.init_mlp, 1, 2, 3, 4)(KEY, 16, 32, act, jnp.float32)
    x = rnd(2, 9, 16)
    want = J(JF.dynamic_width_ffn, 2, names="capacity_frac")(p, x, act, capacity_frac=frac)
    splits, split = [], F.dynamic_width_split

    def recorded(*args):
        splits.append(split(*args))
        return splits[-1]

    monkeypatch.setattr(F, "dynamic_width_split", recorded)
    got = F.dynamic_width_ffn(tt(p), torch.from_numpy(x), act, capacity_frac=frac)
    close(got, want)
    # routing ids: the reference's own ranking (ffn.py:168-171)
    t = 18
    n_full = max(1, int(t * frac))
    _, order = jax.lax.top_k(JF.token_edge_score(x.reshape(t, 16)), t)
    ((full, half, _),) = splits
    assert full.numel() == n_full
    np.testing.assert_array_equal(full.numpy(), np.asarray(order[:n_full]))
    np.testing.assert_array_equal(half.numpy(), np.asarray(order[n_full:]))


def test_dynamic_width_ties_rank_the_earlier_token_first():
    x = torch.from_numpy(np.repeat(rnd(6, 16)[:1], 6, axis=0))     # six equal scores
    full, half, _ = F.dynamic_width_split(x, 0.5)
    assert full.tolist() == [0, 1, 2] and half.tolist() == [3, 4, 5]


# ---------------------------------------------------------------------------
# SSMs
# ---------------------------------------------------------------------------

def test_causal_conv():
    x, w, b = rnd(2, 7, 6), rnd(4, 6, seed=1), rnd(6, seed=2)
    wy, ws = JS._causal_conv(x, w, b)
    gy, gs = S._causal_conv(*map(torch.from_numpy, (x, w, b)))
    close(gy, wy)
    close(gs, ws)
    st = rnd(2, 3, 6, seed=3)
    wy, ws = JS._causal_conv(x[:, :1], w, b, st)
    gy, gs = S._causal_conv(*map(torch.from_numpy, (x[:, :1], w, b)), torch.from_numpy(st))
    close(gy, wy)
    close(gs, ws)


@pytest.mark.parametrize("s", [10, 13])
def test_mamba1_forward_state_and_decode(s):
    jc, cfg = cfgs(**SSM)
    p = J(JS.init_mamba1, 1, 2)(KEY, jc, jnp.float32)
    u = rnd(2, s, 16, scale=0.5)
    want, wst = J(JS.mamba1_forward, 2, 3)(p, u, jc, True)
    got, gst = S.mamba1_forward(tt(p), torch.from_numpy(u), cfg, return_state=True)
    close(got, want, SUM_TOL)
    close_tree(gst, wst, SUM_TOL)
    close(S.mamba1_forward(tt(p), torch.from_numpy(u), cfg), want, SUM_TOL)
    ud = rnd(2, 1, 16, seed=4)
    want, wc = J(JS.mamba1_decode, 2)(p, ud, jc, wst)
    got, gc = S.mamba1_decode(tt(p), torch.from_numpy(ud), cfg, tt(wst))
    close(got, want, SUM_TOL)
    close_tree(gc, wc, SUM_TOL)


@pytest.mark.parametrize("s", [10, 13])
def test_mamba2_forward_state_and_decode(s):
    jc, cfg = cfgs(**HYB)
    p = J(JS.init_mamba2, 1, 2)(KEY, jc, jnp.float32)
    u = rnd(2, s, 16, scale=0.5)
    want, wst = J(JS.mamba2_forward, 2, 3)(p, u, jc, True)
    got, gst = S.mamba2_forward(tt(p), torch.from_numpy(u), cfg, return_state=True)
    close(got, want, SUM_TOL)
    close_tree(gst, wst, SUM_TOL)
    ud = rnd(2, 1, 16, seed=4)
    want, wc = J(JS.mamba2_decode, 2)(p, ud, jc, wst)
    got, gc = S.mamba2_decode(tt(p), torch.from_numpy(ud), cfg, tt(wst))
    close(got, want, SUM_TOL)
    close_tree(gc, wc, SUM_TOL)


def test_ssm_init_caches_match_reference():
    jc, cfg = cfgs(**HYB)
    for jf, f in ((JS.mamba1_init_cache, S.mamba1_init_cache),
                  (JS.mamba2_init_cache, S.mamba2_init_cache)):
        want, got = jf(jc, 3), f(cfg, 3)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == \
            {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()}


# ---------------------------------------------------------------------------
# entry points and the container
# ---------------------------------------------------------------------------

def test_entry_points_need_the_card_or_device_cpu(monkeypatch):
    """No silent fall back to the CPU: without a card, init_lm, init_encdec
    and init_caches raise unless ``device="cpu"``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import encdec as E
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-8b", smoke=True)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_lm(cfg, generator=g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.init_encdec(get_config("seamless-m4t-medium", smoke=True), generator=g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_caches(cfg, 1, 8)
    p = T.init_lm(cfg, generator=g, device="cpu")
    assert all(t.device.type == "cpu" for t in p.parameters())


@pytest.mark.parametrize("knob", [dict(moe_impl="shard_map"), dict(moe_dispatch_token_shard=True),
                                  dict(mamba2_impl="ssd"), dict(mla_lazy_kv=True)])
def test_dry_run_knobs_refuse_rather_than_do_nothing(knob):
    """The reference's implementation knobs are fields, and the dry run's
    four are served (a config equals the reference's field by field, also
    through ``dataclasses.replace``). ``moe_impl="shard_map"`` selects the
    explicit MoE of ``distributed/moe.py`` under a sharding context; without
    one the MoE is the einsum form, the reference's semantics (ffn.py:92-96)."""
    want = dataclasses.asdict(JConfig(**MOE, **knob))
    assert dataclasses.asdict(LMConfig(**MOE, **knob)) == want
    assert dataclasses.asdict(dataclasses.replace(LMConfig(**MOE), **knob)) == want
    if knob.get("moe_impl") == "shard_map":
        cfg = LMConfig(**MOE, **knob)
        p = F.init_moe(cfg, generator=torch.Generator().manual_seed(0),
                       device=torch.device("cpu"), dtype=torch.float32)
        x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
        got, want_out = F.moe_forward(p, x, cfg), F.moe_forward(p, x, LMConfig(**MOE))
        assert all(torch.equal(a, b) for a, b in zip(got, want_out))


def test_param_tree_indexes_like_a_dict():
    tree = ParamTree({"w": torch.ones(2), "sub": {"b": torch.zeros(3)},
                      "layers": [{"x": torch.ones(1)}, {"x": torch.zeros(1)}]})
    assert "w" in tree and "bq" not in tree and tree.get("bq", 0) == 0
    assert tree["sub"]["b"].shape == (3,) and len(tree["layers"]) == 2
    assert tree.keys() == ("w", "sub", "layers")
    assert not any(p.requires_grad for p in tree.parameters())
    with pytest.raises(KeyError):
        tree["missing"]
    back = tree.tree()
    assert torch.equal(back["layers"][1]["x"], torch.zeros(1))
