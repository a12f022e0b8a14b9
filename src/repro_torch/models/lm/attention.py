"""Attention substrate: RoPE, GQA, MLA (deepseek), blockwise-flash attention.

The port of ``repro.models.lm.attention``. All attention math is *chunked*
(lazy softmax over KV blocks): the S x S score matrix is never materialised.
Scores and accumulators are float32 whatever the model dtype (the reference's
``preferred_element_type``): each product of two bf16 values is exact in
float32, so the port casts the operands up and multiplies in float32; P is
cast to V's dtype before P.V, as the reference does. ``NEG_INF`` is finite,
so a fully masked chunk gives what the reference's gives.

Decode writes the new token's K/V (or MLA latent) into the cache in place
and returns the same tensors: the caches are layer-stacked buffers that a
decode step fills one position at a time.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.distributed import ctx as shard
from repro_torch.distributed.ctx import is_dtensor, is_sharded, merge_dims, split_dim
from repro_torch.models.lm.params import normal

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) -> cos/sin of shape (..., head_dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D//2) or broadcastable (..., S, 1, D//2)."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.ndim == 2:                      # (S, D/2) -> (1, S, 1, D/2)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _positions(q_offset: int, s: int, device) -> torch.Tensor:
    return torch.arange(q_offset, q_offset + s, device=device)


# ---------------------------------------------------------------------------
# blockwise (flash-style) causal attention, a loop over KV chunks
# ---------------------------------------------------------------------------

def _online_softmax_step(m, l, o, s, vb):
    """One KV chunk of the lazy softmax: s (..., q, C) float32 scores, vb
    (..., C, dv) values in the model dtype; m, l (..., q), o (..., q, dv)."""
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + p.to(vb.dtype).float() @ vb.float()
    return m_new, l_new, o_new


def _softmax_state(rows: torch.Tensor, dv: int):
    """The lazy softmax's start: m at NEG_INF, l zero (..., q) and o zero
    (..., q, dv), for query rows (..., q, D), laid out like them (a
    DTensor's shards: a plain ``torch.zeros`` would be a whole replicated
    copy on every rank)."""
    m = torch.full_like(rows[..., 0], NEG_INF, dtype=torch.float32)
    o = torch.zeros_like(rows[..., :1], dtype=torch.float32)
    return m, torch.zeros_like(m), o.expand(*m.shape, dv)


def _chunk_mask(q_pos, ci: int, chunk: int, sk: int, causal: bool) -> torch.Tensor:
    kv_pos = ci * chunk + torch.arange(chunk, device=q_pos.device)
    valid = kv_pos[None, :] < sk                           # padding mask
    return (kv_pos[None, :] <= q_pos[:, None]) & valid if causal else valid


class _RepeatKV(torch.autograd.Function):
    """(B,S,G,D) -> (B,S,H,D), each group's K (or V) repeated to its heads.
    The gradient sums each group's heads as a product with the (H, G) 0/1
    map, which DTensor computes on each rank's heads and reduces over their
    axis (the gradient of an expand would split a sharded dim it cannot)."""

    @staticmethod
    def forward(ctx, k, h: int):
        b, s, g, d = k.shape
        ctx.g = g
        return k[:, :, :, None, :].expand(b, s, g, h // g, d).reshape(b, s, h, d)

    @staticmethod
    def backward(ctx, grad):
        h, g = grad.shape[2], ctx.g
        hit = (torch.arange(h, device=grad.device)[:, None] // (h // g)
               == torch.arange(g, device=grad.device)[None, :]).to(grad.dtype)
        return (grad.transpose(2, 3).contiguous() @ hit).transpose(2, 3).contiguous(), None


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    return _RepeatKV.apply(k, h)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, chunk: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,G,D) with H = n*G (GQA). Lazy softmax:
    O(Sq*chunk) live memory instead of O(Sq*Sk)."""
    # under a mesh (the dry run): batch over dp, heads over mp, the sequence
    # whole; K/V repeated to the query heads where only those shard; then
    # each rank's own blocks
    h = q.shape[2]
    if is_dtensor(q) and seq_parallel(h, q.shape[1]):
        return _blockwise_attention_seq(q, k, v, causal=causal, chunk=chunk, q_offset=q_offset)
    q, k, v = _heads_over_mp(q, k, v)
    if is_sharded(q, 2) and not is_sharded(k, 2) and k.shape[2] < h:
        k, v = _heads_over_mp(_repeat_kv(k, h), _repeat_kv(v, h))
    return shard.on_shards(lambda q, k, v: _blockwise_attention(
        q, k, v, causal=causal, chunk=chunk, q_offset=q_offset), q, k, v)


def seq_parallel(n_heads: int, seq: int) -> bool:
    """Under a sharding context, do the attention's query heads not divide
    the model axis while the sequence does? Then the attention splits its
    query rows over the model axis (`_blockwise_attention_seq`) where the
    heads cannot split, as the reference's partitioner keeps such an
    attention sharded (qwen2's 14 heads on 4 ranks: a quarter of the
    unsplit FLOPs a rank, tests/test_torch_dryrun_faults.py)."""
    c = shard.current()
    if c is None:
        return False
    n = c.axis_size("mp")
    return n > 1 and n_heads % n != 0 and seq % n == 0


def _blockwise_attention_seq(q, k, v, *, causal, chunk, q_offset):
    """`blockwise_attention` with the query rows split over the model axis
    and K/V whole: each rank attends its own rows, their causal mask at
    their global positions."""
    c = shard.current()
    mesh, n = c.mesh, c.axis_size("mp")
    rows = q.shape[1] // n
    q = shard.constrain(q, "dp", "mp", None, None)
    k, v = (shard.constrain(t, "dp", None, None, None) for t in (k, v))
    off = q_offset + mesh.get_local_rank(c.mp) * rows
    return shard.on_shards(lambda q, k, v: _blockwise_attention(
        q, k, v, causal=causal, chunk=chunk, q_offset=off), q, k, v)


def _blockwise_attention(q, k, v, *, causal, chunk, q_offset):
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dv = v.shape[-1]                                   # MLA: d_v != d_qk
    rep = h // g
    scale = d ** -0.5
    nc = -(-sk // chunk)
    pad = nc * chunk - sk
    if pad:
        k = shard.pad(k, (0, 0, 0, 0, 0, pad))
        v = shard.pad(v, (0, 0, 0, 0, 0, pad))
    # rows (q, r) of each KV group: (B, G, Sq*rep, D)
    qg = q.reshape(b, sq, g, rep, d).permute(0, 2, 1, 3, 4).reshape(b, g, sq * rep, d).float()
    kg = k.permute(0, 2, 3, 1)                         # (B, G, D, Sk)
    vg = v.permute(0, 2, 1, 3)                         # (B, G, Sk, dv)
    q_pos = _positions(q_offset, sq, q.device).repeat_interleave(rep)
    m, l, o = _softmax_state(qg, dv)
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = (qg @ kg[..., sl].float()) * scale
        s = torch.where(_chunk_mask(q_pos, ci, chunk, sk, causal), s, NEG_INF)
        m, l, o = _online_softmax_step(m, l, o, s, vg[:, :, sl])
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = out.reshape(b, g, sq, rep, dv).permute(0, 2, 1, 3, 4)
    return merge_dims(out, 2).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length) -> torch.Tensor:
    """One-token attention over a cache.

    q: (B,1,H,D); caches: (B,S,G,D); length: current cache fill. On DTensor
    caches, each rank attends with its own shard (`_decode_attention_sharded`)."""
    if is_dtensor(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, length)
    b, _, h, d = q.shape
    s, g = k_cache.shape[1], k_cache.shape[2]
    rep = h // g
    qh = split_dim(q[:, 0], 1, (g, rep)).float()
    scores = (qh @ k_cache.float().permute(0, 2, 3, 1)) * d ** -0.5     # (B,G,rep,S)
    mask = torch.arange(s, device=q.device) < length
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = p @ v_cache.float().permute(0, 2, 1, 3)
    return merge_dims(out, 1)[:, None].to(q.dtype)


def _decode_attention_sharded(q, k_cache, v_cache, length) -> torch.Tensor:
    """`decode_attention` on each rank's shard of the caches, laid out by
    ``cache_specs`` (batch over dp, kv heads or the sequence over mp): q is
    laid out like them (its heads as their kv heads). Where the sequence is
    sharded, each rank's partial softmax is merged by the flash-decoding
    combine over the sequence's axes (``distributed/collectives.py``, the
    explicit form of what the reference's partitioner does for a
    sequence-sharded cache); otherwise the plain form runs on the shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import collectives as C
    mesh = k_cache.device_mesh
    pl = tuple(k_cache.placements)
    if tuple(v_cache.placements) != pl:
        v_cache = v_cache.redistribute(mesh, pl)
    qpl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in pl)
    if not is_dtensor(q):
        q = DTensor.from_local(q, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    if tuple(q.placements) != qpl:
        q = q.redistribute(mesh, qpl)
    seq_axes = [mesh.mesh_dim_names[i] for i, p in enumerate(pl)
                if isinstance(p, Shard) and p.dim == 1]
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    if seq_axes:
        out = C.flash_decode_local(mesh, seq_axes, ql, kl, vl, length)
    else:
        out = decode_attention(ql, kl, vl, length)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def init_gqa(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, g = cfg.n_heads, cfg.n_kv_heads
    std = d ** -0.5
    p = {
        "wq": normal(generator, (d, h * hd), std, dtype, device),
        "wk": normal(generator, (d, g * hd), std, dtype, device),
        "wv": normal(generator, (d, g * hd), std, dtype, device),
        "wo": normal(generator, (h * hd, d), std, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((g * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((g * hd,), dtype=dtype, device=device)
    return p


def _rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; with x's sequence split (`seq_parallel`) on each rank's
    rows against the whole weight: DTensor would flatten the batch with the
    split sequence, which some of its versions refuse."""
    if is_sharded(x, 1):
        return shard.on_shards(lambda a, b: a @ b, x, shard.replicate(w))
    return x @ w


def gqa_qkv(p, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    hd, h, g = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = split_dim(_rows_matmul(x, p["wq"]) + p.get("bq", 0), -1, (h, hd))
    k = split_dim(_rows_matmul(x, p["wk"]) + p.get("bk", 0), -1, (g, hd))
    v = split_dim(_rows_matmul(x, p["wv"]) + p.get("bv", 0), -1, (g, hd))
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _heads_over_mp(*ts):
    """(B,S,H,D) activations with the batch over dp and the heads over mp
    (where they divide), the sequence whole: a no-op without a mesh. DTensor
    places each op on its own, where XLA propagates over the program, so
    the dry run states the Megatron layout of the attention here."""
    return tuple(shard.constrain(t, "dp", None, "mp", None) for t in ts)


def gqa_self_attention(p, x: torch.Tensor, cfg: LMConfig, *, causal: bool = True,
                       q_offset: int = 0, return_kv: bool = False):
    """-> out, or (out, (k, v)) with ``return_kv``: the layer's roped K and
    V, which prefill caches (the reference recomputes them for the cache)."""
    s = x.shape[1]
    q, k, v = gqa_qkv(p, x, cfg, _positions(q_offset, s, x.device))
    o = blockwise_attention(q, k, v, causal=causal, chunk=min(cfg.attn_chunk, s),
                            q_offset=q_offset)
    out = _rows_matmul(merge_dims(shard.grad_like(o), 2), p["wo"])
    return (out, (k, v)) if return_kv else out


def write_at(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos] = new`` in place (cache (B, S, ...), new (B, ...)).
    On a DTensor (the dry run) it is a select over the sequence, which each
    rank does on its own shard with no collective: a slice write would
    gather a sequence-sharded cache."""
    new = new.to(cache.dtype)
    if not is_dtensor(cache):
        cache[:, pos] = new
        return
    at = (torch.arange(cache.shape[1], device=cache.device) == pos)
    at = at.reshape((1, -1) + (1,) * (cache.ndim - 2))
    cache.copy_(torch.where(at, new[:, None], cache))


def gqa_decode(p, x: torch.Tensor, cfg: LMConfig, cache: Dict[str, torch.Tensor],
               pos) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,1,D); cache: {'k','v'}: (B,S,G,hd), written at ``pos`` in place;
    pos: the fill count (an int; a tensor is read to the host)."""
    b = x.shape[0]
    pos = int(pos)
    q, k, v = gqa_qkv(p, x, cfg, _positions(pos, 1, x.device))
    write_at(cache["k"], pos, k[:, 0])
    write_at(cache["v"], pos, v[:, 0])
    o = decode_attention(q, cache["k"], cache["v"], pos + 1)
    return o.reshape(b, 1, -1) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): low-rank q/kv + decoupled RoPE; absorbed decode
# ---------------------------------------------------------------------------

def init_mla(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    std = d ** -0.5

    def n(shape, s=std):
        return normal(generator, shape, s, dtype, device)

    return {
        "wdq": n((d, qr)),                                  # q down
        "q_norm": torch.ones((qr,), dtype=dtype, device=device),
        "wuq": n((qr, h * (dn + dr)), qr ** -0.5),          # q up (nope+rope)
        "wdkv": n((d, kr)),                                 # kv down (the cached latent)
        "kv_norm": torch.ones((kr,), dtype=dtype, device=device),
        "wukv": n((kr, h * (dn + dv)), kr ** -0.5),         # kv up
        "wkr": n((d, dr)),                                  # shared rope key
        "wo": n((h * dv, d)),
    }


def _mla_qkr(p, x, cfg: LMConfig, positions):
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    q = split_dim(q, -1, (h, dn + dr))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_freqs(dr, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope((x @ p["wkr"]).reshape(b, s, 1, dr), cos, sin)
    return q_nope, q_rope, k_rope


def mla_blockwise_attention(q_nope, q_rope, k_nope, k_rope, v, *,
                            chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Blockwise attention with MLA's decoupled score:
        s = q_nope.k_nope (per head) + q_rope.k_rope (shared by the heads).
    The rope term contracts the shared (B,S,dr) key directly."""
    # under a mesh: each rank's batch and heads (see blockwise_attention)
    q_nope, q_rope, k_nope, v = _heads_over_mp(q_nope, q_rope, k_nope, v)
    k_rope = shard.constrain(k_rope, "dp", None, None)
    return shard.on_shards(lambda *a: _mla_blockwise_attention(
        *a, chunk=chunk, q_offset=q_offset), q_nope, q_rope, k_nope, k_rope, v)


def _mla_blockwise_attention(q_nope, q_rope, k_nope, k_rope, v, *, chunk, q_offset):
    b, sq, h, dn = q_nope.shape
    sk = k_nope.shape[1]
    dr = q_rope.shape[-1]
    scale = (dn + dr) ** -0.5
    nc = -(-sk // chunk)
    pad = nc * chunk - sk
    if pad:
        k_nope = shard.pad(k_nope, (0, 0, 0, 0, 0, pad))
        k_rope = shard.pad(k_rope, (0, 0, 0, pad))
        v = shard.pad(v, (0, 0, 0, 0, 0, pad))
    kvdt = k_nope.dtype
    qn = q_nope.to(kvdt).permute(0, 2, 1, 3).float()
    qr = q_rope.to(kvdt).permute(0, 2, 1, 3).float()
    kg = k_nope.permute(0, 2, 3, 1)                            # (B,H,dn,Sk)
    krg = k_rope.to(kvdt).permute(0, 2, 1)[:, None]            # (B,1,dr,Sk)
    vg = v.permute(0, 2, 1, 3)                                 # (B,H,Sk,dv)
    q_pos = _positions(q_offset, sq, q_nope.device)
    m, l, o = _softmax_state(qn, v.shape[-1])
    for ci in range(nc):
        blk = slice(ci * chunk, (ci + 1) * chunk)
        s = (qn @ kg[..., blk].float()) + (qr @ krg[..., blk].float())
        s = s * scale
        s = torch.where(_chunk_mask(q_pos, ci, chunk, sk, True), s, NEG_INF)
        m, l, o = _online_softmax_step(m, l, o, s, vg[:, :, blk])
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)


def mla_blockwise_attention_lazy(q_nope, q_rope, c_kv, k_rope, wukv, cfg: LMConfig, *,
                                 chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """The reference's §Perf D4 (refuted there, kept for the record): K and V
    expanded from the latent chunk by chunk inside the loop, never whole.
    c_kv: (B,Sk,kv_lora_rank); k_rope: (B,Sk,dr); wukv: (kr, H*(dn+dv)).
    Selected by ``cfg.mla_lazy_kv`` (the dry run's ``mla_lazy``)."""
    # under a mesh: each rank's batch and heads
    q_nope, q_rope = _heads_over_mp(q_nope, q_rope)
    c_kv, k_rope = (shard.constrain(t, "dp", None, None) for t in (c_kv, k_rope))
    wukv = shard.constrain(wukv, None, "mp" if is_sharded(q_nope, 2) else None)
    return shard.on_shards(lambda *a: _mla_blockwise_attention_lazy(
        *a, cfg, chunk=chunk, q_offset=q_offset), q_nope, q_rope, c_kv, k_rope, wukv)


def _mla_blockwise_attention_lazy(q_nope, q_rope, c_kv, k_rope, wukv, cfg, *, chunk, q_offset):
    b, sq, h, dn = q_nope.shape
    sk = c_kv.shape[1]
    dr = q_rope.shape[-1]
    kr, dv = cfg.kv_lora_rank, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    nc = -(-sk // chunk)
    pad = nc * chunk - sk
    if pad:
        c_kv = shard.pad(c_kv, (0, 0, 0, pad))
        k_rope = shard.pad(k_rope, (0, 0, 0, pad))
    kvdt = c_kv.dtype
    qn = q_nope.to(kvdt).permute(0, 2, 1, 3).float()           # (B,H,Sq,dn)
    qr = q_rope.to(kvdt).permute(0, 2, 1, 3).float()
    krg = k_rope.to(kvdt).permute(0, 2, 1)[:, None]            # (B,1,dr,Sk)
    w = wukv.reshape(kr, h, dn + dv)
    w_uk, w_uv = w[..., :dn], w[..., dn:]
    q_pos = _positions(q_offset, sq, q_nope.device)
    m, l, o = _softmax_state(qn, dv)
    for ci in range(nc):
        blk = slice(ci * chunk, (ci + 1) * chunk)
        ckvb = c_kv[:, blk]
        kb = torch.einsum("bcr,rhd->bhdc", ckvb, w_uk)         # lazy K expansion
        vb = torch.einsum("bcr,rhd->bhcd", ckvb, w_uv)         # lazy V expansion
        s = (qn @ kb.float()) + (qr @ krg[..., blk].float())
        s = s * scale
        s = torch.where(_chunk_mask(q_pos, ci, chunk, sk, True), s, NEG_INF)
        m, l, o = _online_softmax_step(m, l, o, s, vb)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)


def mla_self_attention(p, x: torch.Tensor, cfg: LMConfig, *, q_offset: int = 0,
                       return_kv: bool = False):
    """Prefill/train path: per-head K/V reconstructed from the latent once,
    the rope key shared by the heads (``cfg.mla_lazy_kv``: expanded chunk
    by chunk instead). ``return_kv`` also returns (c_kv, k_rope) for the
    cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope, k_rope = _mla_qkr(p, x, cfg, _positions(q_offset, s, x.device))
    c_kv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    if cfg.mla_lazy_kv:
        o = mla_blockwise_attention_lazy(q_nope, q_rope, c_kv, k_rope[:, :, 0], p["wukv"], cfg,
                                         chunk=min(cfg.attn_chunk, s), q_offset=q_offset)
    else:
        kv = split_dim(c_kv @ p["wukv"], -1, (h, dn + dv))
        o = mla_blockwise_attention(q_nope, q_rope, kv[..., :dn], k_rope[:, :, 0], kv[..., dn:],
                                    chunk=min(cfg.attn_chunk, s), q_offset=q_offset)
    out = merge_dims(shard.grad_like(o), 2) @ p["wo"]
    return (out, (c_kv, k_rope[:, :, 0])) if return_kv else out


def mla_decode(p, x: torch.Tensor, cfg: LMConfig, cache: Dict[str, torch.Tensor],
               pos) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed decode: scores and outputs in the latent space; the cache
    stays (B, S, kv_lora_rank) + (B, S, rope_dim), never expanded to heads."""
    b = x.shape[0]
    pos = int(pos)
    h = cfg.n_heads
    dn, dr, dv, kr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope, k_rope = _mla_qkr(p, x, cfg, _positions(pos, 1, x.device))
    c_kv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)           # (B,1,kr)
    ckv_cache, kr_cache = cache["ckv"], cache["kr"]
    write_at(ckv_cache, pos, c_kv[:, 0])
    write_at(kr_cache, pos, k_rope[:, 0, 0])

    wukv = p["wukv"].reshape(kr, h, dn + dv)
    w_uk, w_uv = wukv[..., :dn], wukv[..., dn:]                         # (kr,h,dn),(kr,h,dv)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)            # absorb W_uk
    s_lat = q_lat.float() @ ckv_cache.float().transpose(1, 2)           # (B,h,S)
    s_rope = q_rope[:, 0].float() @ kr_cache.float().transpose(1, 2)
    scores = (s_lat + s_rope) * (dn + dr) ** -0.5
    mask = torch.arange(scores.shape[-1], device=x.device) <= pos
    pattn = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    o_lat = pattn @ ckv_cache.float()                                   # (B,h,kr)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv.float())               # absorb W_uv
    out = o.reshape(b, 1, h * dv).to(x.dtype) @ p["wo"]
    return out, cache
