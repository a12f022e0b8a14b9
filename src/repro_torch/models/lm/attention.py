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
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
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


def _chunk_mask(q_pos, ci: int, chunk: int, sk: int, causal: bool) -> torch.Tensor:
    kv_pos = ci * chunk + torch.arange(chunk, device=q_pos.device)
    valid = kv_pos[None, :] < sk                           # padding mask
    return (kv_pos[None, :] <= q_pos[:, None]) & valid if causal else valid


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, chunk: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,G,D) with H = n*G (GQA). Lazy softmax:
    O(Sq*chunk) live memory instead of O(Sq*Sk)."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dv = v.shape[-1]                                   # MLA: d_v != d_qk
    rep = h // g
    scale = d ** -0.5
    nc = -(-sk // chunk)
    pad = nc * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # rows (q, r) of each KV group: (B, G, Sq*rep, D)
    qg = q.reshape(b, sq, g, rep, d).permute(0, 2, 1, 3, 4).reshape(b, g, sq * rep, d).float()
    kg = k.permute(0, 2, 3, 1)                         # (B, G, D, Sk)
    vg = v.permute(0, 2, 1, 3)                         # (B, G, Sk, dv)
    q_pos = _positions(q_offset, sq, q.device).repeat_interleave(rep)
    m = torch.full((b, g, sq * rep), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, g, sq * rep), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, g, sq * rep, dv), dtype=torch.float32, device=q.device)
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = (qg @ kg[..., sl].float()) * scale
        s = torch.where(_chunk_mask(q_pos, ci, chunk, sk, causal), s, NEG_INF)
        m, l, o = _online_softmax_step(m, l, o, s, vg[:, :, sl])
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = out.reshape(b, g, sq, rep, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length) -> torch.Tensor:
    """One-token attention over a cache.

    q: (B,1,H,D); caches: (B,S,G,D); length: current cache fill."""
    b, _, h, d = q.shape
    s, g = k_cache.shape[1], k_cache.shape[2]
    rep = h // g
    qh = q.reshape(b, g, rep, d).float()
    scores = (qh @ k_cache.float().permute(0, 2, 3, 1)) * d ** -0.5     # (B,G,rep,S)
    mask = torch.arange(s, device=q.device) < length
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = p @ v_cache.float().permute(0, 2, 1, 3)
    return out.reshape(b, 1, h, d).to(q.dtype)


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


def gqa_qkv(p, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    hd, h, g = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"] + p.get("bq", 0)).reshape(b, s, h, hd)
    k = (x @ p["wk"] + p.get("bk", 0)).reshape(b, s, g, hd)
    v = (x @ p["wv"] + p.get("bv", 0)).reshape(b, s, g, hd)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_self_attention(p, x: torch.Tensor, cfg: LMConfig, *, causal: bool = True,
                       q_offset: int = 0, return_kv: bool = False):
    """-> out, or (out, (k, v)) with ``return_kv``: the layer's roped K and
    V, which prefill caches (the reference recomputes them for the cache)."""
    s = x.shape[1]
    q, k, v = gqa_qkv(p, x, cfg, _positions(q_offset, s, x.device))
    o = blockwise_attention(q, k, v, causal=causal, chunk=min(cfg.attn_chunk, s),
                            q_offset=q_offset)
    out = o.reshape(x.shape[0], s, -1) @ p["wo"]
    return (out, (k, v)) if return_kv else out


def gqa_decode(p, x: torch.Tensor, cfg: LMConfig, cache: Dict[str, torch.Tensor],
               pos) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,1,D); cache: {'k','v'}: (B,S,G,hd), written at ``pos`` in place;
    pos: the fill count (an int; a tensor is read to the host)."""
    b = x.shape[0]
    pos = int(pos)
    q, k, v = gqa_qkv(p, x, cfg, _positions(pos, 1, x.device))
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
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
    q = q.reshape(b, s, h, dn + dr)
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
    b, sq, h, dn = q_nope.shape
    sk = k_nope.shape[1]
    dr = q_rope.shape[-1]
    scale = (dn + dr) ** -0.5
    nc = -(-sk // chunk)
    pad = nc * chunk - sk
    if pad:
        k_nope = F.pad(k_nope, (0, 0, 0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kvdt = k_nope.dtype
    qn = q_nope.to(kvdt).permute(0, 2, 1, 3).float()
    qr = q_rope.to(kvdt).permute(0, 2, 1, 3).float()
    kg = k_nope.permute(0, 2, 3, 1)                            # (B,H,dn,Sk)
    krg = k_rope.to(kvdt).permute(0, 2, 1)[:, None]            # (B,1,dr,Sk)
    vg = v.permute(0, 2, 1, 3)                                 # (B,H,Sk,dv)
    q_pos = _positions(q_offset, sq, q_nope.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=qn.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=qn.device)
    o = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32, device=qn.device)
    for ci in range(nc):
        blk = slice(ci * chunk, (ci + 1) * chunk)
        s = (qn @ kg[..., blk].float()) + (qr @ krg[..., blk].float())
        s = s * scale
        s = torch.where(_chunk_mask(q_pos, ci, chunk, sk, True), s, NEG_INF)
        m, l, o = _online_softmax_step(m, l, o, s, vg[:, :, blk])
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)


def mla_self_attention(p, x: torch.Tensor, cfg: LMConfig, *, q_offset: int = 0,
                       return_kv: bool = False):
    """Prefill/train path: per-head K/V reconstructed from the latent once,
    the rope key shared by the heads. ``return_kv`` also returns (c_kv,
    k_rope) for the cache."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope, k_rope = _mla_qkr(p, x, cfg, _positions(q_offset, s, x.device))
    c_kv = rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    kv = (c_kv @ p["wukv"]).reshape(b, s, h, dn + dv)
    o = mla_blockwise_attention(q_nope, q_rope, kv[..., :dn], k_rope[:, :, 0], kv[..., dn:],
                                chunk=min(cfg.attn_chunk, s), q_offset=q_offset)
    out = o.reshape(b, s, h * dv) @ p["wo"]
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
    ckv_cache[:, pos] = c_kv[:, 0].to(ckv_cache.dtype)
    kr_cache[:, pos] = k_rope[:, 0, 0].to(kr_cache.dtype)

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
