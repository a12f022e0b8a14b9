"""Unified LM stack for every architecture family.

The port of ``repro.models.lm.transformer``. The reference stacks per-layer
params on a leading L axis and scans one compiled layer body; the port keeps
the layers in a `ParamTree`'s ``nn.ModuleList`` and loops over them (the
shared block of a hybrid runs where ``(i + 1) % shared_attn_every == 0``).
Remat becomes ``torch.utils.checkpoint`` around each layer, taken only when
autograd records.

Families: dense GQA (granite/qwen2/minitron), MoE (grok-1/deepseek-v3 + MLA),
SSM (falcon-mamba), hybrid mamba2+shared-attn (zamba2), VLM backbone
(internvl2, stub vision frontend), and the enc-dec wrapper in encdec.py.

Caches keep the reference's keys and layer-stacked shapes (``k``/``v`` of
(L, B, max_len, G, hd), MLA's ``ckv``/``kr``, an SSM's ``h``/``conv``);
`lm_decode_step` writes into them in place and returns them. Logits cover
``vocab_padded`` columns. Cross-entropy is chunked over the sequence.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.distributed import ctx as shard
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import ffn as FF
from repro_torch.models.lm import ssm as S
from repro_torch.models.lm.params import ParamTree, _resolve_device, normal

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3


# ===========================================================================
# init
# ===========================================================================

def init_block(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    d = cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype)
    ones = lambda: torch.ones((d,), dtype=dtype, device=device)  # noqa: E731
    if cfg.family == "ssm":
        return {"ln1": ones(), "mamba": S.init_mamba1(cfg, **kw)}
    if cfg.family == "hybrid":
        return {"ln1": ones(), "mamba": S.init_mamba2(cfg, **kw)}
    p: Dict[str, Any] = {"ln1": ones(), "ln2": ones()}
    p["attn"] = A.init_mla(cfg, **kw) if cfg.use_mla else A.init_gqa(cfg, **kw)
    if cfg.n_experts:
        p["moe"] = FF.init_moe(cfg, **kw)
    else:
        p["mlp"] = FF.init_mlp(d, cfg.d_ff, cfg.act, **kw)
    return p


def init_shared_block(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16
                      ) -> Dict[str, Any]:
    """zamba2's weight-shared attention+MLP block (one set of weights, applied
    every ``shared_attn_every`` layers)."""
    d = cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"ln1": torch.ones((d,), dtype=dtype, device=device),
            "ln2": torch.ones((d,), dtype=dtype, device=device),
            "attn": A.init_gqa(cfg, **kw),
            "mlp": FF.init_mlp(d, cfg.d_ff, cfg.act, **kw)}


def init_lm(cfg: LMConfig, *, generator: Optional[torch.Generator], device="cuda",
            dtype=torch.bfloat16) -> ParamTree:
    """Random weights of the reference's shapes, dtypes and init scales,
    drawn from ``generator`` (on its own device; ``None`` on the meta
    device). Runs on the card unless ``device`` says otherwise."""
    dev = _resolve_device(device, "init_lm")
    kw = dict(generator=generator, device=dev, dtype=dtype)
    d, vp = cfg.d_model, cfg.vocab_padded
    params: Dict[str, Any] = {
        "embed": normal(generator, (vp, d), d ** -0.5, dtype, dev),
        "layers": [init_block(cfg, **kw) for _ in range(cfg.n_layers)],
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (d, vp), d ** -0.5, dtype, dev)
    if cfg.shared_attn_every:
        params["shared_block"] = init_shared_block(cfg, **kw)
    if cfg.mtp:
        params["mtp"] = {"proj": normal(generator, (2 * d, d), d ** -0.5, dtype, dev),
                         "block": init_block(cfg, **kw),
                         "ln": torch.ones((d,), dtype=dtype, device=dev)}
    if cfg.frontend == "vision":
        params["vision_proj"] = normal(generator, (d, d), d ** -0.5, dtype, dev)
    return ParamTree(params)


# ===========================================================================
# block forward (one layer)
# ===========================================================================

def _norm_in(x: torch.Tensor, w: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """The normed input of a mixer or FFN, its sequence gathered where the
    residual stream is sequence-sharded (Megatron-SP's gather before the
    column-parallel projections). XLA finds this layout by propagation; a
    DTensor op is placed on its own, so the dry run states it. A no-op
    without a mesh."""
    return shard.constrain(A.rmsnorm(x, w, cfg.norm_eps), "dp", None, None)


def _out(y: torch.Tensor) -> torch.Tensor:
    """A mixer's or FFN's output on its way into the residual stream: under
    a mesh its gradient comes back with the sequence gathered (the twin of
    `_norm_in` for the backward). A no-op without a mesh."""
    return shard.grad_to(y, "dp", None, None)


def block_forward(p, x: torch.Tensor, cfg: LMConfig, *, q_offset: int = 0,
                  return_kv: bool = False):
    """Full-sequence (train/prefill) layer -> (x, moe_aux); with
    ``return_kv`` (attention layers) also the layer's K/V (or MLA latents)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return x + _out(S.mamba1_forward(p["mamba"], _norm_in(x, p["ln1"], cfg), cfg)), aux
    if cfg.family == "hybrid":
        return x + S.mamba2_forward(p["mamba"], A.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg), aux
    if not cfg.use_mla and A.seq_parallel(cfg.n_heads, x.shape[1]):
        # heads that do not divide the model axis: the projections and the
        # attention keep the sequence split (A.seq_parallel)
        h = shard.constrain(A.rmsnorm(x, p["ln1"], cfg.norm_eps), "dp", "mp", None)
    else:
        h = _norm_in(x, p["ln1"], cfg)
    attn = A.mla_self_attention if cfg.use_mla else A.gqa_self_attention
    o = attn(p["attn"], h, cfg, q_offset=q_offset, return_kv=return_kv)
    o, kv = o if return_kv else (o, None)
    x = x + _out(o)
    h = _norm_in(x, p["ln2"], cfg)
    if cfg.n_experts:
        y, aux = FF.moe_forward(p["moe"], h, cfg)
    elif cfg.dynamic_width:
        y = FF.dynamic_width_ffn(p["mlp"], h, cfg.act)
    else:
        y = FF.mlp(p["mlp"], h, cfg.act)
    return (x + _out(y), aux, kv) if return_kv else (x + _out(y), aux)


def shared_block_forward(p, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    h = _norm_in(x, p["ln1"], cfg)
    x = x + _out(A.gqa_self_attention(p["attn"], h, cfg))
    h = _norm_in(x, p["ln2"], cfg)
    return x + _out(FF.mlp(p["mlp"], h, cfg.act))


def _shared_due(cfg: LMConfig, shared, i: int) -> bool:
    every = cfg.shared_attn_every
    return shared is not None and bool(every) and (i + 1) % every == 0


# ===========================================================================
# full-sequence forward (train / prefill hidden states)
# ===========================================================================

def _embed_inputs(params, tokens, prefix_embeds) -> torch.Tensor:
    parts = []
    if prefix_embeds is not None:
        pe = prefix_embeds.to(params["embed"].dtype)
        if "vision_proj" in params:
            pe = pe @ params["vision_proj"]
        parts.append(pe)
    if tokens is not None:
        parts.append(embed_lookup(params["embed"], tokens))
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On DTensors (the dry run) the table is gathered
    whole first, as ZeRO-3 gathers a weight before use: DTensor's
    vocab-sharded lookup leaves a masked partial sum whose gradient cannot
    meet another lookup's (deepseek's MTP head reads the table twice)."""
    return F.embedding(tokens, shard.replicate(table))


def lm_hidden(params, cfg: LMConfig, tokens: Optional[torch.Tensor] = None,
              prefix_embeds: Optional[torch.Tensor] = None, *,
              remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (final hidden (B,S,D), moe aux loss). S = prefix + token length."""
    x = _embed_inputs(params, tokens, prefix_embeds)
    # Megatron-SP (seq over model) for attention archs; an SSM's sequence
    # stays dp-only (the reference's §Perf Z2). No-ops without a mesh.
    seq_mp = None if cfg.family in ("ssm", "hybrid") else "mp"
    x = shard.constrain(x, "dp", seq_mp, None)
    shared = params.get("shared_block")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        def body(x, lp=lp, i=i):
            x, a = block_forward(lp, x, cfg)
            if _shared_due(cfg, shared, i):
                x = shared_block_forward(shared, x, cfg)
            return shard.constrain(x, "dp", seq_mp, None), a
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(body, x, use_reentrant=False)
        else:
            x, a = body(x)
        aux = aux + a
    return A.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


# ===========================================================================
# chunked cross-entropy (never materialises (B,S,V))
# ===========================================================================

def head_weight(params) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def chunked_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """h: (B,S,D); w: (D,V); labels: (B,S) with -1 = masked. Mean over valid."""
    h = shard.constrain(h, "dp", None, None)      # un-SP before the seq chunks
    s = h.shape[1]
    pad = (-s) % chunk
    if pad:
        h = shard.pad(h, (0, 0, 0, pad))
        labels = shard.pad(labels, (0, pad), value=-1)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range((s + pad) // chunk):
        hh, ll = h[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        logits = shard.grad_like((hh @ w).float())                     # (B,c,V)
        lse, gold = _lse_gold(logits, ll, hh, w)
        mask = (ll >= 0).float()
        loss_sum = loss_sum + torch.sum((lse - gold) * mask)
        n = n + mask.sum()
    return loss_sum / torch.clamp_min(n, 1.0)


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor, hh: torch.Tensor, w: torch.Tensor):
    """logsumexp over the vocab and the gold logit. On a DTensor whose
    vocab is sharded (the dry run) the logsumexp comes from per-shard
    partials, a max and a sum of exps, each reduced over the vocab's axis,
    as the reference's program reduces them, and the gold logit from the
    gold columns of ``w``: DTensor would gather the (B, c, V) logits, and
    its masked gather does not run on the meta device."""
    if shard.is_sharded(logits, -1):
        m = logits.amax(-1, keepdim=True).detach()
        lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
        w_gold = shard.constrain(F.embedding(labels.clamp_min(0), w.T), "dp", None, None)
        return lse, (hh.float() * w_gold.float()).sum(-1)
    return (torch.logsumexp(logits, dim=-1),
            logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0])


def lm_loss(params, cfg: LMConfig, tokens: torch.Tensor, labels: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, *, remat: bool = True
            ) -> torch.Tensor:
    h, aux = lm_hidden(params, cfg, tokens, prefix_embeds, remat=remat)
    if prefix_embeds is not None:                    # loss only on text positions
        h = h[:, prefix_embeds.shape[1]:]
    w = head_weight(params)
    loss = chunked_ce(h, w, labels)
    if cfg.n_experts:
        loss = loss + MOE_AUX_WEIGHT * aux / cfg.n_layers
    if cfg.mtp and "mtp" in params:
        # deepseek MTP: predict t+2 from [h_t ; emb(t+1)] through one extra block
        emb_next = embed_lookup(params["embed"], tokens[:, 1:])
        mtp_in = torch.cat([h[:, :-1], emb_next], dim=-1) @ params["mtp"]["proj"]
        mtp_h, _ = block_forward(params["mtp"]["block"], mtp_in, cfg)
        mtp_h = A.rmsnorm(mtp_h, params["mtp"]["ln"], cfg.norm_eps)
        mtp_labels = shard.pad(labels[:, 2:], (0, 1), value=-1)
        loss = loss + MTP_WEIGHT * chunked_ce(mtp_h, w, mtp_labels[:, :mtp_h.shape[1]])
    return loss


# ===========================================================================
# KV/state caches + decode
# ===========================================================================

def _stack_layers(states) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def init_caches(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cuda") -> Dict[str, Any]:
    dev = _resolve_device(device, "init_caches")
    L = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        init = S.mamba1_init_cache if cfg.family == "ssm" else S.mamba2_init_cache
        c = init(cfg, batch, dtype, dev)
        out: Dict[str, Any] = {"ssm": {k: v.expand((L,) + v.shape).clone()
                                       for k, v in c.items()}}
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            n_inv = cfg.n_layers // cfg.shared_attn_every
            shape = (n_inv, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            out["shared_kv"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                                "v": torch.zeros(shape, dtype=dtype, device=dev)}
        return out
    if cfg.use_mla:
        return {"ckv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                   device=dev),
                "kr": torch.zeros((L, batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                                  device=dev)}
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def block_decode(p, x, cfg: LMConfig, cache_l, pos):
    """One layer, one token. cache_l: this layer's cache slice."""
    if cfg.family in ("ssm", "hybrid"):
        h = A.rmsnorm(x, p["ln1"], cfg.norm_eps)
        fn = S.mamba1_decode if cfg.family == "ssm" else S.mamba2_decode
        y, new = fn(p["mamba"], h, cfg, cache_l)
        return x + y, new
    h = A.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        o, new = A.mla_decode(p["attn"], h, cfg, cache_l, pos)
    else:
        o, new = A.gqa_decode(p["attn"], h, cfg, cache_l, pos)
    x = x + o
    h = A.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        y, _ = FF.moe_forward(p["moe"], h, cfg)
    elif cfg.dynamic_width:
        y = FF.dynamic_width_ffn(p["mlp"], h, cfg.act)
    else:
        y = FF.mlp(p["mlp"], h, cfg.act)
    return x + y, new


def shared_block_decode(p, x, cfg: LMConfig, kv, pos):
    h = A.rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, new_kv = A.gqa_decode(p["attn"], h, cfg, kv, pos)
    x = x + o
    h = A.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + FF.mlp(p["mlp"], h, cfg.act), new_kv


def _write_layer(stacked: Dict[str, torch.Tensor], i: int, view: Dict[str, torch.Tensor],
                 new: Dict[str, torch.Tensor]) -> None:
    """Store layer i's new cache entries; those written in place already
    (the attention caches) are the views themselves."""
    for k, v in new.items():
        if v is not view[k]:
            stacked[k][i].copy_(v)


def lm_decode_step(params, cfg: LMConfig, token: torch.Tensor, caches: Dict[str, Any],
                   pos) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,1) int64; pos: the fill count (an int). -> (logits (B,V)
    float32, caches updated in place)."""
    pos = int(pos)
    x = embed_lookup(params["embed"], token)
    shared = params.get("shared_block")
    if cfg.family in ("ssm", "hybrid"):
        layer_caches = caches["ssm"]
    elif cfg.use_mla:
        layer_caches = {"ckv": caches["ckv"], "kr": caches["kr"]}
    else:
        layer_caches = {"k": caches["k"], "v": caches["v"]}
    for i, lp in enumerate(params["layers"]):
        view = {k: v[i] for k, v in layer_caches.items()}
        x, new = block_decode(lp, x, cfg, view, pos)
        _write_layer(layer_caches, i, view, new)
        if _shared_due(cfg, shared, i):
            inv = (i + 1) // cfg.shared_attn_every - 1
            kv = {k: v[inv] for k, v in caches["shared_kv"].items()}
            x, new_kv = shared_block_decode(shared, x, cfg, kv, pos)
            _write_layer(caches["shared_kv"], inv, kv, new_kv)
    h = A.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (h[:, 0] @ head_weight(params)).float()
    return logits, caches


# ===========================================================================
# prefill: full forward that also fills the caches
# ===========================================================================

def lm_prefill(params, cfg: LMConfig, tokens: torch.Tensor, max_len: int,
               prefix_embeds: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Runs the full sequence AND builds caches for subsequent decode.
    Returns (last-token logits (B,V) float32, caches). For attention archs
    the caches are the per-layer K/V (or MLA latents); for SSMs the final
    states."""
    x = _embed_inputs(params, tokens, prefix_embeds)
    b, s, _ = x.shape
    shared = params.get("shared_block")
    caches: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        fwd = S.mamba1_forward if cfg.family == "ssm" else S.mamba2_forward
        states = []
        shared_kv: Dict[str, Any] = {}
        for i, lp in enumerate(params["layers"]):
            y, st = fwd(lp["mamba"], A.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
                        return_state=True)
            x = x + y
            states.append(st)
            if _shared_due(cfg, shared, i):
                inv = (i + 1) // cfg.shared_attn_every - 1
                x, k, v = _shared_block_prefill(shared, x, cfg)
                n_inv = cfg.n_layers // cfg.shared_attn_every
                write_prefix(shared_kv, "k", inv, n_inv, k, max_len)
                write_prefix(shared_kv, "v", inv, n_inv, v, max_len)
        caches = {"ssm": _stack_layers(states)}
        if shared_kv:
            caches["shared_kv"] = shared_kv
    else:
        for i, lp in enumerate(params["layers"]):
            x, _, kv = block_forward(lp, x, cfg, return_kv=True)
            _prefill_layer_cache(caches, i, kv, cfg, max_len)
    h = A.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (h[:, -1] @ head_weight(params)).float()
    return logits, caches


def _shared_block_prefill(p, x, cfg: LMConfig):
    """Shared block full-seq forward that also returns its K/V for the cache."""
    h = A.rmsnorm(x, p["ln1"], cfg.norm_eps)
    o, (k, v) = A.gqa_self_attention(p["attn"], h, cfg, return_kv=True)
    x = x + o
    h = A.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + FF.mlp(p["mlp"], h, cfg.act), k, v


def _prefill_layer_cache(caches: Dict[str, Any], i: int, kv, cfg: LMConfig,
                         max_len: int) -> None:
    """Layer i's attention cache from its prefill forward: K/V (or MLA's
    latent and rope key), written into layer-stacked buffers of ``max_len``
    positions (made at layer 0, zero past the prompt). The reference
    recomputes them from the layer input; the port takes the block's own."""
    names = ("ckv", "kr") if cfg.use_mla else ("k", "v")
    for name, t in zip(names, kv):
        write_prefix(caches, name, i, cfg.n_layers, t, max_len)


def write_prefix(caches: Dict[str, Any], name: str, i: int, n: int, t: torch.Tensor,
                 max_len: int) -> None:
    """Layer ``i`` of ``n`` of cache ``name``: ``t`` (B, s, ...) at positions
    [0, s) of a (n, B, max_len, ...) buffer, zero past them (made at layer
    0). On DTensors (the dry run) each layer is padded on its own shards
    (the sequence whole) and the layers are stacked after the last: a
    DTensor takes no in-place write into a slice."""
    if shard.is_dtensor(t):
        if shard.is_sharded(t, 1):
            t = shard.constrain(t, "dp", *([None] * (t.ndim - 1)))
        pad = (0, 0) * (t.ndim - 2) + (0, max_len - t.shape[1])
        caches.setdefault(name, []).append(shard.on_shards(lambda u: F.pad(u, pad), t))
        if i == n - 1:
            caches[name] = torch.stack(caches[name])
        return
    if i == 0:
        caches[name] = torch.zeros((n, t.shape[0], max_len) + t.shape[2:],
                                   dtype=t.dtype, device=t.device)
    caches[name][i, :, :t.shape[1]] = t
