"""Encoder-decoder stack (seamless-m4t backbone; the audio frontend is a stub:
callers supply precomputed frame embeddings).

The port of ``repro.models.lm.encdec``. Encoder: bidirectional GQA blocks.
Decoder: causal self-attention + cross-attention + MLP. Decode caches =
per-layer self-attn K/V plus the cross-attn K/V computed once at prefill,
layer-stacked as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models.lm import attention as A
from repro_torch.models.lm import ffn as FF
from repro_torch.models.lm.params import ParamTree, _resolve_device, normal
from repro_torch.models.lm.transformer import chunked_ce, embed_lookup, write_prefix


def _init_cross(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, g = cfg.n_heads, cfg.n_kv_heads
    std = d ** -0.5
    return {"wq": normal(generator, (d, h * hd), std, dtype, device),
            "wk": normal(generator, (d, g * hd), std, dtype, device),
            "wv": normal(generator, (d, g * hd), std, dtype, device),
            "wo": normal(generator, (h * hd, d), std, dtype, device)}


def init_encdec(cfg: LMConfig, *, generator, device="cuda", dtype=torch.bfloat16) -> ParamTree:
    """Random weights of the reference's shapes, dtypes and init scales;
    runs on the card unless ``device`` says otherwise."""
    dev = _resolve_device(device, "init_encdec")
    kw = dict(generator=generator, device=dev, dtype=dtype)
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    def enc_block():
        return {"ln1": ones(), "ln2": ones(), "attn": A.init_gqa(cfg, **kw),
                "mlp": FF.init_mlp(d, cfg.d_ff, cfg.act, **kw)}

    def dec_block():
        return {"ln1": ones(), "lnx": ones(), "ln2": ones(),
                "attn": A.init_gqa(cfg, **kw), "cross": _init_cross(cfg, **kw),
                "mlp": FF.init_mlp(d, cfg.d_ff, cfg.act, **kw)}

    return ParamTree({
        "enc_layers": [enc_block() for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [dec_block() for _ in range(cfg.n_layers)],
        "embed": normal(generator, (cfg.vocab_padded, d), d ** -0.5, dtype, dev),
        "enc_norm": ones(),
        "final_norm": ones(),
        "lm_head": normal(generator, (d, cfg.vocab_padded), d ** -0.5, dtype, dev),
    })


def _remat(body, x, remat: bool):
    return checkpoint(body, x, use_reentrant=False) if remat and torch.is_grad_enabled() \
        else body(x)


def encode(params, cfg: LMConfig, src_embeds: torch.Tensor, *, remat: bool = True
           ) -> torch.Tensor:
    x = src_embeds.to(params["embed"].dtype)
    for lp in params["enc_layers"]:
        def body(x, lp=lp):
            h = A.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            x = x + A.gqa_self_attention(lp["attn"], h, cfg, causal=False)
            h = A.rmsnorm(x, lp["ln2"], cfg.norm_eps)
            return x + FF.mlp(lp["mlp"], h, cfg.act)
        x = _remat(body, x, remat)
    return A.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(cp, x, enc, cfg: LMConfig, return_kv: bool = False):
    b, s, _ = x.shape
    hd, h, g = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ cp["wq"]).reshape(b, s, h, hd)
    k = (enc @ cp["wk"]).reshape(b, enc.shape[1], g, hd)
    v = (enc @ cp["wv"]).reshape(b, enc.shape[1], g, hd)
    o = A.blockwise_attention(q, k, v, causal=False, chunk=min(cfg.attn_chunk, enc.shape[1]))
    out = o.reshape(b, s, -1) @ cp["wo"]
    return (out, (k, v)) if return_kv else out


def _dec_layer(lp, x, enc, cfg: LMConfig, return_kv: bool = False):
    h = A.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    o = A.gqa_self_attention(lp["attn"], h, cfg, causal=True, return_kv=return_kv)
    o, kv = o if return_kv else (o, None)
    x = x + o
    h = A.rmsnorm(x, lp["lnx"], cfg.norm_eps)
    o = _cross_attend(lp["cross"], h, enc, cfg, return_kv=return_kv)
    o, ckv = o if return_kv else (o, None)
    x = x + o
    h = A.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + FF.mlp(lp["mlp"], h, cfg.act)
    return (x, kv, ckv) if return_kv else x


def decode_train(params, cfg: LMConfig, enc: torch.Tensor, tokens: torch.Tensor,
                 *, remat: bool = True) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens)
    for lp in params["dec_layers"]:
        x = _remat(lambda v, lp=lp: _dec_layer(lp, v, enc, cfg), x, remat)
    return A.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def encdec_loss(params, cfg: LMConfig, src_embeds, tokens, labels, *,
                remat: bool = True) -> torch.Tensor:
    enc = encode(params, cfg, src_embeds, remat=remat)
    h = decode_train(params, cfg, enc, tokens, remat=remat)
    return chunked_ce(h, params["lm_head"], labels)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def encdec_prefill(params, cfg: LMConfig, src_embeds, tokens, max_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """-> (last-token logits (B,V) float32, caches): the decoder's self-attn
    K/V padded to ``max_len`` and the cross-attn K/V of the source, each
    layer's taken from its own forward."""
    enc = encode(params, cfg, src_embeds, remat=False)
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    caches: Dict[str, Any] = {}
    n = cfg.n_layers
    for i, lp in enumerate(params["dec_layers"]):
        x, (k, v), (ck, cv) = _dec_layer(lp, x, enc, cfg, return_kv=True)
        write_prefix(caches, "k", i, n, k.to(x.dtype), max_len)
        write_prefix(caches, "v", i, n, v.to(x.dtype), max_len)
        write_prefix(caches, "ck", i, n, ck.to(x.dtype), enc.shape[1])
        write_prefix(caches, "cv", i, n, cv.to(x.dtype), enc.shape[1])
    h = A.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (h[:, -1] @ params["lm_head"]).float()
    return logits, caches


def init_encdec_caches(cfg: LMConfig, batch: int, max_len: int, src_len: int,
                       dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    dev = _resolve_device(device, "init_encdec_caches")
    L, hd, g = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads

    def z(n):
        return torch.zeros((L, batch, n, g, hd), dtype=dtype, device=dev)

    return {"k": z(max_len), "v": z(max_len), "ck": z(src_len), "cv": z(src_len)}


def encdec_decode_step(params, cfg: LMConfig, token, caches, pos
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,1); pos: the fill count (an int). -> (logits (B,V) float32,
    caches, the self-attn K/V written in place)."""
    pos = int(pos)
    x = embed_lookup(params["embed"], token)
    b = x.shape[0]
    hd, hh = cfg.resolved_head_dim, cfg.n_heads
    for i, lp in enumerate(params["dec_layers"]):
        h = A.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        o, _ = A.gqa_decode(lp["attn"], h, cfg, {"k": caches["k"][i], "v": caches["v"][i]}, pos)
        x = x + o
        h = A.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        q = (h @ lp["cross"]["wq"]).reshape(b, 1, hh, hd)
        ck, cv = caches["ck"][i], caches["cv"][i]
        o = A.decode_attention(q, ck, cv, ck.shape[1])
        x = x + o.reshape(b, 1, -1) @ lp["cross"]["wo"]
        h = A.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + FF.mlp(lp["mlp"], h, cfg.act)
    h = A.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (h[:, 0] @ params["lm_head"]).float()
    return logits, caches
