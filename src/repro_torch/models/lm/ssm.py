"""SSM substrate: Mamba-1 selective scan (falcon-mamba) and Mamba-2/SSD
(zamba2), both in *chunked* form (Mamba-2 also in the SSD block-matmul form,
``mamba2_impl="ssd"``).

The port of ``repro.models.lm.ssm``. Across chunks a loop carries the
(B, d, N) state; within a chunk the first-order recurrence runs step by step
(the reference uses ``lax.associative_scan``: the same recurrence, summed in
another order).
Decode is an O(1) single-token state update (the "KV cache" of an SSM is its
state, constant in seq_len).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.distributed import ctx as shard
from repro_torch.distributed.ctx import is_dtensor
from repro_torch.models.lm.attention import rmsnorm
from repro_torch.models.lm.params import normal, uniform


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (B,S,C); w: (k,C); returns (y, new_state)
    where state carries the last k-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        xp = shard.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return y + b, xp[:, -(k - 1):, :]


def _pad_seq(pad: int, *ts):
    return tuple(shard.pad(t, (0, 0, 0, pad)) for t in ts) if pad else ts


# ===========================================================================
# Mamba-1 (falcon-mamba-7b)
# ===========================================================================

def init_mamba1(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    d, di, n, r, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    std = d ** -0.5
    dt = torch.exp(uniform(generator, (di,), math.log(1e-3), math.log(1e-1), device))
    return {
        "in_proj": normal(generator, (d, 2 * di), std, dtype, device),
        "conv_w": normal(generator, (k, di), 0.1, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": normal(generator, (di, r + 2 * n), di ** -0.5, dtype, device),
        "dt_proj": normal(generator, (r, di), r ** -0.5, dtype, device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)
                           ).expand(di, n).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": normal(generator, (di, d), di ** -0.5, dtype, device),
    }


def _scan_chunked(a_fn, b_fn, y_fn, h0, n_chunks):
    """Generic chunked linear recurrence h_t = a_t * h_{t-1} + b_t: chunk i
    provides elementwise decay a and input b (B, ck, ...); -> (final state,
    stacked y_fn(i, states at every step of chunk i))."""
    h, ys = h0, []
    for i in range(n_chunks):
        a, b = a_fn(i), b_fn(i)
        if is_dtensor(b):
            h, states = _steps_on_shards(a, b, h)
        else:
            states = []
            for j in range(b.shape[1]):
                h = a[:, j] * h + b[:, j]
                states.append(h)
            states = torch.stack(states, dim=1)
        ys.append(y_fn(i, states))
    return h, torch.stack(ys)


def _steps_on_shards(a, b, h):
    """One chunk's steps on DTensors (the dry run): the recurrence is
    elementwise, so each rank runs it on its own shards of a, b and h (the
    chunk's step dim whole), and the states go back into a DTensor. Stepping
    the DTensors themselves would pay DTensor's dispatch every step."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = b.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim != 1 else Replicate() for p in b.placements)
    hpl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p for p in pl)
    a = a.expand(b.shape) if a.shape != b.shape else a
    a_l = a.redistribute(mesh, pl).to_local()
    b_l = b.redistribute(mesh, pl).to_local()
    h_l = h.redistribute(mesh, hpl).to_local() if is_dtensor(h) else h
    states = []
    for j in range(b_l.shape[1]):
        h_l = a_l[:, j] * h_l + b_l[:, j]
        states.append(h_l)
    states = torch.stack(states, dim=1)
    return (DTensor.from_local(h_l, mesh, hpl, run_check=False),
            DTensor.from_local(states, mesh, pl, run_check=False))


def _in_proj(p, u: torch.Tensor, di: int):
    """(x, z) of Mamba-1's merged in_proj (D, 2*di). Where its merged dim is
    split over the model axis, the shards hold x on some ranks and z on
    others, so a product with the merged weight would leave d_inner whole on
    every rank; each half of the weight is laid out on its own instead (the
    weight gathered over the axis, then split like the rest of the block's
    d_inner), and the activations keep d_inner split. Plain: one product."""
    w = p["in_proj"]
    if not shard.is_sharded(w, 1):
        xz = u @ w
        return xz[..., :di], xz[..., di:]
    from torch.distributed.tensor import Replicate, Shard
    u = shard.constrain(u, "dp", None, None)          # the sequence whole, d_inner split
    mesh, pl = w.device_mesh, tuple(w.placements)
    whole = w.redistribute(mesh, tuple(Replicate() if isinstance(q, Shard) and q.dim == 1 else q
                                       for q in pl))
    return tuple(u @ half.redistribute(mesh, pl) for half in (whole[:, :di], whole[:, di:]))


def mamba1_forward(p, u: torch.Tensor, cfg: LMConfig, return_state: bool = False):
    """u: (B,S,D) -> (B,S,D) [, final {'h','conv'} state]. Chunked scan.
    Padded tail steps get dt=0 (identity state update) so the returned state
    is exact regardless of S % chunk."""
    bsz, s, _ = u.shape
    di, n, r, ck = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_chunk
    x_raw, z = _in_proj(p, u, di)
    x, _ = _causal_conv(x_raw, p["conv_w"], p["conv_b"])
    x = F.silu(x)
    # the small (B,S,r+2n) projection summed over d_inner's shards, so that
    # dt's up-projection keeps d_inner split (a no-op without a mesh)
    proj = shard.constrain(x @ p["x_proj"], "dp", None, None)
    # softplus on each rank's shard: DTensor runs its backward whole on every rank
    dt = shard.on_shards(F.softplus, proj[..., :r] @ p["dt_proj"] + p["dt_bias"])  # (B,S,di)
    Bm, Cm = proj[..., r:r + n], proj[..., r + n:]                     # (B,S,n)
    A = -torch.exp(p["A_log"])                                         # (di,n)

    pad = (-s) % ck
    x, dt, Bm, Cm = _pad_seq(pad, x, dt, Bm, Cm)
    nc = (s + pad) // ck
    xc = x.reshape(bsz, nc, ck, di)
    dtc = dt.reshape(bsz, nc, ck, di).float()
    Bc = Bm.reshape(bsz, nc, ck, n).float()
    Cc = Cm.reshape(bsz, nc, ck, n).float()

    def a_fn(i):
        return torch.exp(dtc[:, i, :, :, None] * A)                     # (B,ck,di,n)

    def b_fn(i):
        return (dtc[:, i] * xc[:, i].float())[..., None] * Bc[:, i, :, None, :]

    def y_fn(i, h_all):                                                # (B,ck,di,n)
        return torch.einsum("bkdn,bkn->bkd", h_all, Cc[:, i])

    h0 = torch.zeros_like(dtc[:, 0, 0, :, None].expand(bsz, di, n))   # laid out like the inputs
    h_final, ys = _scan_chunked(a_fn, b_fn, y_fn, h0, nc)              # (nc,B,ck,di)
    y = ys.permute(1, 0, 2, 3).reshape(bsz, nc * ck, di)
    if pad:          # a slice only where there is a pad: on a DTensor the
        y, x = y[:, :s], x[:, :s]     # slice's gradient is made whole on every rank
    y = y + x.float() * p["D"]
    y = (y * F.silu(z.float())).to(u.dtype)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"h": h_final, "conv": x_raw[:, -(cfg.ssm_conv - 1):, :]}
    return out


def mamba1_init_cache(cfg: LMConfig, batch: int, dtype=torch.float32,
                      device="cpu") -> Dict[str, torch.Tensor]:
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                                device=device)}


def mamba1_decode(p, u, cfg: LMConfig, cache):
    """u: (B,1,D); O(1) state update."""
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    x, z = _in_proj(p, u, di)
    x, conv_state = _causal_conv(x, p["conv_w"], p["conv_b"], cache["conv"])
    x = F.silu(x)
    proj = x @ p["x_proj"]
    dt = F.softplus(proj[..., :r] @ p["dt_proj"] + p["dt_bias"])[:, 0].float()
    Bm = proj[:, 0, r:r + n].float()
    Cm = proj[:, 0, r + n:].float()
    A = -torch.exp(p["A_log"])
    xf = x[:, 0].float()
    h = torch.exp(dt[..., None] * A) * cache["h"] + (dt * xf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + xf * p["D"]
    y = (y * F.silu(z[:, 0].float())).to(u.dtype)
    return (y @ p["out_proj"])[:, None], {"h": h, "conv": conv_state}


# ===========================================================================
# Mamba-2 / SSD (zamba2)
# ===========================================================================

def init_mamba2(cfg: LMConfig, *, generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Projections stored split (w_z/w_x/w_bc/w_dt + per-part convs), as the
    reference stores them."""
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    heads = di // cfg.ssm_head_dim
    std = d ** -0.5
    return {
        "w_z": normal(generator, (d, di), std, dtype, device),
        "w_x": normal(generator, (d, di), std, dtype, device),
        "w_bc": normal(generator, (d, 2 * n), std, dtype, device),
        "w_dt": normal(generator, (d, heads), std, dtype, device),
        "conv_w": normal(generator, (k, di), 0.1, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_w_bc": normal(generator, (k, 2 * n), 0.1, dtype, device),
        "conv_b_bc": torch.zeros((2 * n,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((heads,), dtype=torch.float32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32, device=device)),
        "D": torch.ones((heads,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": normal(generator, (di, d), di ** -0.5, dtype, device),
    }


def _mamba2_split(p, u, cfg: LMConfig):
    z = u @ p["w_z"]
    x = u @ p["w_x"]
    bc = u @ p["w_bc"]
    dt = F.softplus((u @ p["w_dt"]).float() + p["dt_bias"])
    return z, x, bc, dt


def _mamba2_inputs(p, u, cfg: LMConfig):
    """The convolved, activated inputs of a Mamba-2 layer, padded to whole
    chunks: z, x_raw, bc_raw and (xh, dtc, Bc, Cc) chunked, A, nc."""
    bsz, s, _ = u.shape
    di, n, ck = cfg.d_inner, cfg.ssm_state, cfg.ssm_chunk
    hds = cfg.ssm_head_dim
    heads = di // hds
    z, x_raw, bc_raw, dt = _mamba2_split(p, u, cfg)
    x, _ = _causal_conv(x_raw, p["conv_w"], p["conv_b"])
    bc, _ = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"])
    x = F.silu(x)
    bc = F.silu(bc)
    Bm, Cm = bc[..., :n], bc[..., n:]
    A = -torch.exp(p["A_log"])                                         # (H,)
    pad = (-s) % ck
    x, dt, Bm, Cm = _pad_seq(pad, x, dt, Bm, Cm)
    nc = (s + pad) // ck
    xh = x.reshape(bsz, nc, ck, heads, hds).float()
    dtc = dt.reshape(bsz, nc, ck, heads)                               # float32 already
    Bc = Bm.reshape(bsz, nc, ck, n).float()
    Cc = Cm.reshape(bsz, nc, ck, n).float()
    return z, x_raw, bc_raw, (xh, dtc, Bc, Cc), A, nc


def _mamba2_output(p, u, cfg: LMConfig, ys, xh, z, state, x_raw, bc_raw, return_state: bool):
    """y = (scan + D x) * silu(z), normed, projected; ys (nc,B,ck,H,P)."""
    bsz, s, _ = u.shape
    di, hds = cfg.d_inner, cfg.ssm_head_dim
    heads = di // hds
    nck = ys.shape[0] * ys.shape[2]
    y = ys.permute(1, 0, 2, 3, 4).reshape(bsz, nck, heads, hds)[:, :s]
    y = y + xh.reshape(bsz, nck, heads, hds)[:, :s] * p["D"][:, None]
    y = y.reshape(bsz, s, di)
    y = (y * F.silu(z.float())).to(u.dtype)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        return out, {"h": state, "conv": x_raw[:, -(cfg.ssm_conv - 1):, :],
                     "conv_bc": bc_raw[:, -(cfg.ssm_conv - 1):, :]}
    return out


def mamba2_ssd_forward(p, u: torch.Tensor, cfg: LMConfig, return_state: bool = False):
    """Mamba-2 in the SSD block-matmul form (the reference's §Perf Z1):
    within a chunk, Y = ((C Bᵀ) ⊙ decay ⊙ causal) @ (dt ⊙ x) + C·(decay·S),
    so only the (B,K,K,H) kernel and the (B,H,P,N) state are live, and the
    work is matmuls. Selected by ``cfg.mamba2_impl == "ssd"``."""
    bsz = u.shape[0]
    heads, ck = cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_chunk
    z, x_raw, bc_raw, (xh, dtc, Bc, Cc), A, nc = _mamba2_inputs(p, u, cfg)
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=u.device))
    S = torch.zeros_like(xh[:, 0, 0, :, :, None].expand(bsz, heads, cfg.ssm_head_dim,
                                                        cfg.ssm_state))
    ys = []
    for i in range(nc):
        dti, xi, Bi, Ci = dtc[:, i], xh[:, i], Bc[:, i], Cc[:, i]
        ca = torch.cumsum(dti * A, dim=1)                              # (B,K,H) logs
        dtx = dti[..., None] * xi                                      # (B,K,H,P)
        cb = torch.einsum("bin,bjn->bij", Ci, Bi)                      # (B,K,K)
        decay = torch.exp(ca[:, :, None, :] - ca[:, None, :, :])       # (B,K,K,H)
        kern = cb[..., None] * torch.where(causal[None, :, :, None], decay, 0.0)
        y = torch.einsum("bijh,bjhp->bihp", kern, dtx)
        y = y + torch.exp(ca)[..., None] * torch.einsum("bin,bhpn->bihp", Ci, S)
        tail = torch.exp(ca[:, -1:, :] - ca)                           # (B,K,H)
        S = (torch.exp(ca[:, -1])[:, :, None, None] * S
             + torch.einsum("bkhp,bkn->bhpn", tail[..., None] * dtx, Bi))
        ys.append(y)
    return _mamba2_output(p, u, cfg, torch.stack(ys), xh, z, S, x_raw, bc_raw, return_state)


def mamba2_forward(p, u: torch.Tensor, cfg: LMConfig, return_state: bool = False):
    if cfg.mamba2_impl == "ssd":
        return mamba2_ssd_forward(p, u, cfg, return_state)
    bsz = u.shape[0]
    heads = cfg.d_inner // cfg.ssm_head_dim
    z, x_raw, bc_raw, (xh, dtc, Bc, Cc), A, nc = _mamba2_inputs(p, u, cfg)

    def a_fn(i):
        return torch.exp(dtc[:, i] * A)[..., None, None]               # (B,ck,H,1,1)

    def b_fn(i):
        return (dtc[:, i][..., None, None] * xh[:, i][..., None]
                * Bc[:, i, :, None, None, :])                          # (B,ck,H,P,n)

    def y_fn(i, h_all):
        return torch.einsum("bkhpn,bkn->bkhp", h_all, Cc[:, i])

    h0 = torch.zeros_like(xh[:, 0, 0, :, :, None].expand(bsz, heads, cfg.ssm_head_dim,
                                                         cfg.ssm_state))
    h_final, ys = _scan_chunked(a_fn, b_fn, y_fn, h0, nc)              # (nc,B,ck,H,P)
    return _mamba2_output(p, u, cfg, ys, xh, z, h_final, x_raw, bc_raw, return_state)


def mamba2_init_cache(cfg: LMConfig, batch: int, dtype=torch.float32,
                      device="cpu") -> Dict[str, torch.Tensor]:
    di, n = cfg.d_inner, cfg.ssm_state
    heads = di // cfg.ssm_head_dim
    return {"h": torch.zeros((batch, heads, cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
            "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * n), dtype=dtype,
                                   device=device)}


def mamba2_decode(p, u, cfg: LMConfig, cache):
    di, n = cfg.d_inner, cfg.ssm_state
    hds = cfg.ssm_head_dim
    heads = di // hds
    z, x_raw, bc_raw, dt = _mamba2_split(p, u, cfg)
    x, conv_state = _causal_conv(x_raw, p["conv_w"], p["conv_b"], cache["conv"])
    bc, conv_bc_state = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"], cache["conv_bc"])
    x = F.silu(x)
    bc = F.silu(bc)
    Bm, Cm = bc[..., :n], bc[..., n:]
    A = -torch.exp(p["A_log"])
    xf = x[:, 0].reshape(-1, heads, hds).float()
    dt1 = dt[:, 0]                                                     # (B,H)
    Bf, Cf = Bm[:, 0].float(), Cm[:, 0].float()
    a = torch.exp(dt1 * A)[..., None, None]
    h = a * cache["h"] + (dt1[..., None, None] * xf[..., None]) * Bf[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cf) + xf * p["D"][:, None]
    y = y.reshape(-1, di)
    y = (y * F.silu(z[:, 0].float())).to(u.dtype)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], {"h": h, "conv": conv_state,
                                          "conv_bc": conv_bc_state}
