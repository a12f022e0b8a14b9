"""Explicit MoE over a mesh (twin of ``repro.distributed.moe``) — the
reference's §Perf winner over the einsum dispatch, whose collectives the
partitioner chooses (TB-scale partial-sum all-reduces on grok-1 and
deepseek-v3 train_4k, EXPERIMENTS.md §Perf G2/D1). Here every collective
is explicit (``distributed/collectives.py``, each with its gradient):

  expert_tp  (E < mesh):  tokens stay local to each (dp x mp) shard; every
      shard computes ALL experts on its own tokens with its F-slice of the
      expert weights (all-gathered over dp — ZeRO-3); one psum over mp
      combines the F-partial outputs.
  ep_alltoall (E >= mp):  experts partitioned over mp; local dispatch
      buffers exchanged with all_to_all, local expert FFN, all_to_all back.

Token routing is per-token, so local-shard routing == global routing;
capacity becomes per-shard (more realistic than a global capacity pool).

The reference's ``shard_map`` body becomes one rank's code on the local
shards of DTensors: each input is laid out by the reference's
``in_specs`` and read with `to_local`, declaring how its gradient comes
back (split like the input, or a partial sum where the body uses a
replicated input for its own share); the outputs are DTensors of the
``out_specs``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.ctx import PartitionSpec as P
from repro_torch.distributed.ctx import _ContiguousGrad, is_dtensor, ungathered
from repro_torch.distributed.sharding import to_placements
from repro_torch.models.lm.ffn import _act, mlp, moe_capacity


def _local_dispatch(xf, probs, cfg: LMConfig, cap: int):
    """Local tokens (t,d) -> dispatch (E, cap, d), combine weights, slots."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    gate, idx = torch.topk(probs, k, dim=-1)                  # (t,k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, e)
    pos = torch.cumsum(onehot, dim=0).gather(1, flat_e[:, None])[:, 0] - 1
    valid = pos < cap
    slot = torch.where(valid, flat_e * cap + pos, torch.full_like(pos, e * cap))
    tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    disp = xf.new_zeros((e * cap + 1, d)).index_add(0, slot, xf[tok] * valid[:, None])
    return disp[:-1].reshape(e, cap, d), gate, tok, slot, valid


def _combine(y_slots, gate, tok, slot, valid, t, d, dtype):
    y = torch.cat([y_slots.reshape(-1, d), y_slots.new_zeros((1, d))], dim=0)
    w = (gate.reshape(-1) * valid).to(y.dtype)
    out = y.new_zeros((t, d)).index_add(0, tok, y[slot] * w[:, None])
    return out.to(dtype)


def _entry(axes: Tuple[str, ...]):
    return axes[0] if len(axes) == 1 else axes


def _read(w, mesh, spec: P, grad: tuple = None):
    """This rank's shard of the DTensor ``w`` laid out by ``spec``; its
    gradient comes back laid out by ``grad`` (default: like the shard)."""
    pl = to_placements(spec, mesh)
    if tuple(w.placements) != pl:
        w = w.redistribute(mesh, pl)
    return _ContiguousGrad.apply(w).to_local(grad_placements=grad or pl)


def moe_forward_shardmap(p, x: torch.Tensor, cfg: LMConfig, mesh, dp,
                         mp: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D), a DTensor on ``mesh`` (a DeviceMesh over a process
    group); ``dp`` the data axis or axes, ``mp`` the model axis. Returns
    (out, aux): out a DTensor like the reference's ``out_specs``, aux a
    0-d DTensor whole on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not is_dtensor(x):
        raise TypeError("moe_forward_shardmap runs on DTensors over a mesh; the plain MoE is "
                        "ffn.moe_forward without a sharding context")
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    d = cfg.d_model
    dp = (dp,) if isinstance(dp, str) else tuple(dp)
    names = tuple(mesh.mesh_dim_names)
    mp_size = C.axis_size(mesh, mp)
    dp_size = math.prod(C.axis_size(mesh, a) for a in dp)
    ep = cfg.moe_mode == "ep_alltoall" and e % mp_size == 0
    act = _act(cfg.act)
    raw = ungathered(p)                  # the ZeRO-3 gathers are this function's own

    # weight specs must match distributed.sharding rules
    dpe = _entry(dp)
    if ep:
        w_spec, wo_spec = P(mp, dpe, None), P(mp, None, dpe)
    else:
        w_spec, wo_spec = P(None, dpe, mp), P(None, mp, dpe)
    router = _read(raw["router"], mesh, P(None, None), (Partial(),) * mesh.ndim)
    w_in = _read(raw["w_in"], mesh, w_spec)
    w_gate = _read(raw["w_gate"], mesh, w_spec)
    w_out = _read(raw["w_out"], mesh, wo_spec)

    # expert_tp combines F-partials with a psum over mp — that is only sound
    # if every mp shard holds the SAME tokens, so the sequence enters
    # un-SP'd (P(dp, None, None)). ep_alltoall keeps tokens mp-sharded (each
    # shard dispatches its own). B/S are padded to mesh multiples (e.g.
    # deepseek's MTP shifts S to 4095); the pad tokens route like real ones
    # but their outputs are sliced off. A dim that needs a pad enters whole,
    # is padded and each rank takes its block (its gradient a partial sum).
    b0, s0, _ = x.shape
    split_b = b0 % dp_size == 0
    split_s = ep and s0 % mp_size == 0
    x_spec = P(dpe if split_b else None, mp if split_s else None, None)
    grad = tuple(Replicate() if mesh.size(i) == 1
                 else (Shard(0) if split_b else Partial()) if n in dp
                 else (Shard(1) if split_s else Partial()) if n == mp else Replicate()
                 for i, n in enumerate(names))
    xl = _read(x, mesh, x_spec, grad)
    if not split_b:
        pad_b = (-b0) % dp_size
        xl = F.pad(xl, (0, 0, 0, 0, 0, pad_b))
        b_l = xl.shape[0] // dp_size
        xl = xl[C.axis_index(mesh, dp) * b_l:][:b_l]
    if ep and not split_s:
        pad_s = (-s0) % mp_size
        xl = F.pad(xl, (0, 0, 0, pad_s))
        s_l = xl.shape[1] // mp_size
        xl = xl[:, C.axis_index(mesh, mp) * s_l:][:, :s_l]

    # --- the reference's shard_map body, on this rank's shards ---------------
    b_l, s_l, _ = xl.shape
    t = b_l * s_l
    xf = xl.reshape(t, d)
    probs = torch.softmax(xf.float() @ router, dim=-1)
    cap = moe_capacity(t, cfg)
    disp, gate, tok, slot, valid = _local_dispatch(xf, probs, cfg, cap)

    density = F.one_hot(probs.argmax(-1), e).float().mean(0)
    aux = e * torch.mean(density * probs.mean(0))
    aux = C.pmean(C.pmean(aux, mesh, mp), mesh, dp)

    # ZeRO-3: gather the dp-sharded weight dim just-in-time
    w_in_g = C.all_gather(w_in, mesh, dp, 1)                   # (E?,D,F?)
    w_gate_g = C.all_gather(w_gate, mesh, dp, 1)
    w_out_g = C.all_gather(w_out, mesh, dp, 2)

    if ep:
        # experts over mp: exchange dispatch so each shard owns its E/mp
        e_l = e // mp_size
        recv = C.all_to_all(disp.reshape(mp_size, e_l, cap, d), mesh, mp)   # (mp,e_l,cap,d)
        recv = recv.transpose(0, 1).reshape(e_l, mp_size * cap, d)
        h = torch.bmm(recv, w_in_g)
        h = h * act(torch.bmm(recv, w_gate_g))
        y = torch.bmm(h, w_out_g)                                           # (e_l,mp*cap,d)
        y = y.reshape(e_l, mp_size, cap, d).transpose(0, 1)
        y_slots = C.all_to_all(y, mesh, mp).reshape(e, cap, d)
        out = _combine(y_slots, gate, tok, slot, valid, t, d, x.dtype)
    else:
        # expert-TP: all experts local, F sliced over mp. The combine is
        # LINEAR in the slot outputs, so the F-partial psum commutes with
        # it — combining FIRST shrinks the psum operand from the slot
        # buffer (E*cap, d) to the token output (t, d) (§Perf G4).
        h = torch.bmm(disp, w_in_g)
        h = h * act(torch.bmm(disp, w_gate_g))
        y_partial = torch.bmm(h, w_out_g)
        out_partial = _combine(y_partial, gate, tok, slot, valid, t, d, x.dtype)
        out = C.psum(out_partial, mesh, mp).to(x.dtype)
    out = out.reshape(b_l, s_l, d)

    # --- back to the caller's layout -------------------------------------------
    if ep and not split_s:
        out = C.all_gather_whole(out, mesh, mp, 1)[:, :s0]
    if not split_b:
        out = C.all_gather_whole(out, mesh, dp, 0)[:b0]
    out = DTensor.from_local(out, mesh, to_placements(x_spec, mesh), run_check=False)
    aux = DTensor.from_local(aux, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    if "shared" in raw:
        # on the tokens with the sequence whole (DTensor flattens B and S then)
        xs = x.redistribute(mesh, to_placements(P(dpe if split_b else None, None, None), mesh))
        out = out + mlp(p["shared"], xs.reshape(-1, d), cfg.act).reshape(b0, s0, d)
    return out, aux
