"""The port's sharded code on real data: SMOKE configs and the explicit
collectives on meshes of four processes, against the same work done plain
in one process.

The dry run runs its DTensor paths on meta tensors over a ``fake`` group,
which counts their ops but moves no data. Here the same paths (the sharding
rules, the constrain sites, ``on_shards``, the sharded logsumexp, the
gradients put back on their parameters' placements, the MoE's row adds and
the explicit shard_map MoE, the SSM steps on shards, the caches' writes)
carry numbers, and every gathered result is held to the plain step.

    python tests/_torch_gloo_mesh.py --kind train|serve|collectives --cases a,b --out f.json

starts four ranks of itself (``--rank``) that meet through a file store in
the output's folder, one torch thread a rank, over gloo on the CPU (or, with
``--backend nccl``, one card a rank). A case is ``ARCH[@DxM][+MODE]``: the
SMOKE config (or one of `VARIANTS`) on a (D, M) mesh of ("data", "model")
(default 2x2); ``+MODE``
runs its MoE through the explicit shard_map MoE in that mode
(``expert_tp`` or ``ep_alltoall``). Where that MoE routes the tokens in
several shards, its capacity factor is raised to E / k, where no shard
drops a token, so that per-shard capacity equals the plain step's global
one, and the plain step's aux loss is the mean of each shard's
(`per_shard_aux`); on (1, M) under expert_tp the plain step is the einsum
step itself. Rank 0 writes, for each case,
the largest difference of each compared tensor from the plain step,
relative to that tensor's largest value. ``train``: the loss and every
gradient leaf of ``make_loss_fn`` (remat on) with ``sharding.like``.
``serve``: prefill of 32 tokens into 64 positions, then one decode step:
logits and every cache leaf. Batch 4, fp32, weights from seed 0, tokens from
numpy's seed 1. ``collectives`` (no cases): flash decode, compressed psum
and the shard_map MoE on the inputs of `collective_inputs`; rank 0 writes
their gathered results to ``<out>.npz`` (tests/test_torch_collectives.py
holds them to the reference).

`launch` is the one way a test starts ranks: subprocesses of this file,
a file store in the caller's folder, a timeout, every rank killed on a
failure, the ranks' last output in the error.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD, BATCH, SEQ, PROMPT = 4, 4, 64, 32


def _rel(a, b) -> float:
    """max |a - b| over max |a| (b a DTensor, gathered)."""
    from torch.distributed.tensor import DTensor
    b = b.full_tensor() if isinstance(b, DTensor) else b
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


def parse_case(case: str):
    """``ARCH[@DxM][+MODE]`` -> (arch, mesh shape, shard_map mode or None)."""
    arch, mode = (case.split("+") + [None])[:2]
    arch, mesh = (arch.split("@") + ["2x2"])[:2]
    return arch, tuple(int(n) for n in mesh.split("x")), mode


#: SMOKE configs cut another way: qwen2 with the 14 query heads of its FULL
#: config, which a model axis of 4 does not divide
VARIANTS = {"qwen2-14h": ("qwen2-0.5b", dict(n_heads=14, n_kv_heads=2, head_dim=8))}


def case_config(case: str):
    from repro_torch.configs.registry import get_config
    arch, mesh, mode = parse_case(case)
    base, over = VARIANTS.get(arch, (arch, {}))
    cfg = dataclasses.replace(get_config(base, smoke=True), **over)
    if mode:
        cf = cfg.capacity_factor
        if _token_shards(cfg, mode, mesh) > 1:
            cf = max(cf, cfg.n_experts / cfg.n_experts_per_tok)
        cfg = dataclasses.replace(cfg, moe_impl="shard_map", moe_mode=mode, capacity_factor=cf)
    return cfg, mesh


def _token_shards(cfg, mode: str, mesh) -> int:
    """How many shards the shard_map MoE routes the tokens in: dp, times
    mp under expert parallelism."""
    ep = mode == "ep_alltoall" and cfg.n_experts % mesh[1] == 0
    return mesh[0] * (mesh[1] if ep else 1)


@contextlib.contextmanager
def per_shard_aux(cfg, mesh):
    """The plain step's MoE with the shard_map MoE's aux loss: the mean of
    each token shard's own aux (its batch rows over dp and, under expert
    parallelism, its sequence block over mp, padded as the MoE pads). Its
    output is the einsum MoE's: no shard drops a token (`case_config`)."""
    from repro_torch.models.lm import ffn as FF
    if cfg.moe_impl != "shard_map" or _token_shards(cfg, cfg.moe_mode, mesh) == 1:
        yield
        return
    import torch.nn.functional as F
    dpn, mpn = mesh
    ep = _token_shards(cfg, cfg.moe_mode, mesh) > dpn
    real = FF.moe_forward

    def moe(p, x, c):
        out, _ = real(p, x, c)
        b, s, _ = x.shape
        xp = F.pad(x, (0, 0, 0, (-s) % mpn if ep else 0, 0, (-b) % dpn))
        auxes = [real(p, blk, c)[1] for rows in xp.chunk(dpn, 0)
                 for blk in (rows.chunk(mpn, 1) if ep else (rows,))]
        return out, sum(auxes) / len(auxes)
    FF.moe_forward = moe
    try:
        yield
    finally:
        FF.moe_forward = real


_MESHES = {}


def cached_mesh(shape, axes=("data", "model")):
    """``make_test_mesh``, one a shape for the life of the process group:
    each mesh opens its own communicators, which NCCL backs with buffers of
    their own."""
    from repro_torch.launch.mesh import make_test_mesh
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = make_test_mesh(*key)
    return _MESHES[key]


def run_case(case: str, kind: str, device: str = "cpu") -> dict:
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.ctx import use_ctx
    from repro_torch.launch import steps as ST
    from repro_torch.models.lm import transformer as T
    from repro_torch.train.trainer import value_and_grad

    cfg, mesh_shape = case_config(case)
    tree = tree_map(lambda t: t.to(device), T.init_lm(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32).tree())
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int64)).to(device)
    mi = SH.mesh_info(cached_mesh(mesh_shape))

    def dist_(t, specs):
        return tree_map(lambda x, p: distribute_tensor(x.detach().clone(), mi.mesh, p), t,
                        ST._shardings(specs, mi))
    dtree = dist_(tree, SH.param_specs(tree, cfg, mi))
    t0 = time.time()
    out = {}
    if kind == "train":
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        loss_fn = ST.make_loss_fn(cfg, remat=True)
        with per_shard_aux(cfg, mesh_shape):
            loss, grads = value_and_grad(loss_fn, tree, batch)
        dbatch = dist_(batch, SH.batch_specs(batch, mi))
        with use_ctx(mi.ctx()), implicit_replication():
            dloss, dgrads = value_and_grad(loss_fn, dtree, dbatch)
            dgrads = tree_map(SH.like, dgrads, dtree)
        out["loss"] = _rel(loss, dloss)
        out["grads"] = max(_rel(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(dgrads)))
        out["leaves"] = len(tree_leaves(grads))
        out["loss_value"] = float(loss)
    else:
        prefill = ST.make_prefill_step(cfg, ShapeSpec("p", SEQ, BATCH, "prefill"))
        decode = ST.make_decode_step(cfg)
        prompt, nxt = {"tokens": seq[:, :PROMPT]}, seq[:, PROMPT:PROMPT + 1]
        lp, cp = prefill(tree, prompt)
        cp = tree_map(torch.clone, cp)
        ld, cd = decode(tree, tree_map(torch.clone, cp), nxt, PROMPT)
        with use_ctx(mi.ctx()), implicit_replication():
            dlp, dcp = prefill(dtree, dist_(prompt, SH.batch_specs(prompt, mi)))
            dcp = tree_map(lambda c, s: c.redistribute(mi.mesh, mi.placements(s)), dcp,
                           SH.cache_specs(dcp, cfg, mi, BATCH))
            out["prefill caches"] = max(_rel(a, b) for a, b in zip(tree_leaves(cp),
                                                                   tree_leaves(dcp)))
            dld, dcd = decode(dtree, dcp, dist_(nxt, SH.batch_specs(nxt, mi)), PROMPT)
        out["prefill logits"] = _rel(lp, dlp)
        out["decode logits"] = _rel(ld, dld)
        out["decode caches"] = max(_rel(a, b) for a, b in zip(tree_leaves(cd), tree_leaves(dcd)))
        out["leaves"] = len(tree_leaves(cd))
    out["seconds"] = time.time() - t0
    return out


# ---------------------------------------------------------------------------
# the explicit collectives (tests/test_torch_collectives.py)
# ---------------------------------------------------------------------------

#: flash decode: the reference test's shapes (tests/test_roofline_distributed.py:129-147)
FD_B, FD_S, FD_G, FD_H, FD_D, FD_LEN = 2, 32, 2, 4, 8, 20
#: the shard_map MoE: name -> (mode, experts, shared experts, x's shape); the
#: reference test's sizes (tests/test_roofline_distributed.py:223-263), then
#: with a shared expert, and with B (and, under EP, S) padded to the mesh
MOE_CASES = {"tp": ("expert_tp", 4, 0, (4, 8, 16)), "ep": ("ep_alltoall", 8, 1, (4, 8, 16)),
             "tp_pad": ("expert_tp", 4, 1, (3, 8, 16)), "ep_pad": ("ep_alltoall", 8, 0, (3, 7, 16))}
MOE_CFS = (8.0, 1.0)
MOE_D, MOE_F = 16, 32
MOE_AUX_WEIGHT = 3.0


def moe_config(mode: str, e: int, shared: int, cf: float, cls=None):
    """The reference test's MoE config: the port's ``LMConfig``, or ``cls``
    (the reference's, which has the same fields)."""
    if cls is None:
        from repro_torch.configs.base import LMConfig as cls
    return cls(name="t", family="moe", n_layers=1, d_model=MOE_D, n_heads=2, n_kv_heads=2,
                    d_ff=MOE_F, vocab_size=64, n_experts=e, n_experts_per_tok=2,
                    n_shared_experts=shared, moe_d_ff=MOE_F, moe_mode=mode, capacity_factor=cf)


def collective_inputs() -> dict:
    """Every input of the ``collectives`` kind, from numpy's seed 0 (float32)."""
    import numpy as np
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = {"fd_q": rng.standard_normal((FD_B, 1, FD_H, FD_D)).astype(f32),
         "fd_k": rng.standard_normal((FD_B, FD_S, FD_G, FD_D)).astype(f32),
         "fd_v": rng.standard_normal((FD_B, FD_S, FD_G, FD_D)).astype(f32),
         # compressed psum: two steps of a two-leaf tree, the error carried
         "cp1_w": np.linspace(-1, 1, 64, dtype=f32).reshape(8, 8),
         "cp1_b": rng.standard_normal((5, 3)).astype(f32),
         "cp2_w": (0.5 * rng.standard_normal((8, 8))).astype(f32),
         "cp2_b": rng.standard_normal((5, 3)).astype(f32)}
    for name, (mode, e, shared, xshape) in MOE_CASES.items():
        d, f = MOE_D, MOE_F
        x[f"{name}_router"] = (d ** -0.5 * rng.standard_normal((d, e))).astype(f32)
        x[f"{name}_w_in"] = (d ** -0.5 * rng.standard_normal((e, d, f))).astype(f32)
        x[f"{name}_w_gate"] = (d ** -0.5 * rng.standard_normal((e, d, f))).astype(f32)
        x[f"{name}_w_out"] = (f ** -0.5 * rng.standard_normal((e, f, d))).astype(f32)
        if shared:
            x[f"{name}_shared_w_in"] = (d ** -0.5 * rng.standard_normal((d, f))).astype(f32)
            x[f"{name}_shared_w_gate"] = (d ** -0.5 * rng.standard_normal((d, f))).astype(f32)
            x[f"{name}_shared_w_out"] = (f ** -0.5 * rng.standard_normal((f, d))).astype(f32)
        x[f"{name}_x"] = rng.standard_normal(xshape).astype(f32)
        x[f"{name}_ct"] = rng.standard_normal(xshape).astype(f32)     # the output's cotangent
    return x


MOE_LEAVES = ("router", "w_in", "w_gate", "w_out", "shared_w_in", "shared_w_gate",
              "shared_w_out")


def moe_params(inp: dict, name: str) -> dict:
    """(leaf -> array) of one case's MoE weights, the reference's tree
    flattened ("w_in", "shared_w_in", ...)."""
    return {n: inp[f"{name}_{n}"] for n in MOE_LEAVES if f"{name}_{n}" in inp}


def run_collectives(device: str = "cpu") -> dict:
    """One rank's flash decode, compressed psum and shard_map MoE; -> the
    gathered results (numpy), the same on every rank."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.moe import moe_forward_shardmap

    inp = {k: torch.from_numpy(v).to(device) for k, v in collective_inputs().items()}
    rank = dist.get_rank()
    res = {}
    # flash decode on (model=4): DTensors, and this rank's own slices
    mesh = cached_mesh((WORLD,), ("model",))
    q = distribute_tensor(inp["fd_q"], mesh, [Replicate()])
    k, v = (distribute_tensor(inp[n], mesh, [Shard(1)]) for n in ("fd_k", "fd_v"))
    res["fd"] = C.flash_decode_attention(mesh, "model", q, k, v, FD_LEN).full_tensor()
    s_l = FD_S // WORLD
    res["fd_local"] = C.flash_decode_attention(
        mesh, "model", inp["fd_q"], inp["fd_k"][:, rank * s_l:][:, :s_l],
        inp["fd_v"][:, rank * s_l:][:, :s_l], torch.tensor(FD_LEN, device=device))
    # compressed psum on (data=4): the same gradients on every rank (the
    # reference's in_specs=P()), then each rank its own (rank + 1) x g
    mesh = cached_mesh((WORLD,), ("data",))
    g1 = {"w": inp["cp1_w"], "b": inp["cp1_b"]}
    g2 = {"w": inp["cp2_w"], "b": inp["cp2_b"]}
    red1, err1 = C.compressed_psum(mesh, "data", g1, C.init_error_state(g1))
    red2, err2 = C.compressed_psum(mesh, "data", g2, err1)
    for n in ("w", "b"):
        res[f"cp_red1_{n}"], res[f"cp_err1_{n}"] = red1[n], err1[n]
        res[f"cp_red2_{n}"], res[f"cp_err2_{n}"] = red2[n], err2[n]
    own = {n: t * (rank + 1) for n, t in g1.items()}
    red, err = C.compressed_psum(mesh, "data", own, C.init_error_state(own))
    for n in ("w", "b"):
        res[f"cp_own_red_{n}"] = red[n]
        res[f"cp_own_err_{n}"] = torch.stack(
            [t.to(device) for t in _gather_rows(err[n], WORLD)])
    # the shard_map MoE on (data=2, model=2), both modes, the reference
    # test's layouts: forward, aux and every gradient, gathered
    mesh = cached_mesh((2, 2))
    for name, (mode, e, shared, xshape) in MOE_CASES.items():
        ep = mode == "ep_alltoall"
        wi = [Shard(1), Shard(0)] if ep else [Shard(1), Shard(2)]
        wo = [Shard(2), Shard(0)] if ep else [Shard(2), Shard(1)]
        ps = moe_params(inp, name)
        even = xshape[0] % 2 == 0 and (not ep or xshape[1] % 2 == 0)
        for cf in MOE_CFS:
            cfg = moe_config(mode, e, shared, cf)
            leaves = {"router": distribute_tensor(ps["router"], mesh, [Shard(0), Replicate()]),
                      "w_in": distribute_tensor(ps["w_in"], mesh, wi),
                      "w_gate": distribute_tensor(ps["w_gate"], mesh, wi),
                      "w_out": distribute_tensor(ps["w_out"], mesh, wo)}
            for n in ("w_in", "w_gate", "w_out"):
                if f"shared_{n}" in ps:
                    leaves[f"shared_{n}"] = distribute_tensor(ps[f"shared_{n}"], mesh,
                                                              [Replicate(), Replicate()])
            x = distribute_tensor(inp[f"{name}_x"], mesh, [Shard(0), Shard(1)] if even
                                  else [Replicate(), Replicate()])
            for t in (x, *leaves.values()):
                t.requires_grad_(True)
            p = {n: t for n, t in leaves.items() if not n.startswith("shared_")}
            if shared:
                p["shared"] = {n[7:]: t for n, t in leaves.items() if n.startswith("shared_")}
            out, aux = moe_forward_shardmap(p, x, cfg, mesh, "data", "model")
            ct = distribute_tensor(inp[f"{name}_ct"], mesh, [Replicate(), Replicate()])
            loss = (out * ct).sum() + MOE_AUX_WEIGHT * aux
            loss.backward()
            tag = f"moe_{name}_cf{cf:g}"
            res[f"{tag}_out"] = out.full_tensor()
            res[f"{tag}_aux"] = aux.full_tensor()
            res[f"{tag}_grad_x"] = x.grad.full_tensor()
            for n, t in leaves.items():
                res[f"{tag}_grad_{n}"] = t.grad.full_tensor()
    return {k: v.detach().cpu().numpy() for k, v in res.items()}


def _gather_rows(t, n: int):
    import torch
    import torch.distributed as dist
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous())
    return out


# ---------------------------------------------------------------------------
# ranks and the launcher
# ---------------------------------------------------------------------------

def rank_main(rank: int, store: str, kind: str, cases, out: str, backend: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    device = "cuda" if backend == "nccl" else "cpu"
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=WORLD)
    try:
        if kind == "collectives":
            res = run_collectives(device)
        else:
            res = {case: run_case(case, kind, device) for case in cases}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        if kind == "collectives":
            import numpy as np
            np.savez(out + ".npz", **res)
            res = {"arrays": len(res)}
        with open(out, "w") as f:
            json.dump(res, f)


def launch(kind: str, cases, out: str, timeout: float = 300.0, backend: str = "gloo") -> dict:
    """Four ranks of this script; -> rank 0's results. Raises with the
    ranks' last output when one fails or runs past ``timeout``."""
    store = os.path.join(os.path.dirname(os.path.abspath(out)), f"store_{kind}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC), OMP_NUM_THREADS="1")
    if backend == "gloo":
        env["CUDA_VISIBLE_DEVICES"] = ""
    logs = [f"{out}.rank{r}.log" for r in range(WORLD)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--store", store,
                 "--kind", kind, "--cases", ",".join(cases), "--out", out,
                 "--backend", backend],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = [f"--- rank {r}:\n" + open(log).read()[-2000:] for r, log in enumerate(logs)]
        raise RuntimeError(f"ranks {bad} failed or ran past {timeout:.0f} s:\n"
                           + "\n".join(tails))
    with open(out) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=("train", "serve", "collectives"), required=True)
    ap.add_argument("--cases", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--store")
    a = ap.parse_args()
    cases = [c for c in a.cases.split(",") if c]
    if a.rank is None:
        print(json.dumps(launch(a.kind, cases, a.out, backend=a.backend), indent=1))
    else:
        rank_main(a.rank, a.store, a.kind, cases, a.out, a.backend)


if __name__ == "__main__":
    main()
