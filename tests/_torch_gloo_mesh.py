"""The dry run's sharded model code on real data: SMOKE configs on a (2, 2)
mesh of four CPU processes over gloo, against the same step run plain in
one process.

The dry run runs its DTensor paths on meta tensors over a ``fake`` group,
which counts their ops but moves no data. Here the same paths (the sharding
rules, the constrain sites, ``on_shards``, the sharded logsumexp, the
gradients put back on their parameters' placements, the MoE's row adds,
the SSM steps on shards, the caches' writes) carry numbers, and every
gathered result is held to the plain step.

    python tests/_torch_gloo_mesh.py --kind train|serve --archs a,b --out f.json

starts four ranks of itself (``--rank``) that meet through a file store in
the output's folder; rank 0 writes, for each arch, the largest difference
of each compared tensor from the plain step, relative to that tensor's
largest value. ``train``: the loss and every gradient leaf of
``make_loss_fn`` (remat on) with ``sharding.like``. ``serve``: prefill of
32 tokens into 64 positions, then one decode step: logits and every cache
leaf. Batch 4, fp32, weights from seed 0, tokens from numpy's seed 1.
"""
import argparse
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


def run_arch(arch: str, kind: str) -> dict:
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.ctx import use_ctx
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import transformer as T
    from repro_torch.train.trainer import value_and_grad

    cfg = get_config(arch, smoke=True)
    tree = T.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.float32).tree()
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int64))
    mi = SH.mesh_info(make_test_mesh((2, 2)))

    def dist_(t, specs):
        return tree_map(lambda x, p: distribute_tensor(x.detach().clone(), mi.mesh, p), t,
                        ST._shardings(specs, mi))
    dtree = dist_(tree, SH.param_specs(tree, cfg, mi))
    t0 = time.time()
    out = {}
    if kind == "train":
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        loss_fn = ST.make_loss_fn(cfg, remat=True)
        loss, grads = value_and_grad(loss_fn, tree, batch)
        dbatch = dist_(batch, SH.batch_specs(batch, mi))
        with use_ctx(mi.ctx()), implicit_replication():
            dloss, dgrads = value_and_grad(loss_fn, dtree, dbatch)
            dgrads = tree_map(SH.like, dgrads, dtree)
        out["loss"] = _rel(loss, dloss)
        out["grads"] = max(_rel(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(dgrads)))
        out["leaves"] = len(tree_leaves(grads))
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


def rank_main(rank: int, store: str, kind: str, archs, out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD)
    try:
        res = {arch: run_arch(arch, kind) for arch in archs}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def launch(kind: str, archs, out: str, timeout: float = 300.0) -> dict:
    """Four ranks of this script; -> rank 0's results. Raises with the
    ranks' last output when one fails or runs past ``timeout``."""
    store = os.path.join(os.path.dirname(os.path.abspath(out)), f"store_{kind}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    logs = [f"{out}.rank{r}.log" for r in range(WORLD)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--store", store,
                 "--kind", kind, "--archs", ",".join(archs), "--out", out],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = [open(log).read()[-2000:] for log in logs]
        raise RuntimeError(f"ranks {bad} failed: " + "\n".join(tails))
    with open(out) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=("train", "serve"), required=True)
    ap.add_argument("--archs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--store")
    a = ap.parse_args()
    archs = a.archs.split(",")
    if a.rank is None:
        print(json.dumps(launch(a.kind, archs, a.out), indent=1))
    else:
        rank_main(a.rank, a.store, a.kind, archs, a.out)


if __name__ == "__main__":
    main()
