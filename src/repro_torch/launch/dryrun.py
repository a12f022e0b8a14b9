"""The dry run: one rank's step of every (arch x shape x mesh) cell, counted
without a card (twin of ``repro.launch.dryrun``).

The reference compiles each cell for 512 fake host devices and reads XLA's
memory and cost analyses. The port fakes the process group instead: for
each cell `run_cell` opens a ``fake`` group of the mesh's size
(``launch/mesh.py``), lays the meta state out as DTensors under the
sharding rules (``distributed/sharding.py``), runs one rank's train, prefill
or decode step and counts that rank's FLOPs, collective bytes and memory
(``launch/counters.py``). Nothing is allocated and CUDA is never touched: a
cell that breaks a sharding rule or an op fails here. Each record goes to
``results/dryrun_torch/<mesh>/<arch>__<shape><tag>.json``; `launch/report.py`
renders them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import ALL_SHAPES, active_param_count_estimate, shape_applicable
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.ctx import PartitionSpec as P
from repro_torch.launch import costmodel as CM
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (fake_world, make_production_mesh, make_test_mesh,
                                     production_mesh_shape)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")

ESSR_ARCHS = ("essr-x4",)
ESSR_SHAPES = ("serve_8k", "train_patch")


def _essr_lower(shape_name: str, mi: SH.MeshInfo, opts: str = ""):
    """ESSR cells: the paper's own workload on the production mesh, through
    the plain forward (no kernel runs on the meta device), parameters
    replicated and patches sharded over every rank. serve_8k: one 8K
    frame's 2304 32x32 patches through C54. train_patch: one supernet step
    (Lamb, L1) on the paper's batch of 256 scaled up to the rank count.
    opts 'int8': int8 weights with a scale and uint8 frames (the
    reference's §Perf E1). -> (LoweredCell, model FLOPs)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.distributed.ctx import on_shards
    from repro_torch.models.essr import ESSR_X4, essr_forward, init_essr
    from repro_torch.train import losses as Ls
    from repro_torch.train import optimizer as O

    cfg = ESSR_X4
    n_chips = mi.n_devices
    axes = tuple(mi.dp) + (mi.mp,)
    rows = P(axes, None, None, None)

    def meta(shape, dtype, spec):
        loc = torch.empty(SH.local_shape(shape, spec, mi.mesh), dtype=dtype, device="meta")
        return DTensor.from_local(loc, mi.mesh, mi.placements(spec), run_check=False)

    def forward(p, x):
        # the forward is independent per patch: each rank's own patches
        return on_shards(lambda x, *ws: essr_forward(tree_unflatten(p, ws), x, cfg),
                         x, *tree_leaves(p))

    int8 = "int8" in opts
    pdt = torch.int8 if int8 else torch.bfloat16
    params = tree_map(lambda t: meta(t.shape, pdt, P()), init_essr(cfg).tree())

    if shape_name == "serve_8k":
        n = -(-2304 // n_chips) * n_chips               # 64 x 36 patches, padded to the ranks
        x = meta((n, 32, 32, 3), torch.uint8 if int8 else torch.bfloat16, rows)

        def run():
            if int8:
                pf = tree_map(lambda w: w.to(torch.bfloat16) * (1 / 64.), params)
                y = forward(pf, x.to(torch.bfloat16) * (1.0 / 255.0))
                return "serve", torch.clamp(y * 255.0, 0, 255).to(torch.uint8)
            return "serve", forward(params, x)
        with torch.no_grad():
            return ST.run_counted(mi.mesh, (params, x), run), 52326 * 2 * n * 1024

    opt = O.lamb(3e-3)
    state = {"params": params, "opt": tree_map(lambda t: meta(t.shape, t.dtype, P()),
                                               opt.init(init_essr(cfg).tree()))}
    gb = max(256, n_chips)
    lr = meta((gb, 32, 32, 3), torch.bfloat16, rows)
    hr = meta((gb, 128, 128, 3), torch.bfloat16, rows)

    def step():
        from repro_torch.train.trainer import value_and_grad
        loss, grads = value_and_grad(lambda p: Ls.l1_loss(forward(p, lr), hr),
                                     state["params"])
        upd, opt_state = opt.update(grads, state["opt"], state["params"])
        O.apply_updates(state["params"], upd)
        return "train", (loss, opt_state)
    return ST.run_counted(mi.mesh, (state, lr, hr), step), 6 * 52326 * 256 * 1024


def apply_opts(cfg, opts: str):
    """§Perf iteration knobs, comma-separated (the reference's): token_shard,
    moe_shardmap (the explicit MoE of distributed/moe.py), mla_lazy, ssd, cf1
    (capacity factor 1.0), chunkN (ssm_chunk), attnchunkN (attn_chunk)."""
    for opt in [o for o in opts.split(",") if o]:
        if opt == "token_shard":
            cfg = dataclasses.replace(cfg, moe_dispatch_token_shard=True)
        elif opt == "moe_shardmap":
            cfg = dataclasses.replace(cfg, moe_impl="shard_map")
        elif opt == "mla_lazy":
            cfg = dataclasses.replace(cfg, mla_lazy_kv=True)
        elif opt == "ssd":
            cfg = dataclasses.replace(cfg, mamba2_impl="ssd")
        elif opt == "cf1":
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        elif opt.startswith("chunk"):
            cfg = dataclasses.replace(cfg, ssm_chunk=int(opt[5:]))
        elif opt.startswith("attnchunk"):
            cfg = dataclasses.replace(cfg, attn_chunk=int(opt[9:]))
        else:
            raise ValueError(f"unknown opt {opt}")
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, remat: bool = True,
             moment_dtype="float32", force: bool = False, out_dir: Optional[str] = None,
             tag: str = "", opts: str = "", cfg=None, shape=None, mesh_shape=None) -> dict:
    """One cell's record (cached in ``out_dir`` unless ``force``). ``cfg``,
    ``shape`` (a ShapeSpec named ``shape_name``) and ``mesh_shape`` (a
    (shape, axis names) pair) override the registry's config, the shape
    cell and the production mesh, for cut-down cells of the same arch; a
    failure is recorded as ``status: "fail"`` with its error."""
    out_dir = out_dir or os.path.abspath(RESULTS)
    os.makedirs(os.path.join(out_dir, mesh_kind), exist_ok=True)
    fname = os.path.join(out_dir, mesh_kind, f"{arch}__{shape_name}{tag}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag, "status": "ok"}
    t0 = time.time()
    try:
        dims, axes = mesh_shape or production_mesh_shape(multi_pod=(mesh_kind == "multi"))
        n_chips = math.prod(dims)
        with fake_world(n_chips):
            mesh = (make_test_mesh(dims, axes) if mesh_shape
                    else make_production_mesh(multi_pod=(mesh_kind == "multi")))
            mi = SH.mesh_info(mesh)
            if arch in ESSR_ARCHS:
                cell, mflops = _essr_lower(shape_name, mi, opts)
            else:
                cfg = apply_opts(cfg or get_config(arch), opts)
                shape = shape or {s.name: s for s in ALL_SHAPES}[shape_name]
                ok, reason = shape_applicable(cfg, shape)
                if not ok:
                    rec.update(status="skip", reason=reason)
                    _write(fname, rec)
                    return rec
                cell = ST.lower_cell(cfg, shape, mi, remat=remat,
                                     moment_dtype=getattr(torch, moment_dtype))
                mflops = RL.model_flops(cfg, shape, active_param_count_estimate(cfg))
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["mesh_shape"] = dict(zip(axes, dims))
        rec["memory_per_device"] = {
            "argument_bytes": cell.argument_bytes, "output_bytes": cell.output_bytes,
            "temp_bytes": cell.temp_bytes, "alias_bytes": 0,
            "total_gb": round((cell.argument_bytes + cell.temp_bytes) / 2**30, 3)}
        colls = dict(cell.collectives)
        rec["collectives_per_device_bytes"] = colls
        rec["collectives_by_axis"] = cell.collectives_by_axis
        rec["axis_link_bw"] = {a: RL.axis_link_bw(r) for a, r in cell.axis_ranks.items()}
        rec["top_collectives"] = cell.top_collectives
        rec["flops_by_op"] = cell.flops_by_op
        rec["bytes_accessed_per_device"] = cell.bytes_accessed
        coll_total = sum(v for k, v in colls.items() if k != "count")
        if arch in ESSR_ARCHS:
            flops_dev, bytes_dev = cell.flops, cell.bytes_accessed
        else:
            analytic = CM.cell_cost(cfg, shape, n_chips)
            rec["analytic_global"] = analytic.as_dict()
            # flops: the counted local matmuls (+ the analytic SSM scan,
            # elementwise, which they do not see); bytes: the analytic model
            flops_dev = cell.flops if cell.flops > 0 else analytic.flops_global / n_chips
            if cfg.family in ("ssm", "hybrid"):
                flops_dev = max(flops_dev, analytic.flops_global / n_chips)
            bytes_dev = analytic.hbm_bytes_global / n_chips
        rec["measured_dot_flops_per_device"] = cell.flops
        terms = RL.roofline(flops_dev, bytes_dev, coll_total, n_chips, mflops)
        terms = RL.with_collective_s(terms, RL.collective_seconds(cell.collectives_by_axis,
                                                                  cell.axis_ranks))
        rec["roofline"] = terms.as_dict()
        rec["n_chips"] = n_chips
    except Exception as e:                                    # noqa: BLE001
        rec.update(status="fail", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-2000:])
    rec["total_s"] = round(time.time() - t0, 2)
    _write(fname, rec)
    return rec


def _write(fname, rec):
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help=f"all | essr-x4 | {','.join(ARCH_NAMES)}")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--tag", default="", help="suffix for perf-iteration records")
    ap.add_argument("--opts", default="", help="see apply_opts")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    archs = list(ARCH_NAMES) + list(ESSR_ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failed = 0
    for mesh_kind in meshes:
        for arch in archs:
            shapes = (list(ESSR_SHAPES) if arch in ESSR_ARCHS
                      else [s.name for s in ALL_SHAPES])
            if args.shape != "all":
                shapes = [s for s in shapes if s in args.shape.split(",")]
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh_kind, force=args.force,
                               remat=args.remat == "true", moment_dtype=args.moment_dtype,
                               tag=args.tag, opts=args.opts, out_dir=args.out_dir)
                failed += rec["status"] == "fail"
                r = rec.get("roofline", {})
                print(f"[{mesh_kind}] {arch:24s} {shape_name:12s} {rec['status']:4s} "
                      f"lower={rec.get('lower_s', '-'):>7}s "
                      f"dom={r.get('dominant', '-'):10s} "
                      f"mem/dev={rec.get('memory_per_device', {}).get('total_gb', '-')}GB"
                      + (f"  {rec.get('error', '')[:160]}" if rec["status"] == "fail" else ""),
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
