"""The dry run's faults 7-9 (ROADMAP queue 3), each pinned.

Fault 7, the MoE's memory without token_shard on the production mesh
(16 x 16, train_4k): the explicit shard_map MoE (``--opts moe_shardmap``,
the reference's remedy, moe.py:1-17) against the einsum MoE, on a cut of
grok-1 (1 layer) and deepseek-v3 (4 layers, its first MoE layer among
them): one rank's peak temporaries and collective bytes.

Faults 8 and 9, dims that the model axis does not split evenly, against the
reference's compiled program: one rank's matmul FLOPs
of a one-layer SMOKE train step (batch 4 x 64) on a (data=1, model=4) mesh,
the port's ``lower_cell`` over a ``fake`` group against ``parse_dot_flops``
of the reference's program compiled for four host devices (a subprocess).

* qwen2 with its FULL config's 14 query heads (2 KV heads): 14 heads on 4
  ranks. The reference keeps the attention split (a quarter of the unsplit
  FLOPs a rank); the port splits its query rows and projections over the
  model axis (``attention.seq_parallel``), where it ran them whole on every
  rank (1.66x the reference's FLOPs).
* falcon-mamba's merged in_proj (D, 2 d_inner): its x/z halves split the
  model-sharded dim. The reference keeps d_inner split; the port reads each
  half on its own (``ssm._in_proj``), where it left d_inner whole on every
  rank (1.15x). On the production mesh one Mamba-1 layer also ran dt's
  up-projection and softplus backward whole (``ssm.mamba1_forward``).

Unsplit (a 1 x 1 mesh) the two count the same FLOPs."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.base import TRAIN_4K, ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.dryrun import apply_opts
from repro_torch.launch.mesh import fake_world, make_production_mesh, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CONFIGS = {"qwen2-14h": ("qwen2-0.5b", dict(n_layers=1, n_heads=14, n_kv_heads=2, head_dim=16,
                                             d_model=64, d_ff=128)),
           "falcon-mamba": ("falcon-mamba-7b", dict(n_layers=1))}
MESHES = ((1, 4), (1, 1))
SHAPE = ShapeSpec("train", 64, 4, "train")
#: port / reference per-rank dot FLOPs on (1, 4) (measured 1.000 and 1.018;
#: before the repairs 1.657 and 1.148)
BANDS = {"qwen2-14h": (0.95, 1.05), "falcon-mamba": (0.95, 1.05)}

REF = textwrap.dedent("""
    import dataclasses, json
    from repro.configs.base import ShapeSpec
    from repro.configs.registry import get_config
    from repro.distributed import sharding as SH
    from repro.launch import steps as ST
    from repro.launch.mesh import make_test_mesh
    from repro.launch.roofline import parse_dot_flops
    out = {}
    for name, (arch, over) in %r.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
        for mesh in %r:
            mi = SH.mesh_info(make_test_mesh(mesh, ("data", "model")))
            c = ST.lower_cell(cfg, ShapeSpec("train", 64, 4, "train"), mi,
                              remat=True).lowered.compile()
            out["%%s %%s" %% (name, mesh)] = parse_dot_flops(c.as_text())
    print(json.dumps(out))
""" % (CONFIGS, MESHES))


@pytest.fixture(scope="module")
def flops():
    """(port, reference): one rank's dot FLOPs by "name mesh"."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        port = {}
        for name, (arch, over) in CONFIGS.items():
            cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
            for mesh in MESHES:
                with fake_world(mesh[0] * mesh[1]):
                    mi = SH.mesh_info(make_test_mesh(mesh))
                    port[f"{name} {mesh}"] = ST.lower_cell(cfg, SHAPE, mi).flops
        torch.set_num_threads(n)
        out, err = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return port, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_uneven_dims_stay_split_like_the_reference(flops, name):
    port, ref = flops
    lo, hi = BANDS[name]
    ratio = port[f"{name} (1, 4)"] / ref[f"{name} (1, 4)"]
    assert lo <= ratio <= hi, ratio
    # a quarter of the unsplit step's FLOPs a rank, within the replicated
    # norms, embedding and loss
    assert port[f"{name} (1, 4)"] <= 0.3 * port[f"{name} (1, 1)"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unsplit_flops_equal_the_reference(flops, name):
    port, ref = flops
    assert abs(port[f"{name} (1, 1)"] / ref[f"{name} (1, 1)"] - 1) <= 0.002


#: fault 7's cuts: (arch, layers); one rank's peak temporaries measured
#: einsum / shard_map: grok-1 146.33 / 29.68 GiB, deepseek-v3 475.40 / 65.78
MOE_CUTS = (("grok-1-314b", 1), ("deepseek-v3-671b", 4))


@pytest.mark.parametrize("arch,layers", MOE_CUTS)
def test_moe_shardmap_brings_the_moe_memory_down(arch, layers):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cells = {}
    for opts in ("", "moe_shardmap"):
        cfg = apply_opts(dataclasses.replace(get_config(arch), n_layers=layers), opts)
        with fake_world(256):
            cells[opts] = ST.lower_cell(cfg, TRAIN_4K, SH.mesh_info(make_production_mesh()))
    torch.set_num_threads(n)
    es, sm = cells[""], cells["moe_shardmap"]

    def moved(c):
        return sum(v for k, v in c.collectives.items() if k != "count")
    assert sm.argument_bytes == es.argument_bytes
    assert sm.temp_bytes <= 0.25 * es.temp_bytes, (sm.temp_bytes, es.temp_bytes)
    assert moved(sm) <= 0.2 * moved(es), (sm.collectives, es.collectives)


def test_mamba1_layer_stays_split_on_the_production_mesh():
    """falcon-mamba FULL, one layer, 256 x 512 tokens on (data=16, model=16):
    one rank's peak temporaries 7.04 GiB, of which the loss over the 65,024
    vocab takes 6.98 (the same cell without its layer); before the repairs
    25.46 GiB, a (256, 512, 8192) fp32 softplus backward whole on every rank."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=1)
    with fake_world(256):
        cell = ST.lower_cell(cfg, ShapeSpec("t", 512, 256, "train"),
                             SH.mesh_info(make_production_mesh()))
    torch.set_num_threads(n)
    assert cell.temp_bytes < 8 * 2 ** 30, cell.temp_bytes / 2 ** 30
