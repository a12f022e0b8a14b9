"""The dry run's lowering on the (2, 2) test mesh against the reference's
compiled cells (``tests/test_roofline_distributed.py::test_mini_dryrun_on_test_mesh``'s
granite-8b SMOKE at batch 4 x 64): one rank's argument bytes, FLOPs and
collectives; the token-sharded MoE's collective mix; ``run_cell``'s records,
its cache and its failures; ``report.py``'s tables; and the collective term
priced per mesh axis. The reference compiles in a subprocess with four
host devices, started first so that it runs beside the port's cells."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as R
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import fake_world, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KINDS = ("train", "prefill", "decode")
SHAPES = {k: ShapeSpec(k, 64, 4, k) for k in KINDS}

REF = textwrap.dedent("""
    import json
    from repro.configs.base import ShapeSpec
    from repro.configs.registry import get_config
    from repro.distributed import sharding as SH
    from repro.launch import steps as ST
    from repro.launch.mesh import make_test_mesh
    from repro.launch.roofline import parse_collective_bytes, parse_dot_flops
    mi = SH.mesh_info(make_test_mesh((2, 2), ("data", "model")))
    cfg = get_config("granite-8b", smoke=True)
    out = {}
    for kind in ("train", "prefill", "decode"):
        c = ST.lower_cell(cfg, ShapeSpec(kind, 64, 4, kind), mi, remat=True).lowered.compile()
        txt = c.as_text()
        out[kind] = {"argument_bytes": int(c.memory_analysis().argument_size_in_bytes),
                     "dot_flops": parse_dot_flops(txt), "colls": parse_collective_bytes(txt)}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def reference():
    """A callable that returns the reference's compiled cells (the
    subprocess starts with the module's first test)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    got = {}

    def result():
        if not got:
            out, err = proc.communicate(timeout=420)
            assert proc.returncode == 0, err[-3000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def cells(reference):
    """granite-8b SMOKE's three cells, one rank of the (2, 2) test mesh."""
    cfg = get_config("granite-8b", smoke=True)
    with fake_world(4):
        mi = SH.mesh_info(make_test_mesh((2, 2)))
        return {k: ST.lower_cell(cfg, SHAPES[k], mi) for k in KINDS}


def _int64_excess(kind: str) -> int:
    """The port's tokens are int64, the reference's int32 (4 bytes more an
    element of one rank's tokens and labels); its decode ``pos`` is an int,
    where the reference passes a () int32 argument."""
    b_local = SHAPES[kind].global_batch // 2
    if kind == "train":
        return 2 * b_local * 64 * 4
    if kind == "prefill":
        return b_local * 64 * 4
    return b_local * 1 * 4 - 4


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_equal_reference(cells, reference, kind):
    assert cells[kind].argument_bytes - _int64_excess(kind) == \
        reference()[kind]["argument_bytes"]


#: port / reference dot FLOPs of one rank, by kind (measured 1.000, 0.791, 1.133)
FLOP_BANDS = {"train": (0.99, 1.01), "prefill": (0.75, 0.85), "decode": (1.05, 1.2)}


@pytest.mark.parametrize("kind", KINDS)
def test_flops_stand_against_reference(cells, reference, kind):
    """One rank's counted matmul FLOPs against ``parse_dot_flops`` of the
    reference's compiled program. Unsharded (a 1 x 1 mesh) the two agree
    within 0.6% in all three kinds; on (2, 2) each side divides the work its
    own way. Train: within 1%. Prefill (0.791): the reference recomputes
    every layer's Q, K and V from its input for the cache
    (``_prefill_layer_cache``), where the port keeps the attention's own K/V
    and splits its matmuls a quarter a rank. Decode (1.13): DTensor places
    each op on its own, and the first layer's gate and up projections
    (``ffn.mlp``) run whole on each model rank, since the token's activation
    reaches them replicated."""
    lo, hi = FLOP_BANDS[kind]
    ratio = cells[kind].flops / reference()[kind]["dot_flops"]
    assert lo <= ratio <= hi, ratio


def test_collectives_on_the_test_mesh(cells, reference):
    """Every cell moves bytes over both axes, as the reference's programs
    do; the train step's gradients leave as reduce-scatters (ZeRO), each
    put back on its parameter's placement."""
    for kind in KINDS:
        c = cells[kind]
        assert c.collectives["count"] > 0 and reference()[kind]["colls"]["count"] > 0
        assert sum(v for k, v in c.collectives.items() if k != "count") > 0
        assert set(c.collectives_by_axis) <= {"data", "model", "data+model"}
    assert cells["train"].collectives["reduce-scatter"] > 0
    assert cells["train"].argument_bytes > 0 and cells["train"].temp_bytes > 0


def test_one_rank_moves_nothing():
    """On a 1 x 1 mesh nothing is sharded and no collective runs."""
    with fake_world(1):
        mi = SH.mesh_info(make_test_mesh((1, 1)))
        c = ST.lower_cell(get_config("granite-8b", smoke=True), SHAPES["decode"], mi)
    assert c.collectives["count"] == 0 and c.collectives_by_axis == {}
    assert c.flops > 0


def test_token_shard_changes_the_collective_mix():
    """deepseek-v3 SMOKE's prefill with the MoE's capacity dim sharded over
    dp (the reference's §Perf G1/D2) against the knob off: the constraints
    move different bytes over different axes."""
    cfg = get_config("deepseek-v3-671b", smoke=True)
    on = D.apply_opts(cfg, "token_shard")
    with fake_world(4):
        mi = SH.mesh_info(make_test_mesh((2, 2)))
        off_c = ST.lower_cell(cfg, SHAPES["prefill"], mi)
        on_c = ST.lower_cell(on, SHAPES["prefill"], mi)
    assert on_c.collectives != off_c.collectives
    assert on_c.collectives_by_axis != off_c.collectives_by_axis
    assert on_c.flops > 0 and off_c.flops > 0


@pytest.mark.parametrize("mode", ["ep_alltoall", "expert_tp"])
def test_moe_shardmap_cell_counts_its_explicit_collectives(mode):
    """deepseek-v3 SMOKE's train step under ``--opts moe_shardmap`` on the
    (2, 2) test mesh against the einsum MoE's: expert parallelism's
    exchanges are all-to-alls over the model axis, the forward's at the MoE's
    call site (the einsum form moves none: on a CPU mesh DTensor changes shard dims by
    all-gathers), expert-TP moves no all-to-all and a different mix."""
    import dataclasses
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True), moe_mode=mode)
    with fake_world(4):
        mi = SH.mesh_info(make_test_mesh((2, 2)))
        off = ST.lower_cell(cfg, SHAPES["train"], mi)
        on = ST.lower_cell(D.apply_opts(cfg, "moe_shardmap"), SHAPES["train"], mi)
    assert off.collectives["all-to-all"] == 0
    assert on.collectives != off.collectives and on.flops > 0
    if mode == "ep_alltoall":
        assert on.collectives["all-to-all"] > 0
        rows = [r for r in on.top_collectives if r["op"] == "all-to-all"]
        assert rows and all(r["axis"] == "model" for r in rows), rows
        assert any("moe_forward" in r["op_name"] for r in rows), rows
    else:
        assert on.collectives["all-to-all"] == 0


def test_gradient_goes_back_to_its_parameters_placement():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with fake_world(4):
        mesh = make_test_mesh()
        p = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh, (Shard(0), Shard(1)),
                               run_check=False)
        g = DTensor.from_local(torch.empty(8, 8, device="meta"), mesh, (Partial(), Shard(1)),
                               run_check=False)
        assert tuple(SH.like(g, p).placements) == (Shard(0), Shard(1))
        r = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                               (Replicate(), Replicate()), run_check=False)
        assert SH.like(p, p) is p and SH.like(torch.ones(2), p).shape == (2,)
        assert tuple(SH.like(r, p).placements) == (Shard(0), Shard(1))


# ---------------------------------------------------------------------------
# run_cell, its records and the report
# ---------------------------------------------------------------------------

SMOKE_MESH = ((2, 2), ("data", "model"))


def test_run_cell_records_caches_and_fails(tmp_path):
    cfg = get_config("granite-8b", smoke=True)
    rec = D.run_cell("granite-8b", "decode_32k", "single", out_dir=str(tmp_path), cfg=cfg,
                     mesh_shape=SMOKE_MESH)
    assert rec["status"] == "ok", rec.get("error")
    for key in ("memory_per_device", "collectives_per_device_bytes", "collectives_by_axis",
                "analytic_global", "roofline", "n_chips", "measured_dot_flops_per_device",
                "top_collectives", "lower_s", "total_s"):
        assert key in rec
    assert rec["n_chips"] == 4 and rec["mesh_shape"] == {"data": 2, "model": 2}
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] > 0 and mem["total_gb"] >= 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant"}
    assert rec["roofline"]["collective_s"] == pytest.approx(
        sum(b / RL.ICI_BW for b in rec["collectives_by_axis"].values()))
    fname = tmp_path / "single" / "granite-8b__decode_32k.json"
    assert json.loads(fname.read_text()) == rec
    fname.write_text(json.dumps(dict(rec, cached=True)))
    assert D.run_cell("granite-8b", "decode_32k", "single", out_dir=str(tmp_path))["cached"]
    again = D.run_cell("granite-8b", "decode_32k", "single", out_dir=str(tmp_path), cfg=cfg,
                       mesh_shape=SMOKE_MESH, force=True)
    assert "cached" not in again and again["status"] == "ok"

    bad = D.run_cell("granite-8b", "decode_32k", "single", out_dir=str(tmp_path), cfg=cfg,
                     mesh_shape=SMOKE_MESH, tag="_bad", opts="bogus")
    assert bad["status"] == "fail" and "unknown opt bogus" in bad["error"]
    skip = D.run_cell("granite-8b", "long_500k", "single", out_dir=str(tmp_path), cfg=cfg,
                      mesh_shape=SMOKE_MESH)
    assert skip["status"] == "skip"
    assert not dist.is_initialized()

    table = R.dryrun_table("single", results=str(tmp_path))
    assert "| granite-8b | decode_32k | ok |" in table
    assert "| granite-8b | long_500k | **skip**" in table
    roof = R.roofline_table("single", results=str(tmp_path))
    assert "| granite-8b | decode_32k |" in roof and "long_500k" not in roof
    perf = R.perf_table("granite-8b", "decode_32k", results=str(tmp_path))
    assert "| baseline |" in perf and "_bad" not in perf
    assert [d["shape"] for d in R.load("single", results=str(tmp_path))] == [
        "decode_32k", "long_500k"]


def test_cli_runs_the_essr_cell_without_a_card(tmp_path, capsys):
    assert D.main(["--arch", "essr-x4", "--shape", "serve_8k", "--mesh", "single",
                   "--out-dir", str(tmp_path)]) == 0
    assert "essr-x4" in capsys.readouterr().out
    rec = json.loads((tmp_path / "single" / "essr-x4__serve_8k.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["collectives_per_device_bytes"]["count"] == 0       # patches never meet
    assert rec["memory_per_device"]["argument_bytes"] == 53886 * 2 + 9 * 32 * 32 * 3 * 2
    assert D.main(["--arch", "granite-8b", "--shape", "train_4k", "--mesh", "single",
                   "--out-dir", str(tmp_path), "--opts", "bogus"]) == 1


# ---------------------------------------------------------------------------
# the collective term, per mesh axis
# ---------------------------------------------------------------------------

def test_collective_term_prices_each_axis_at_its_link():
    """An axis whose ranks sit in one 8-card node runs on NVLink; one that
    spans nodes (every 16-rank axis of the production mesh) on InfiniBand."""
    assert RL.axis_link_bw(range(8)) == RL.ICI_BW == 450e9
    assert RL.axis_link_bw(range(16)) == RL.IB_BW == 50e9
    assert RL.axis_link_bw(range(0, 256, 16)) == RL.IB_BW
    assert RL.axis_link_bw((8, 12)) == RL.ICI_BW
    by_axis = {"model": 450e9, "data": 50e9}
    ranks = {"model": tuple(range(4)), "data": (0, 16)}
    assert RL.collective_seconds(by_axis, ranks) == pytest.approx(2.0)
    terms = RL.roofline(1e12, 1e9, 500e9, 4, 2e12)
    assert terms.collective_s == pytest.approx(500e9 / RL.ICI_BW)
    priced = RL.with_collective_s(terms, 2.0)
    assert priced.collective_s == 2.0 and priced.dominant == "collective"
    assert priced.compute_s == terms.compute_s and priced.memory_s == terms.memory_s
    assert RL.with_collective_s(terms, 0.0).dominant == "compute"
