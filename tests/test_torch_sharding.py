"""The sharding rules against the reference's, leaf for leaf: every
``ARCH_NAMES`` config's parameter specs on both production meshes, the cache
specs of ``tests/test_sharding_rules.py``'s cells, the batch specs, and the
activation specs of the four constrain sites; then the same divisibility
checks on the port's DTensor placements, over meshes of a ``fake`` process
group that no test leaves behind."""
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.configs.base import shape_applicable
from repro.configs.registry import get_config as jget_config
from repro.distributed import ctx as JCTX
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.ctx import P, ShardCtx, constrain, use_ctx
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (fake_world, make_production_mesh, make_test_mesh,
                                     production_mesh_shape)


class _FakeMesh:
    """Quacks like a Mesh for the reference's spec generation (shape +
    axis_names only), as ``tests/test_sharding_rules.py`` does."""

    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


def _ref_mi(multi):
    dims, axes = production_mesh_shape(multi_pod=multi)
    shape = dict(zip(axes, dims))
    return JSH.MeshInfo(_FakeMesh(shape), tuple(a for a in shape if a != "model"), "model")


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


@pytest.fixture(scope="module", params=[False, True], ids=["single", "multi"])
def prod(request):
    """The multi-pod production mesh or the single one (each test opens its
    own fake group)."""
    return request.param


def _with_mesh(multi):
    dims, _ = production_mesh_shape(multi_pod=multi)
    world = fake_world(math.prod(dims))
    world.__enter__()
    return world, SH.mesh_info(make_production_mesh(multi_pod=multi))


def _ref_leaves(tree):
    """{path: tuple(spec)} of a reference spec tree (``P`` leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for path, spec in flat:
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(names)] = tuple(spec)
    return out


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, path + (i,)))
        return out
    return {path: tree}


def _flat_entries(spec):
    """The reference's spec with a data tuple nested in an entry flattened
    (JAX refuses a nested tuple in a PartitionSpec; the port flattens it)."""
    def flat(e):
        if isinstance(e, tuple):
            return tuple(n for x in e for n in (flat(x) if isinstance(x, tuple) else (x,)))
        return e
    return tuple(flat(e) for e in spec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference(arch, prod):
    """Per-layer leaves (``layers/<i>/...``) take the reference's stacked
    spec without its leading None; every other leaf its spec as it is."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = _ref_leaves(JSH.param_specs(JST.abstract_params(jcfg), jcfg, _ref_mi(prod)))
    world, mi = _with_mesh(prod)
    try:
        params = ST.abstract_params(cfg).tree()
        got = _port_leaves(SH.param_specs(params, cfg, mi))
        shapes = _port_leaves(params)
        seen = set()
        for path, spec in got.items():
            stacked = path[0] in SH.STACKED
            key = "/".join(str(n) for j, n in enumerate(path) if not (stacked and j == 1))
            ref = want[key]
            if stacked:
                assert ref[0] is None
            assert spec.entries == (ref[1:] if stacked else ref), (path, spec, ref)
            seen.add(key)
            _check_divides(shapes[path], spec, mi)
        assert seen == set(want)
    finally:
        world.__exit__(None, None, None)


def _check_divides(t, spec, mi):
    """The placements of ``spec`` split ``t`` into whole, equal shards."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    placements = mi.placements(spec)
    local, _ = compute_local_shape_and_global_offset(tuple(t.shape), mi.mesh, placements)
    assert tuple(local) == SH.local_shape(t.shape, spec, mi.mesh)
    sizes = mi.sizes
    for dim, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        assert local[dim] * math.prod(sizes[n] for n in names) == t.shape[dim]


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_reference(arch, shape_name, prod, monkeypatch):
    """The cells of ``tests/test_sharding_rules.py``, on both meshes. On the
    multi-pod mesh a batch of 1 puts ``(("pod", "data"), "model")`` on the
    sequence, which JAX 0.9 refuses as a nested tuple: the reference side
    builds its spec with the tuple flattened, as the port's does."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    jshape = {s.name: s for s in J_SHAPES}[shape_name]
    if not shape_applicable(jcfg, jshape)[0]:
        pytest.skip("skip cell")
    monkeypatch.setattr(JSH, "P", lambda *e: JP(*_flat_entries(e)))
    want = _ref_leaves(JSH.cache_specs(JST.abstract_caches(jcfg, jshape), jcfg, _ref_mi(prod),
                                       jshape.global_batch))
    world, mi = _with_mesh(prod)
    try:
        caches = ST.abstract_caches(cfg, shape)
        got = _port_leaves(SH.cache_specs(caches, cfg, mi, shape.global_batch))
        shapes = _port_leaves(caches)
        assert {"/".join(map(str, k)) for k in got} == set(want)
        for path, spec in got.items():
            assert spec.entries == want["/".join(map(str, path))], path
            _check_divides(shapes[path], spec, mi)
    finally:
        world.__exit__(None, None, None)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_specs_equal_reference(arch, prod):
    cfg, jcfg = get_config(arch), jget_config(arch)
    world, mi = _with_mesh(prod)
    try:
        for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
            for port_b, ref_b in ((ST.train_batch_abstract, JST.train_batch_abstract),
                                  (ST.decode_batch_abstract, JST.decode_batch_abstract)):
                batch = port_b(cfg, shape)
                want = _ref_leaves(JSH.batch_specs(ref_b(jcfg, jshape), _ref_mi(prod)))
                got = _port_leaves(SH.batch_specs(batch, mi))
                assert {"/".join(map(str, k)) for k in got} == set(want)
                for path, spec in got.items():
                    assert spec.entries == want["/".join(map(str, path))], (shape.name, path)
                    _check_divides(_port_leaves(batch)[path], spec, mi)
    finally:
        world.__exit__(None, None, None)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-0.5b", "grok-1-314b", "deepseek-v3-671b",
                                  "zamba2-1.2b"])
def test_constrain_site_specs_equal_reference(arch, prod):
    """``ShardCtx.spec`` at the shapes of the four constrain sites (the
    layer input and output, the loss's hidden states, the MoE dispatch
    buffer and its hidden) equals the reference's, knob on and off."""
    from repro_torch.models.lm.ffn import moe_capacity
    cfg = get_config(arch)
    shape = {s.name: s for s in ALL_SHAPES}["train_4k"]
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    rmi = _ref_mi(prod)
    ref = JCTX.ShardCtx(rmi.mesh, rmi.dp, rmi.mp)
    port = ShardCtx(_FakeMesh(rmi.mesh.shape), rmi.dp, rmi.mp)
    seq_mp = None if cfg.family in ("ssm", "hybrid") else "mp"
    sites = [((b, s, d), ("dp", seq_mp, None)), ((b, s, d), ("dp", None, None)),
             ((1, 7, d), ("dp", "mp", None))]
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        cap = moe_capacity(b * s, cfg)
        ep = "mp" if cfg.moe_mode == "ep_alltoall" else None
        sites += [((e, cap, d), (ep, None, None)), ((e, cap, d), (ep, "dp", None)),
                  ((e, cap, f), (ep, "dp", "mp" if ep is None else None))]
    for x_shape, axes in sites:
        assert port.spec(x_shape, axes).entries == tuple(ref.spec(x_shape, axes)), (x_shape, axes)


def test_to_placements_orders_axes_like_the_mesh():
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(8):
        mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
        assert SH.to_placements(P(("pod", "data", "model"), None), mesh) == (Shard(0),) * 3
        assert SH.to_placements(P(None, "model", ("pod", "data")), mesh) == (
            Shard(2), Shard(2), Shard(1))
        assert SH.to_placements(P(None, None), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="out of the mesh's order"):
            SH.to_placements(P(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="shards two dims"):
            SH.to_placements(P("data", "data"), mesh)


def test_constrain_redistributes_only_a_dtensor_under_a_context():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.ones(4, 8)
    assert constrain(x, "dp", None) is x                       # no context
    with fake_world(4):
        mi = SH.mesh_info(make_test_mesh())
        with use_ctx(mi.ctx()):
            assert constrain(x, "dp", None) is x                # a plain tensor
            dx = DTensor.from_local(torch.empty(4, 8, device="meta"), mi.mesh,
                                    (Replicate(), Replicate()), run_check=False)
            y = constrain(dx, "dp", "mp")
            assert tuple(y.placements) == (Shard(0), Shard(1))
            z = constrain(y, None, None)
            assert tuple(z.placements) == (Replicate(), Replicate())
            odd = DTensor.from_local(torch.empty(3, 8, device="meta"), mi.mesh,
                                     (Replicate(), Replicate()), run_check=False)
            assert tuple(constrain(odd, "dp", None).placements) == (Replicate(), Replicate())


def test_fake_world_leaves_no_group_and_refuses_to_stack():
    with fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_world(2):
                pass
        with pytest.raises(RuntimeError, match="needs a process group of 256"):
            make_production_mesh()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake_world"):
        make_test_mesh()
