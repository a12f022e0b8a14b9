"""The port's quantized megakernel (``essr_forward_qmegakernel``,
``ExecutionPlan(quant=..., fusion="group")``) and edge-score kernel
(``kernels/edge.py``) against ``repro.kernels.megakernel``,
``repro.kernels.qconv``, ``repro.kernels.ops`` and the port's own layer
chain, on the CPU (the wrappers take their plain versions there).

Contracts, and why:
  * the port's qmega codes are integers computed op by op, so they are held
    bit for bit (``np.array_equal``) to the JAX ``essr_forward_qref`` run
    eagerly (``jax.disable_jit``), in every case;
  * and to the JAX ``essr_forward_qmegakernel`` (Pallas interpret, under
    jit) in every case but fxp10 at width 4, where XLA contracts a mul + add
    into an FMA and flips codes of its own eager run (ROADMAP queue 3): there
    the test asserts that the two differ;
  * qmega is ``torch.equal`` to the port's layer chain
    (``essr_forward_qkernels``), alone and inside the engine;
  * the edge kernel's plain path is held to the JAX kernel at its own test's
    tolerance, rtol 1e-4 / atol 1e-3 (tests/test_kernels.py:66).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import megakernel as jmk
from repro.kernels import ops as jops
from repro.kernels import qconv as jq
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core import pipeline
from repro_torch.kernels import _build, ops
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import qconv as tq
from repro_torch.kernels.edge import edge_score_fused
from test_torch_quant import JTOY, TOY, X2, _port_pack, _trees, golden  # noqa: F401

GOLDEN_COUNTS = (10, 2, 13)
EDGE_SHAPES = [(4, 8, 8), (8, 16, 16), (2, 34, 34)]   # tests/test_kernels.py:12


@pytest.fixture(scope="module")
def qtoy():
    tree, params = _trees(JTOY, TOY)
    x = np.random.default_rng(0).random((7, 12, 12, 3), dtype=np.float32)
    from repro.quant import pams as jp
    packs = {m: jp.build_quant_pack(tree, JTOY, m, jnp.asarray(x)) for m in ("int8", "fxp10")}
    return tree, params, x, packs


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n", [1, 5, 7])
def test_qmega_matches_jax_reference_and_pallas(qtoy, mode, width, n):
    tree, params, x, packs = qtoy
    pack, xb = packs[mode], x[:n]
    with torch.no_grad():
        got = mk.essr_forward_qmegakernel(params, torch.from_numpy(xb), TOY, width,
                                          pack=_port_pack(pack)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jq.essr_forward_qref(tree, jnp.asarray(xb), JTOY, width, pack=pack))
    np.testing.assert_array_equal(got, eager)
    pallas = np.asarray(jmk.essr_forward_qmegakernel(tree, jnp.asarray(xb), JTOY, width,
                                                     pack=pack, interpret=True))
    if (mode, width) == ("fxp10", 4):
        # the jit'd Pallas chain contracts mul + add into FMAs and flips codes
        # of its own eager run here (ROADMAP queue 3); the port is op by op
        assert not np.array_equal(got, pallas)
        assert np.abs(got - pallas).max() <= 1e-2
    else:
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("width", [4, 8])
def test_qmega_equals_layer_chain_and_plain_codes(qtoy, mode, width):
    _, params, x, packs = qtoy
    pack = _port_pack(packs[mode])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        group = mk.essr_forward_qmegakernel(params, xt, TOY, width, pack=pack)
        layer = tq.essr_forward_qkernels(params, xt, TOY, width, pack=pack)
        _, codes = tq.essr_forward_qref(params, xt, TOY, width, pack=pack, return_codes=True)
        q, _ = tq.prepare_qparams(params, TOY, width, pack)
        wbuf = mk.pack_qweights(q, pack.bits)
        recon = mk.qmega_fused(xt, wbuf, q["consts"], width=width, n_sfb=TOY.n_sfb,
                               out_channels=TOY.out_channels, bits=pack.bits)
    assert torch.equal(group, layer)
    assert recon.dtype == codes["recon"].dtype and torch.equal(recon, codes["recon"])


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
def test_pack_unpack_round_trip_and_cache(qtoy, mode):
    _, params, x, packs = qtoy
    pack = _port_pack(packs[mode])
    q, _ = tq.prepare_qparams(params, TOY, 8, pack)
    wbuf = mk.pack_qweights(q, pack.bits)
    lay = mk.QWeightLayout(3, 8, TOY.out_channels, TOY.n_sfb, 1 if pack.bits <= 8 else 4)
    assert wbuf.dtype == torch.uint8 and wbuf.numel() == lay.size and lay.first % 16 == 0
    assert lay.sfb % 16 == 0 and lay.recon % 16 == 0
    back = mk.unpack_qweights(wbuf, lay)
    for grp in ("first", "recon"):
        assert set(back[grp]) == set(k for k in q[grp] if k != "qc")
        for k, v in back[grp].items():
            assert v.dtype == q[grp][k].dtype and torch.equal(v, q[grp][k]), (grp, k)
    for mine, theirs in zip(back["sfbs"], q["sfbs"]):
        for k, v in mine.items():
            assert v.dtype == theirs[k].dtype and torch.equal(v, theirs[k]), k
    mk.packed_qweights.cache_clear()
    with torch.no_grad():
        a = mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, 8, pack=pack)
        mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, 8, pack=pack)
        assert mk.packed_qweights.cache_info().hits == 1
        params["recon"]["pw_b"].add_(1.0)            # an in-place edit is a new key
        b = mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, 8, pack=pack)
        params["recon"]["pw_b"].sub_(1.0)
    assert mk.packed_qweights.cache_info().misses == 2 and not torch.equal(a, b)


def test_qmega_empty_bucket_width_checks_and_launches(qtoy):
    _, params, x, packs = qtoy
    pack = _port_pack(packs["int8"])
    ops.reset_launch_counts()
    with torch.no_grad():
        out = mk.essr_forward_qmegakernel(params, torch.zeros((0, 12, 12, 3)), TOY, 8, pack=pack)
        assert tuple(out.shape) == (0, 24, 24, 3)
        mk.essr_forward_qmegakernel(params, torch.from_numpy(x[:2]), TOY, 4, pack=pack)
        with pytest.raises(ValueError, match="bilinear"):
            mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, 0, pack=pack)
        with pytest.raises(ValueError, match="outside 1..8"):
            mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, 16, pack=pack)
        q, _ = tq.prepare_qparams(params, TOY, 8, pack)
        wbuf = mk.pack_qweights(q, pack.bits)
        kw = dict(width=8, n_sfb=TOY.n_sfb, out_channels=TOY.out_channels, bits=pack.bits)
        xt = torch.from_numpy(x)
        assert tuple(mk.qmega_fused(xt[:0], wbuf, q["consts"], **kw).shape) == (0, 12, 12, 12)
        with pytest.raises(ValueError, match="wbuf shape"):
            mk.qmega_fused(xt, wbuf[:-16], q["consts"], **kw)
        with pytest.raises(TypeError, match="wbuf must be uint8"):
            mk.qmega_fused(xt, wbuf.view(torch.int8), q["consts"], **kw)
        with pytest.raises(ValueError, match="qc shape"):
            mk.qmega_fused(xt, wbuf, q["consts"][:-2], **kw)
        with pytest.raises(ValueError, match="1..64"):
            mk.qmega_fused(xt, wbuf, q["consts"], **{**kw, "width": 72})
        edge_score_fused(xt)
    counts = ops.launch_counts()
    assert counts["qmega"] == 0 and counts["edge"] == 0 and set(counts.values()) == {0}


@pytest.mark.parametrize("width", [27, 54])
@pytest.mark.parametrize("bits", [8, 10])
def test_qgroup_report_fits_and_raises(width, bits):
    rep = mk.qgroup_report(width, 32, 4, 5, bits)
    assert rep["rows_per_cta"] == 4 and rep["cluster"] == 8
    assert rep["smem_bytes"] <= rep["smem_limit"] == 232_448 and rep["bound"] == "operations"
    cb, cp = (1 if bits <= 8 else 4), -(-width // 4) * 4
    lay = mk.QWeightLayout(3, width, 48, 5, cb)
    assert rep["smem_bytes"] == 2 * 4 * 6 * 32 * cp + lay.stage + cb * 128 * 3 * cp
    assert rep["int_ops_per_patch"] == 2 * 1024 * (3 * width + 20 * width * width + 9 * width)
    with pytest.raises(ValueError, match="232448 B"):
        mk.qgroup_report(width, 96, 4, 5, bits)
    with pytest.raises(ValueError, match="positive"):
        mk.qgroup_report(0, 32, 4, 5, bits)


def test_qmega_sizes_at_full_width():
    assert mk.qgroup_report(54, 32, 4, 5, 10)["smem_bytes"] == 215_712
    assert mk.qgroup_report(54, 32, 4, 5, 8)["smem_bytes"] == 122_976


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
def test_group_engine_golden_frame_equals_layer_engine(golden, mode):  # noqa: F811
    tree, frame, fp = golden
    layer = SREngine.from_params(tree, X2, plan=ExecutionPlan(quant=mode), device="cpu")
    group = SREngine.from_params(tree, X2, plan=ExecutionPlan(quant=mode, fusion="group"),
                                 device="cpu")
    assert group.qpack == layer.qpack
    a, b = layer.upscale(frame), group.upscale(frame)
    assert b.backend == f"cuda-plain-{mode}" and b.counts == GOLDEN_COUNTS
    np.testing.assert_array_equal(b.ids, fp.ids)
    assert torch.equal(a.image, b.image)
    assert group.plan.fusion == "group" and group.plan.quant == mode and group.summary() == {}


def test_resolve_forward_serves_quant_group():
    fwd = pipeline.resolve_forward("cuda", object(), "group")
    assert fwd.func is pipeline._forward_width_quant_mega
    assert pipeline.resolve_forward("cuda", object(), "layer").func is \
        pipeline._forward_width_quant_cuda
    assert pipeline.resolve_forward("ref", object(), "group").func is \
        pipeline._forward_width_quant_ref


@pytest.mark.parametrize("n,h,w", EDGE_SHAPES)
def test_edge_score_matches_jax_kernel(n, h, w):
    x = np.random.default_rng(n + h).random((n, h, w, 3), dtype=np.float32)
    want = np.asarray(jops.edge_score_fused(jnp.asarray(x), block_patches=2))
    got = edge_score_fused(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_edge_score_empty_and_checks():
    assert tuple(edge_score_fused(torch.zeros((0, 32, 32, 3))).shape) == (0,)
    with pytest.raises(ValueError, match="no interior"):
        edge_score_fused(torch.zeros((2, 2, 8, 3)))
    with pytest.raises(ValueError, match="RGB"):
        edge_score_fused(torch.zeros((2, 8, 8, 4)))
    with pytest.raises(TypeError, match="float32"):
        edge_score_fused(torch.zeros((2, 8, 8, 3), dtype=torch.float64))


def test_build_keys_of_the_new_kernels():
    keys = {n: _build.source_key(n) for n in ("qmega", "edge", "qconv", "mega")}
    assert len(set(keys.values())) == 4
    src = (_build.CSRC / "qmega.cu").read_text()
    assert '#include "qmath.cuh"' in src and 'extern "C" int qmega_forward(' in src
    assert '#include "cluster.cuh"' in src
    assert 'extern "C" int edge_forward(' in (_build.CSRC / "edge.cu").read_text()
