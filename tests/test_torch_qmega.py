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
from repro_torch.kernels import _build, ops, ref
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
def test_qmega_windows_through_the_plain_version_equal_the_whole_patch(qtoy, mode):
    """Split-and-stitch of the integer chain at C8, 2 SFBs (r = 6), a 40x40
    patch in 3 x 3 windows of 22: the stitched qmega_ref codes are
    torch.equal to the whole patch's."""
    _, params, _, packs = qtoy
    pack = _port_pack(packs[mode])
    q, _ = tq.prepare_qparams(params, TOY, 8, pack)
    x = torch.from_numpy(np.random.default_rng(6).random((2, 40, 40, 3), dtype=np.float32))
    plan = mk.window_plan(40, 40, mk.receptive_radius(TOY.n_sfb), 24, lambda a, b: True)
    dtype = torch.int8 if pack.bits <= 8 else torch.int32
    with torch.no_grad():
        whole = ref.qmega_ref(x, q, q["consts"], dtype)
        got = mk.run_windowed(lambda xs: ref.qmega_ref(xs, q, q["consts"], dtype), x, plan)
    assert got.dtype == dtype and torch.equal(got, whole) and whole.abs().max().item() > 0


def _extreme_q(c: int, bits: int, cin: int = 3, cout: int = 12, n_sfb: int = 2, seed: int = 0):
    """Prepared integer operands at width ``c`` (the shapes of
    `prepare_qparams`), every code weight at +-qmax, fp operands random."""
    g = torch.Generator().manual_seed(seed + c + bits)
    qmax, dt = (127, torch.int8) if bits <= 8 else (511, torch.int32)

    def codes(*shape):
        return ((torch.randint(0, 2, shape, generator=g) * 2 - 1) * qmax).to(dt)

    def f(*shape):
        return torch.randn(shape, generator=g)

    def bs(k, pre=""):
        return {f"{pre}pwq": codes(k, c), f"{pre}pw_scale": f(c), f"{pre}pwb": f(c),
                f"{pre}dw_fq": f(3, 3, c), f"{pre}dwb": f(c)}

    sfbs = [{**bs(c, "b1_"), **bs(c, "b2_"), "fuseq": codes(c, c), "fuse_scale_y": f(c),
             "fuse_scale_x": f(c), "fuseb": f(c)} for _ in range(n_sfb)]
    recon = {"dwq": codes(3, 3, c).to(torch.int32), "dw_scale": f(c), "dwb": f(c),
             "pw_fq": f(c, cout), "pwb": f(cout)}
    return {"first": bs(cin), "sfbs": sfbs, "recon": recon}


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("width", [4, 8, 27, 54])
def test_pack_unpack_round_trip_and_cache(qtoy, mode, width):
    _, params, x, packs = qtoy
    pack = _port_pack(packs[mode])
    if width <= TOY.channels:       # the toy model's operands; wider: codes at +-qmax
        q, _ = tq.prepare_qparams(params, TOY, width, pack)
        lay = mk.QWeightLayout(3, width, TOY.out_channels, TOY.n_sfb, pack.bits)
    else:
        q = _extreme_q(width, pack.bits)
        lay = mk.QWeightLayout(3, width, 12, 2, pack.bits)
    wbuf = mk.pack_qweights(q, pack.bits)
    assert wbuf.dtype == torch.uint8 and wbuf.numel() == lay.size
    for part in (lay.first, lay.bs, lay.fuse, lay.sfb, lay.recon, lay.ast, lay.ast1):
        assert part % 16 == 0
    # fxp10 B rows hold the codes as fp16 (the first b1 row of the first qSFB)
    if pack.bits > 8:
        row = wbuf[lay.first: lay.first + lay.ast].view(torch.float16)[:width]
        assert torch.equal(row.to(torch.int32), q["sfbs"][0]["b1_pwq"][:, 0])
    assert (lay.ast // 16) % 2 == 1 and (lay.ast1 // 16) % 2 == 1     # odd: no bank conflicts
    back = mk.unpack_qweights(wbuf, lay)
    for grp in ("first", "recon"):
        assert set(back[grp]) == set(k for k in q[grp] if k != "qc")
        for k, v in back[grp].items():
            assert v.dtype == q[grp][k].dtype and torch.equal(v, q[grp][k]), (grp, k)
    for mine, theirs in zip(back["sfbs"], q["sfbs"]):
        for k, v in mine.items():
            assert v.dtype == theirs[k].dtype and torch.equal(v, theirs[k]), k
    mk.packed_qweights.cache_clear()
    w = min(width, TOY.channels)
    with torch.no_grad():
        a = mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, w, pack=pack)
        mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, w, pack=pack)
        assert mk.packed_qweights.cache_info().hits == 1
        params["recon"]["pw_b"].add_(1.0)            # an in-place edit is a new key
        b = mk.essr_forward_qmegakernel(params, torch.from_numpy(x), TOY, w, pack=pack)
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


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("width", [27, 54])
@pytest.mark.parametrize("patch", [16, 32, 48, 64])
def test_qgroup_report_fits_and_raises(patch, width, bits, scale):
    """Every patch of Table I fits a block at C27 and C54, int8 and fxp10, x2
    and x4 (ROADMAP queue 3, fault 1), in one window; past 64 the patch is
    served in recompute-halo windows (fault 2)."""
    rep = mk.qgroup_report(width, patch, scale, 5, bits)
    assert (rep["windows"], rep["window"], rep["work_factor"]) == ([1, 1], [patch, patch], 1.0)
    cluster, rows = rep["cluster"], rep["rows_per_cta"]
    assert cluster in mk.QMEGA_CLUSTERS and rows == -(-patch // cluster)
    assert rep["smem_bytes"] <= rep["smem_limit"] == 232_448 and rep["bound"] == "operations"
    # the fewest blocks a cluster whose strip fits
    lay = mk.QWeightLayout(3, width, 3 * scale * scale, 5, bits)
    for fewer in mk.QMEGA_CLUSTERS[:mk.QMEGA_CLUSTERS.index(cluster)]:
        assert mk._qmega_smem(lay, -(-patch // fewer), patch) > 232_448
    cp8 = -(-width // 8) * 8
    pst = cp8 + 8 if cp8 % 16 == 0 else cp8         # fp32 map pixel: 8 or 24 floats mod 32
    ost = max(lay.ast, lay.ast1)                    # operand pixel: an odd multiple of 16 B
    assert ost == {(54, 8): 80, (54, 10): 144, (27, 8): 48, (27, 10): 80}[width, bits]
    # one fp32 map, two halo rows, F and Y, two weight slots (one layer
    # each) and the halo mbarrier
    p = rows * patch
    assert rep["smem_bytes"] == (4 * p * pst + 2 * patch * 4 * pst + 2 * p * ost
                                 + 2 * lay.slot + 16)
    assert lay.slot == max(lay.first, lay.bs, lay.fuse, lay.recon)
    assert rep["int_ops_per_patch"] == 2 * patch * patch * (3 * width + 20 * width * width
                                                            + 9 * width)
    big = mk.qgroup_report(width, patch + 64, scale, 5, bits)
    ax = mk.axis_windows(patch + 64, mk.receptive_radius(5), mk.MAX_PATCH)
    assert ax.k > 1 and ax.edge <= 64
    assert (big["windows"], big["window"]) == ([ax.k, ax.k], [ax.edge, ax.edge])
    assert big["work_factor"] == pytest.approx((ax.k * ax.edge / (patch + 64)) ** 2, rel=1e-12)
    rows = big["rows_per_cta"]
    assert big["smem_bytes"] == mk._qmega_smem(lay, rows, ax.edge) <= 232_448
    assert rows == -(-ax.edge // big["cluster"])
    assert big["int_ops_per_patch"] == rep["int_ops_per_patch"] * (patch + 64) ** 2 // patch ** 2


@pytest.mark.parametrize("bits", [8, 10])
def test_qgroup_report_refuses_widths_and_sizes(bits):
    with pytest.raises(ValueError, match="positive"):
        mk.qgroup_report(0, 32, 4, 5, bits)
    # past K = 64 the fp16 dots of fxp10 are no longer exact (511^2 * K >= 2^24)
    with pytest.raises(ValueError, match="1..64 channels"):
        mk.qgroup_report(72, 8, 4, 5, bits)


def test_qmega_sizes_at_full_width():
    # C54 32x32: 4 blocks of 8 rows in both modes (PR 20's layout took 8
    # blocks of 4 rows and 212,608 B in fxp10)
    assert mk.qgroup_report(54, 32, 4, 5, 10)["smem_bytes"] == 172_240
    assert mk.qgroup_report(54, 32, 4, 5, 8)["smem_bytes"] == 139_472
    rep = mk.qgroup_report(54, (25, 32), 4, 5, 10)   # a ragged last strip: 4 rows of 7
    assert (rep["cluster"], rep["rows_per_cta"]) == (4, 7)
    # the shapes PR 20's layout refused: fxp10 48x48 C54 (233,584 / 241,792
    # B), both modes at 64x64 C54 (int8 243,056 / 251,264, fxp10 351,856 /
    # 360,064 B at x2 / x4)
    for width, patch, bits, cluster, rows, smem in ((54, 48, 8, 8, 6, 158_928),
                                                    (54, 48, 10, 8, 6, 195_792),
                                                    (54, 64, 8, 16, 4, 153_808),
                                                    (54, 64, 10, 16, 4, 186_576),
                                                    (27, 64, 10, 8, 8, 199_824),
                                                    (27, 48, 10, 4, 12, 215_184)):
        rep = mk.qgroup_report(width, patch, 4, 5, bits)
        assert (rep["cluster"], rep["rows_per_cta"], rep["smem_bytes"]) == (cluster, rows, smem)
    # fxp10's operands are fp16 codes: 144 B a C54 pixel against 240 B as fp32
    lay = mk.QWeightLayout(3, 54, 48, 5, 10)
    assert (lay.code_bytes, lay.kp, lay.ast, lay.kp1, lay.ast1) == (2, 64, 144, 16, 48)


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
    assert '#include "cluster.cuh"' in src and '#include "qmma.cuh"' in src
    # the 1x1 dots on the tensor cores (qmma.cuh's dot_stage, fxp10 on fp16
    # operands), no CUDA-core dot4; the division skipped on ReLU zeros; halo
    # rows by bulk copies on the receiver's mbarrier, as in mega.cu
    mma = (_build.CSRC / "qmma.cuh").read_text()
    assert "dot_stage<O, 1, 4>(" in src and "dot_stage<O, 2, 4>(" in src and "dot4(" not in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in mma
    assert "push_halo_bulk(" in src and "mbar_wait(" in src
    assert "relu_requant<T>(" in src and "cp_async16(" in mma
    assert 'extern "C" int edge_forward(' in (_build.CSRC / "edge.cu").read_text()
