"""The port's CUDA kernels on the card: each against its plain version, and
the serving path's "cuda" frames (layer and group fusion, and quantized
under both) against its "ref" frame, its integer reference or its layer
chain; the fused graphs (frames and multi-tenant ticks, one shared pool a
device) against host dispatch and solo serving; the degradation ladder on
the card against the same faults on the CPU. Marked ``cuda``;
skipped where no CUDA device is visible. Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: one kernel rtol 1e-4 / atol 1e-5 (fp32 FFMA against fp32
PyTorch with TF32 off); the megakernel's whole chain and whole frames
rtol 1e-3 / atol 1e-3 against the plain model (12 fp32 layers sum in
different orders), and torch.equal against the layer chain of kernels,
which sums every output in the megakernel's order, also where a patch is
served in recompute-halo windows. The quantized kernels (the quantized
megakernel too) put out integer codes and are held to their plain versions
with ``torch.equal`` (qSFB also at extreme codes, C64 and every code and
weight at +-qmax, and across column bands; quantize also at n % 4 != 0,
storage offsets and all-zero inputs); the edge kernel sums each patch's
mean in another order, rtol 1e-4 / atol 1e-3, with equal routing ids.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import qconv as tq
from repro_torch.kernels.bsconv import bsconv_fused
from repro_torch.kernels.dsconv import dsconv_fused
from repro_torch.kernels.edge import edge_score_fused
from repro_torch.kernels.sfb import SFB_KEYS, sfb_fused
from repro_torch.models.essr import ESSR, ESSRConfig, essr_forward

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _w(g, *shape, scale=0.2):
    return (torch.randn(shape, generator=g) * scale).cuda()


#: BSConv / qBSConv shapes (N, H, W, Cin, Cout): the main path's first layer
#: at 32x32 (N 0, 1 and 1024), Cin = Cout, odd channel counts, an 80x80 patch
#: cut into three column bands, 72 wide in three bands, ragged last steps
#: (33 and 13 rows) and odd widths; Cin 3, 27 and 64.
BSCONV_CASES = [(0, 32, 32, 3, 54), (1, 32, 32, 3, 54), (1024, 32, 32, 3, 54),
                (7, 32, 32, 27, 27), (3, 13, 21, 5, 18), (1, 80, 80, 3, 54),
                (1, 80, 80, 27, 27), (1, 80, 80, 64, 54), (2, 40, 72, 3, 54),
                (2, 40, 72, 64, 27), (1, 33, 32, 3, 54), (1, 33, 32, 27, 54),
                (3, 13, 21, 3, 27), (3, 13, 21, 64, 54)]


def _bsconv_smem(cin, cout, h, w, bits):
    """The built walker's shared memory against bsconv_report's."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsconv import bsconv_report
    rep = bsconv_report(cin, cout, h, w, bits)
    fn = _build.load("bsconv").bsconv_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    assert fn(w, cin, cout, bits or 0, rep["rows_per_step"]) == rep["smem_bytes"]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout", BSCONV_CASES)
def test_bsconv_kernel_matches_plain(cuda, n, h, w, cin, cout, relu):
    g = torch.Generator().manual_seed(n + cin)
    x = torch.rand((n, h, w, cin), generator=g).cuda()
    ws = (_w(g, cin, cout), _w(g, cout), _w(g, 3, 3, cout), _w(g, cout))
    before = bsconv_fused.launches
    got = bsconv_fused(x, *ws, relu=relu)
    torch.cuda.synchronize()
    assert bsconv_fused.launches == before + (n > 0)
    torch.testing.assert_close(got, ref.bsconv_ref(x, *ws, relu=relu), **TOL)
    _bsconv_smem(cin, cout, h, w, None)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("n,h,w,cin,cout", BSCONV_CASES)
def test_qbsconv_kernel_equals_plain(cuda, n, h, w, cin, cout, bits, relu):
    """qBSConv (the walker's codes datapath) on codes and weight codes spread
    over the whole lattice, non-zero biases: torch.equal to its plain
    version."""
    g = torch.Generator().manual_seed(n + cin + bits + relu)
    qmax = 127 if bits <= 8 else 511
    dtype = torch.int8 if bits <= 8 else torch.int32
    xq = torch.randint(-qmax, qmax + 1, (n, h, w, cin), generator=g).to(dtype).cuda()
    pwq = torch.randint(-qmax, qmax + 1, (cin, cout), generator=g).to(dtype).cuda()
    pws = ((torch.rand(cout, generator=g) + 0.5) / (qmax * qmax * 3)).cuda()
    qc = torch.tensor([2.0, 2.0 / qmax]).cuda()
    args = (pwq, pws, _w(g, cout, scale=0.1), _w(g, 3, 3, cout, scale=0.5),
            _w(g, cout, scale=0.1), qc)
    before = tq.qbsconv_fused.launches
    got = tq.qbsconv_fused(xq, *args, relu=relu)
    torch.cuda.synchronize()
    assert tq.qbsconv_fused.launches == before + (n > 0)
    want = ref.qbsconv_ref(xq, *args, relu=relu)
    assert torch.equal(got, want) and (n == 0 or want.abs().max().item() > 0)
    _bsconv_smem(cin, cout, h, w, bits)


@pytest.mark.parametrize("n,h,w,c", [(1, 32, 32, 54), (5, 32, 32, 27), (2, 17, 9, 54),
                                     (2, 40, 72, 54), (3, 13, 21, 27), (1, 33, 32, 54)])
def test_sfb_kernel_matches_plain(cuda, n, h, w, c):
    # 40x72: column bands with a recomputed halo; 13 and 33 rows: a ragged last step
    g = torch.Generator().manual_seed(n + c)
    x = torch.rand((n, h, w, c), generator=g).cuda()
    p = {k: _w(g, c, c) if k in ("b1_pw", "b2_pw", "fuse") else
         _w(g, 3, 3, c) if k.endswith("_dw") else _w(g, c) for k in SFB_KEYS}
    before = sfb_fused.launches
    got = sfb_fused(x, p)
    torch.cuda.synchronize()
    assert sfb_fused.launches == before + 1
    torch.testing.assert_close(got, ref.sfb_ref(x, p), **TOL)


#: DSConv / qDSConv shapes (N, H, W, Cin, Cout): the main path's 32x32 at
#: three batch sizes, ragged steps and odd widths, Table I's 64 and an 80x80
#: patch cut into three column bands.
DSCONV_CASES = [(1, 32, 32, 54, 48), (7, 32, 32, 27, 12), (1024, 32, 32, 54, 48),
                (2, 10, 30, 12, 48), (3, 13, 21, 54, 48), (2, 17, 9, 27, 48),
                (2, 64, 64, 54, 48), (1, 80, 80, 27, 48), (1, 80, 80, 54, 12)]


def _dsconv_smem(cin, cout, h, w, bits):
    """The built walker's shared memory against dsconv_report's."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.dsconv import dsconv_report
    rep = dsconv_report(cin, cout, h, w, bits)
    fn = _build.load("dsconv").dsconv_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    assert fn(w, cin, cout, bits or 0, rep["rows_per_step"]) == rep["smem_bytes"]


@pytest.mark.parametrize("n,h,w,cin,cout", DSCONV_CASES)
def test_dsconv_kernel_matches_plain(cuda, n, h, w, cin, cout):
    g = torch.Generator().manual_seed(n + cin)
    x = torch.rand((n, h, w, cin), generator=g).cuda()
    ws = (_w(g, 3, 3, cin), _w(g, cin), _w(g, cin, cout), _w(g, cout))
    got = dsconv_fused(x, *ws)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.dsconv_ref(x, *ws), **TOL)
    _dsconv_smem(cin, cout, h, w, None)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("n,h,w,cin,cout", DSCONV_CASES)
def test_qdsconv_kernel_equals_plain(cuda, n, h, w, cin, cout, bits):
    """qDSConv (the walker's codes datapath) on codes spread over the whole
    lattice, non-zero biases: torch.equal to its plain version."""
    g = torch.Generator().manual_seed(n + cin + bits)
    qmax = 127 if bits <= 8 else 511
    dtype = torch.int8 if bits <= 8 else torch.int32
    xq = torch.randint(-qmax, qmax + 1, (n, h, w, cin), generator=g).to(dtype).cuda()
    dwq = torch.randint(-qmax, qmax + 1, (3, 3, cin), generator=g).to(torch.int32).cuda()
    dws = ((torch.rand(cin, generator=g) + 0.5) / (qmax * qmax * 3)).cuda()
    pw = (torch.randn((cin, cout), generator=g) * 4 / cin ** 0.5).cuda()
    qc = torch.tensor([2.0, 2.0 / qmax]).cuda()
    args = (dwq, dws, _w(g, cin, scale=0.1), pw, _w(g, cout, scale=0.1), qc)
    got = tq.qdsconv_fused(xq, *args)
    torch.cuda.synchronize()
    want = ref.qdsconv_ref(xq, *args)
    assert torch.equal(got, want) and want.abs().max().item() > 0
    _dsconv_smem(cin, cout, h, w, bits)


def test_engine_frame_on_card_matches_ref(cuda):
    r = np.random.default_rng(0)
    frame = np.clip(np.linspace(0, 1, 96 * 160 * 3, dtype=np.float32).reshape(96, 160, 3)
                    + (np.arange(160) > 80)[None, :, None] * (r.random((96, 160, 3)) - 0.5),
                    0, 1).astype(np.float32)
    eng = SREngine.from_config(ESSRConfig(scale=2), seed=3)
    ops.reset_launch_counts()
    got = eng.upscale(frame)
    assert got.backend == "cuda" and ops.launch_counts()["sfb"] > 0
    want = SREngine(eng.model, backend="ref").upscale(frame)
    np.testing.assert_array_equal(got.ids, want.ids)
    torch.testing.assert_close(got.image, want.image, rtol=1e-3, atol=1e-3)


#: Megakernel checks (N, H, W, C): Table I's patches (16x16 at C54 in one
#: block, 48 at C54 in 16, 64 at C54 with unpadded pixels), an odd patch in one
#: block, ragged last strips (17x9, 25x32: 4 blocks of 7 rows), a patch
#: shorter than its blocks (5x9) and idle last blocks (33x32: 16 x 3 rows).
MEGA_CASES = [(0, 32, 32, 54), (1, 32, 32, 54), (7, 32, 32, 54), (1, 32, 32, 27),
              (7, 32, 32, 27), (3, 13, 21, 54), (2, 16, 16, 54), (2, 16, 16, 27),
              (2, 48, 48, 54), (2, 48, 48, 27), (2, 64, 64, 54), (2, 64, 64, 27),
              (2, 17, 9, 54), (1, 25, 32, 54), (2, 5, 9, 27), (1, 33, 32, 54)]


def _mega_tree(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    tree = ESSR(cfg, generator=g).to("cuda").tree()
    with torch.no_grad():
        for leaf in mk._leaves(tree):          # non-zero biases: a halo that read
            if leaf.ndim == 1:                 # pw(0) + b instead of 0 would show
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=g).cuda())
    return tree, g


@pytest.mark.parametrize("n,h,w,width", MEGA_CASES)
def test_megakernel_matches_plain(cuda, n, h, w, width):
    import ctypes
    from repro_torch.kernels import _build
    cfg = ESSRConfig(scale=4)
    tree, g = _mega_tree(cfg, n + width + h)
    x = torch.rand((n, h, w, 3), generator=g).cuda()
    wbuf = mk.pack_weights(tree, width)
    lay = mk.WeightLayout(3, width, cfg.out_channels, cfg.n_sfb)
    before = mk.mega_fused.launches
    got = mk.mega_fused(x, wbuf, width=width, n_sfb=cfg.n_sfb, out_channels=cfg.out_channels)
    torch.cuda.synchronize()
    assert mk.mega_fused.launches == before + (n > 0)
    assert tuple(got.shape) == (n, h, w, cfg.out_channels)
    torch.testing.assert_close(got, ref.mega_ref(x, mk.unpack_weights(wbuf, lay)), **CHAIN_TOL)
    # every sum in the layer chain's order: bit for bit
    with torch.no_grad():
        layer = ops.essr_forward_kernels(tree, x, cfg, width=width)
        assert torch.equal(mk.essr_forward_megakernel(tree, x, cfg, width=width), layer)
    # the launch's shared memory is group_report's
    rep = mk.group_report(width, (h, w), cfg.scale, cfg.n_sfb)
    smem = _build.load("mega").mega_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    assert smem(w, 3, width, 48, 5, rep["rows_per_cta"], rep["pixel_pad"]) == rep["smem_bytes"]


def _launched(before):
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


#: Patches past one launch (width, patch): x4 at 72x72 and 80x80 (2 x 2
#: windows of 48 and 52), a (96, 72) patch at C27 (2 x 2 of 60 and 48), and
#: C64 at 64x64, whose strip fits no block (2 x 1 windows of 44 x 64).
WINDOW_CASES = [(54, 72), (54, 80), (27, (96, 72)), (64, 64)]


def test_megakernel_refuses_on_card_without_fallback(cuda):
    """Past one launch the megakernel serves the patch in recompute-halo
    windows, all in one launch, torch.equal to the layer chain on the whole
    patch; nothing falls back to the layer chain."""
    for width, patch in WINDOW_CASES:
        cfg = ESSRConfig(scale=4, channels=max(width, 54))
        tree, g = _mega_tree(cfg, width)
        h, w = (patch, patch) if isinstance(patch, int) else patch
        x = torch.rand((2, h, w, 3), generator=g).cuda()
        rep = mk.group_report(width, (h, w), cfg.scale, cfg.n_sfb)
        assert rep["windows"] != [1, 1]
        before = ops.launch_counts()
        group = mk.essr_forward_megakernel(tree, x, cfg, width=width)
        torch.cuda.synchronize()
        assert _launched(before) == {"mega": 1}
        layer = ops.essr_forward_kernels(tree, x, cfg, width=width)
        assert torch.equal(group, layer), (width, patch, rep["windows"])


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
def test_quantized_megakernel_serves_windows_equal_to_the_chain(cuda, mode):
    """The quantized megakernel past one launch: windows in one launch,
    torch.equal to the qconv chain and the integer reference on the whole
    patch."""
    for width, patch in WINDOW_CASES[:3]:
        cfg, tree, pack, _ = _quant_setup(mode, width, seed=width)
        h, w = (patch, patch) if isinstance(patch, int) else patch
        x = torch.rand((2, h, w, 3), generator=torch.Generator().manual_seed(h + w)).cuda()
        rep = mk.qgroup_report(width, (h, w), cfg.scale, cfg.n_sfb, pack.bits)
        assert rep["windows"] != [1, 1]
        before = ops.launch_counts()
        got = mk.essr_forward_qmegakernel(tree, x, cfg, width, pack=pack)
        torch.cuda.synchronize()
        assert _launched(before) == {"qmega": 1}
        assert torch.equal(got, tq.essr_forward_qkernels(tree, x, cfg, width, pack=pack))
        assert torch.equal(got, tq.essr_forward_qref(tree, x, cfg, width, pack=pack))


def _group_equals_layer(quant, patch):
    r = np.random.default_rng(2)
    frame = np.clip(np.linspace(0, 1, 96 * 160 * 3, dtype=np.float32).reshape(96, 160, 3)
                    + (np.arange(160) > 80)[None, :, None] * (r.random((96, 160, 3)) - 0.5),
                    0, 1).astype(np.float32)
    kw = dict(patch=patch, overlap=2, quant=quant)
    layer = SREngine.from_config(ESSRConfig(scale=2), seed=4, plan=ExecutionPlan(**kw))
    group = SREngine(layer.model, plan=ExecutionPlan(**kw, fusion="group"))
    a = layer.upscale(frame)
    ops.reset_launch_counts()
    b = group.upscale(frame)
    buckets = sum(1 for k in (1, 2) if b.counts[k] > 0)
    assert buckets > 0 and ops.launch_counts() == {
        **dict.fromkeys(ops.KERNELS, 0), "qmega" if quant else "mega": buckets, "edge": 1}
    np.testing.assert_array_equal(a.ids, b.ids)
    assert torch.equal(a.image, b.image)


@pytest.mark.parametrize("quant", [None, "int8", "fxp10"])
def test_engine_group_frame_at_patch_48_equals_layer_frame(cuda, quant):
    _group_equals_layer(quant, 48)


@pytest.mark.parametrize("quant", [None, "int8", "fxp10"])
def test_engine_group_frame_at_patch_64_equals_layer_frame(cuda, quant):
    """Table I's largest patch; qmega's 16-block clusters at C54 (ROADMAP
    queue 3, fault 1)."""
    _group_equals_layer(quant, 64)


@pytest.mark.parametrize("quant", [None, "int8", "fxp10"])
def test_engine_group_frame_at_patch_80_equals_layer_frame(cuda, quant):
    """Past Table I: 2 x 2 recompute-halo windows of 52 in one launch a
    bucket (ROADMAP queue 3, fault 2)."""
    _group_equals_layer(quant, 80)


def test_engine_group_frame_on_card_matches_ref(cuda):
    r = np.random.default_rng(1)
    frame = np.clip(np.linspace(0, 1, 96 * 160 * 3, dtype=np.float32).reshape(96, 160, 3)
                    + (np.arange(160) > 80)[None, :, None] * (r.random((96, 160, 3)) - 0.5),
                    0, 1).astype(np.float32)
    eng = SREngine.from_config(ESSRConfig(scale=2), seed=3, plan=ExecutionPlan(fusion="group"))
    ops.reset_launch_counts()
    got = eng.upscale(frame)
    counts = ops.launch_counts()
    buckets = sum(1 for k in (1, 2) if got.counts[k] > 0)
    assert got.backend == "cuda" and buckets > 0
    assert counts == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": buckets,
                      "quantize": 0, "qbsconv": 0, "qsfb": 0, "qdsconv": 0,
                      "qmega": 0, "edge": 1}
    want = SREngine(eng.model, backend="ref").upscale(frame)
    np.testing.assert_array_equal(got.ids, want.ids)
    torch.testing.assert_close(got.image, want.image, **CHAIN_TOL)


def _quant_setup(mode, width, seed):
    """An x2 supernet on the card with non-zero biases, its calibrated pack
    and the prepared operands at ``width``."""
    from repro_torch.api.engine import default_calibration_batch
    from repro_torch.quant.pams import build_quant_pack
    cfg = ESSRConfig(scale=2)
    g = torch.Generator().manual_seed(seed)
    tree = ESSR(cfg, generator=g).to("cuda").requires_grad_(False).tree()
    for leaf in mk._leaves(tree):
        if leaf.ndim == 1:
            leaf.copy_(0.1 * torch.randn(leaf.shape, generator=g).cuda())
    pack = build_quant_pack(tree, cfg, mode, default_calibration_batch(32, 2, n=8).cuda())
    q, _ = tq.prepare_qparams(tree, cfg, width, pack, device="cuda")
    return cfg, tree, pack, q


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("n,h,w,width", [(1, 32, 32, 54), (7, 32, 32, 27), (3, 13, 21, 54),
                                         (0, 32, 32, 54)])
def test_quantized_kernels_equal_plain(cuda, mode, n, h, w, width):
    cfg, _, pack, q = _quant_setup(mode, width, seed=n + width)
    x = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(n)).cuda()
    before = {k: v.launches for k, v in ops.KERNELS.items()}
    f = tq.quantize_fused(x, q["in_qc"], bits=pack.bits)
    want = ref.quantize_ref(x, q["in_qc"], f.dtype)
    assert torch.equal(f, want)
    p = q["first"]
    args = (p["pwq"], p["pw_scale"], p["pwb"], p["dw_fq"], p["dwb"], p["qc"])
    got, want = tq.qbsconv_fused(f, *args, relu=False), ref.qbsconv_ref(f, *args, relu=False)
    assert torch.equal(got, want)
    f = want
    for sfb in q["sfbs"]:
        got, want = tq.qsfb_fused(f, sfb, sfb["qc"]), ref.qsfb_ref(f, sfb, sfb["qc"])
        assert torch.equal(got, want)
        f = want
    r = q["recon"]
    args = (r["dwq"], r["dw_scale"], r["dwb"], r["pw_fq"], r["pwb"], r["qc"])
    got, want = tq.qdsconv_fused(f, *args), ref.qdsconv_ref(f, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and tuple(got.shape) == (n, h, w, cfg.out_channels)
    assert (got.abs().max().item() if n else 1) > 0          # not all-zero codes
    after = {k: v.launches for k, v in ops.KERNELS.items()}
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launched == ({} if n == 0 else
                        {"quantize": 1, "qbsconv": 1, "qsfb": cfg.n_sfb, "qdsconv": 1})


def _qsfb_extreme(n, h, w, c, bits, seed):
    """qSFB codes and operands on the card at the lattice's extremes: every
    code and weight code at +-qmax, a third of the patches all +qmax, every
    third weight column all +qmax and the next all -qmax, so the integer sums
    reach qmax^2 * c; scales that keep the site codes spread."""
    g = torch.Generator().manual_seed(seed)
    qmax = 2 ** (bits - 1) - 1
    dtype = torch.int8 if bits <= 8 else torch.int32

    def signs(*shape):
        return torch.randint(0, 2, shape, generator=g) * 2 - 1

    def scale():
        return (torch.rand(c, generator=g) + 0.5) / (qmax * qmax * c ** 0.5)

    x = signs(n, h, w, c) * qmax
    x[: max(1, n // 3)] = qmax
    q = {}
    for k in ("b1_pwq", "b2_pwq", "fuseq"):
        wq = signs(c, c) * qmax
        wq[:, 0::3], wq[:, 1::3] = qmax, -qmax
        q[k] = wq.to(dtype)
    for b in ("b1", "b2"):
        q.update({f"{b}_pw_scale": scale(), f"{b}_pwb": 0.1 * torch.randn(c, generator=g),
                  f"{b}_dw_fq": torch.rand((3, 3, c), generator=g) * 0.4 - 0.1,
                  f"{b}_dwb": 0.1 * torch.randn(c, generator=g)})
    q.update(fuse_scale_y=scale(), fuse_scale_x=scale(), fuseb=0.1 * torch.randn(c, generator=g))
    qc = torch.tensor([2.0, 2.0 / qmax] * 3, dtype=torch.float32)
    return x.to(dtype).cuda(), {k: v.contiguous().cuda() for k, v in q.items()}, qc.cuda()


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("n,h,w,c", [(0, 32, 32, 64), (1, 32, 32, 64), (7, 32, 32, 64),
                                     (2, 40, 72, 54), (3, 13, 21, 27), (1, 33, 32, 54),
                                     (2, 17, 9, 64)])
def test_qsfb_kernel_equals_plain_at_extreme_codes(cuda, n, h, w, c, bits):
    xq, q, qc = _qsfb_extreme(n, h, w, c, bits, seed=n + h + c + bits)
    before = tq.qsfb_fused.launches
    got = tq.qsfb_fused(xq, q, qc)
    torch.cuda.synchronize()
    assert tq.qsfb_fused.launches == before + (n > 0)
    want = ref.qsfb_ref(xq, q, qc)
    assert got.dtype == xq.dtype and torch.equal(got, want)
    assert (want.abs().max().item() if n else 1) > 0          # not all-zero codes


def test_engine_int8_frame_on_card(cuda):
    r = np.random.default_rng(2)
    frame = np.clip(np.linspace(0, 1, 96 * 160 * 3, dtype=np.float32).reshape(96, 160, 3)
                    + (np.arange(160) > 80)[None, :, None] * (r.random((96, 160, 3)) - 0.5),
                    0, 1).astype(np.float32)
    eng = SREngine.from_config(ESSRConfig(scale=2), seed=3, plan=ExecutionPlan(quant="int8"))
    ops.reset_launch_counts()
    got = eng.upscale(frame)
    counts = ops.launch_counts()
    buckets = sum(1 for k in (1, 2) if got.counts[k] > 0)
    assert got.backend == "cuda-int8" and buckets > 0
    assert counts == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0, "quantize": buckets,
                      "qbsconv": buckets, "qsfb": 5 * buckets, "qdsconv": buckets,
                      "qmega": 0, "edge": 1}
    fp = SREngine(eng.model).upscale(frame)
    np.testing.assert_array_equal(got.ids, fp.ids)
    assert bool(torch.isfinite(got.image).all())


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("n,width", [(1, 54), (7, 54), (1, 27), (7, 27), (0, 54)])
def test_quantized_megakernel_equals_chain_and_reference(cuda, mode, n, width):
    cfg, tree, pack, q = _quant_setup(mode, width, seed=n + width + 1)
    x = torch.rand((n, 32, 32, 3), generator=torch.Generator().manual_seed(n)).cuda()
    before = mk.qmega_fused.launches
    got = mk.essr_forward_qmegakernel(tree, x, cfg, width, pack=pack)
    torch.cuda.synchronize()
    assert mk.qmega_fused.launches == before + (n > 0)
    assert torch.equal(got, tq.essr_forward_qkernels(tree, x, cfg, width, pack=pack))
    assert torch.equal(got, tq.essr_forward_qref(tree, x, cfg, width, pack=pack))
    wbuf = mk.pack_qweights(q, pack.bits)
    lay = mk.QWeightLayout(3, width, cfg.out_channels, cfg.n_sfb, pack.bits)
    codes = mk.qmega_fused(x, wbuf, q["consts"], width=width, n_sfb=cfg.n_sfb,
                           out_channels=cfg.out_channels, bits=pack.bits)
    plain = ref.qmega_ref(x, mk.unpack_qweights(wbuf, lay), q["consts"], codes.dtype)
    torch.cuda.synchronize()
    assert torch.equal(codes, plain) and (codes.abs().max().item() if n else 1) > 0


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("n,h,w,width", [(2, 17, 9, 54), (2, 17, 9, 27), (3, 13, 21, 54),
                                         (1, 25, 32, 54), (2, 5, 9, 27), (2, 48, 48, 54),
                                         (2, 64, 64, 54)])
def test_quantized_megakernel_ragged_strips(cuda, mode, n, h, w, width):
    """Ragged last strips (17, 13 and 25 rows), an idle last block (5 rows)
    and the Table I shapes PR 20's layout refused (48x48 C54: 8 blocks of 6
    rows; 64x64 C54: 16 blocks of 4); the launch's shared memory is
    qgroup_report's."""
    cfg, tree, pack, q = _quant_setup(mode, width, seed=n + h + width)
    x = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(h)).cuda()
    got = mk.essr_forward_qmegakernel(tree, x, cfg, width, pack=pack)
    assert torch.equal(got, tq.essr_forward_qkernels(tree, x, cfg, width, pack=pack))
    assert torch.equal(got, tq.essr_forward_qref(tree, x, cfg, width, pack=pack))
    wbuf = mk.pack_qweights(q, pack.bits)
    lay = mk.QWeightLayout(3, width, cfg.out_channels, cfg.n_sfb, pack.bits)
    codes = mk.qmega_fused(x, wbuf, q["consts"], width=width, n_sfb=cfg.n_sfb,
                           out_channels=cfg.out_channels, bits=pack.bits)
    plain = ref.qmega_ref(x, mk.unpack_qweights(wbuf, lay), q["consts"], codes.dtype)
    torch.cuda.synchronize()
    assert torch.equal(codes, plain) and codes.abs().max().item() > 0
    import ctypes
    from repro_torch.kernels import _build
    rep = mk.qgroup_report(width, (h, w), cfg.scale, cfg.n_sfb, pack.bits)
    smem = _build.load("qmega").qmega_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    assert smem(w, 3, width, cfg.out_channels, cfg.n_sfb, rep["rows_per_cta"],
                pack.bits) == rep["smem_bytes"]


def _chip_smoke():
    """chip_smoke.py at the repository root, for its synthetic operands."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("n,h,w", [(7, 32, 32), (2, 17, 9), (3, 13, 21), (1, 25, 32)])
def test_quantized_megakernel_at_extreme_codes(cuda, n, h, w, bits):
    """Every weight code at +-qmax and codes that saturate; one qSFB's sums
    reach +-qmax^2 * 54 (fxp10: 511^2 * 54, below the fp16 route's 2^24)."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(n + bits)
    q = cs.qmega_extreme_operands(54, bits, g, torch)
    x = torch.rand((n, h, w, 3), generator=g).cuda()
    wbuf = mk.pack_qweights(q, bits)
    lay = mk.QWeightLayout(3, 54, 48, 5, bits)
    codes = mk.qmega_fused(x, wbuf, q["consts"], width=54, n_sfb=5, out_channels=48, bits=bits)
    plain = ref.qmega_ref(x, mk.unpack_qweights(wbuf, lay), q["consts"], codes.dtype)
    torch.cuda.synchronize()
    assert torch.equal(codes, plain) and torch.equal(codes, cs.qchain_kernels(q, x, bits))
    assert (plain.abs() == (127 if bits <= 8 else 511)).any()


def test_engine_quant_group_frame_on_card(cuda):
    r = np.random.default_rng(3)
    frame = np.clip(np.linspace(0, 1, 96 * 160 * 3, dtype=np.float32).reshape(96, 160, 3)
                    + (np.arange(160) > 80)[None, :, None] * (r.random((96, 160, 3)) - 0.5),
                    0, 1).astype(np.float32)
    layer = SREngine.from_config(ESSRConfig(scale=2), seed=3, plan=ExecutionPlan(quant="fxp10"))
    group = SREngine(layer.model, plan=ExecutionPlan(quant="fxp10", fusion="group"))
    assert group.qpack == layer.qpack
    want = layer.upscale(frame)
    ops.reset_launch_counts()
    got = group.upscale(frame)
    counts = ops.launch_counts()
    buckets = sum(1 for k in (1, 2) if got.counts[k] > 0)
    assert got.backend == "cuda-fxp10" and buckets > 0
    assert counts == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0, "quantize": 0,
                      "qbsconv": 0, "qsfb": 0, "qdsconv": 0, "qmega": buckets, "edge": 1}
    np.testing.assert_array_equal(got.ids, want.ids)
    assert torch.equal(got.image, want.image)


@pytest.mark.parametrize("n,h,w", [(0, 32, 32), (1, 32, 32), (300, 32, 32), (5, 34, 34),
                                   (3, 8, 13), (2, 3, 3), (3, 5, 3), (2, 16, 16), (4, 48, 48),
                                   (3, 64, 64), (2, 70, 70), (2, 9, 70), (1, 40, 200)])
def test_edge_kernel_matches_plain(cuda, n, h, w):
    x = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(n + h)).cuda()
    before = edge_score_fused.launches
    got = edge_score_fused(x)
    torch.cuda.synchronize()
    assert edge_score_fused.launches == before + (n > 0)
    assert tuple(got.shape) == (n,)
    torch.testing.assert_close(got, ref.edge_score_ref(x), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("patch", [16, 32, 48, 64])
def test_edge_kernel_on_frame_patches_routes_as_plain(cuda, patch):
    """The serving path's patches (overlap 2) of a mixed frame: scores within
    rtol 1e-4 / atol 1e-3 of the plain score, and the same routing ids."""
    from repro_torch.core import subnet_policy as sp
    from repro_torch.core.patching import get_geometry
    r = np.random.default_rng(patch)
    frame = np.clip(np.linspace(0, 1, 200 * 264 * 3, dtype=np.float32).reshape(200, 264, 3)
                    + (np.arange(264) > 132)[None, :, None] * (r.random((200, 264, 3)) - 0.5),
                    0, 1).astype(np.float32)
    patches = get_geometry(200, 264, patch, 2, 2, "cuda").extract(torch.from_numpy(frame).cuda())
    got = edge_score_fused(patches)
    want = ref.edge_score_ref(patches)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    t1, t2 = sp.DEFAULT_T1, sp.DEFAULT_T2
    np.testing.assert_array_equal(sp.decide(got.cpu().numpy(), t1, t2),
                                  sp.decide(want.cpu().numpy(), t1, t2))


def _golden_frame(hw: int = 128, seed: int = 1234) -> np.ndarray:
    """The mixed smooth/texture frame of tests/test_fused_dispatch.py, from
    the port's twin of the reference's synthetic images."""
    from repro_torch.data import synthetic as tsyn
    yy, xx = np.meshgrid(np.linspace(0, 1, hw, dtype=np.float32),
                         np.linspace(0, 1, hw, dtype=np.float32), indexing="ij")
    smooth = np.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = tsyn.degrade(tsyn.random_image(seed, 2 * hw, 2 * hw), 2).numpy()
    return np.where((yy < 0.5)[..., None], smooth, tex).astype(np.float32)


def test_engine_golden_frame_routes_through_the_edge_kernel(cuda):
    """The "cuda" frame scores with the edge kernel, one launch a frame; the
    golden frame's counts stay (10, 2, 13) and its ids equal the "ref"
    frame's, which scores with the plain version."""
    frame = _golden_frame()
    eng = SREngine.from_config(ESSRConfig(scale=2), seed=1)
    ops.reset_launch_counts()
    got = eng.upscale(frame)
    assert ops.launch_counts()["edge"] == 1 and got.counts == (10, 2, 13)
    ops.reset_launch_counts()
    want = SREngine(eng.model, backend="ref").upscale(frame)
    assert ops.launch_counts()["edge"] == 0 and want.counts == (10, 2, 13)
    np.testing.assert_array_equal(got.ids, want.ids)
    torch.testing.assert_close(torch.from_numpy(np.asarray(got.scores)),
                               torch.from_numpy(np.asarray(want.scores)), rtol=1e-4, atol=1e-3)


def _quantize_input(n: int, offset: int, zeros: bool, a: float, s: float, seed: int):
    """n values on the card at a storage offset: first the values a code can
    go wrong on (0, -0.0, +-a, past +-a, half-step ties), then noise over
    [-1.5a, 1.5a], or all zeros."""
    g = torch.Generator().manual_seed(seed)
    v = torch.zeros(n + offset) if zeros else (torch.rand(n + offset, generator=g) * 3 - 1.5) * a
    if not zeros:
        special = torch.tensor([0.0, -0.0, a, -a, 1.5 * a, -1.5 * a, 1e30, -1e30]
                               + [(k + 0.5) * s for k in range(-6, 6)])
        m = min(n, special.numel())
        v[offset: offset + m] = special[:m]
    return v.cuda()[offset:].view(1, 1, n, 1)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("n,offset,zeros", [(1, 0, False), (3, 1, False), (4099, 0, False),
                                            (4099, 1, False), (4096, 1, False),
                                            (4096, 2, False), (4097, 3, False),
                                            (3 * 1024 * 1024, 0, False),
                                            (3 * 1024 * 1024 + 1, 1, False), (4099, 0, True),
                                            (3 * 1024 * 1024, 1, True)])
def test_quantize_kernel_equals_plain(cuda, n, offset, zeros, bits):
    """The quantize kernel's 16-byte stream with its scalar head and tail:
    n % 4 != 0, storage offsets of 1-3 elements, an all-zero input, both code
    types, at a power-of-two step (exact ties) and a calibrated-looking one;
    torch.equal to the plain version on the card and on the CPU."""
    qmax = 127 if bits <= 8 else 511
    dtype = torch.int8 if bits <= 8 else torch.int32
    for a in (qmax / 128.0, 0.7310345):
        s = float(torch.tensor(a) / qmax)
        x = _quantize_input(n, offset, zeros, a, s, seed=n + offset)
        assert x.storage_offset() == offset
        qc = torch.tensor([a, s], dtype=torch.float32).cuda()
        before = tq.quantize_fused.launches
        got = tq.quantize_fused(x, qc, bits=bits)
        torch.cuda.synchronize()
        assert tq.quantize_fused.launches == before + 1 and got.dtype == dtype
        want = ref.quantize_ref(x, qc, dtype)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), ref.quantize_ref(x.cpu(), qc.cpu(), dtype))
        if zeros:
            assert got.abs().max().item() == 0
        elif n > 20:                          # past the special values: noise codes too
            assert got.abs().max().item() > 0


# ---------------------------------------------------------------------------
# fused dispatch: the frame as one CUDA graph replay
# ---------------------------------------------------------------------------

FUSED_MODES = [(q, f) for q in (None, "int8", "fxp10") for f in ("layer", "group")]


def _fused_frame(seed: int, h: int = 96, w: int = 160) -> np.ndarray:
    """A smooth left half, mild and strong noise on the right: every subnet."""
    r = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    amp = np.where(xx < 0.5, 0.0, np.where(xx < 0.75, 0.12, 0.5)).astype(np.float32)
    smooth = np.stack([yy, xx, (yy + xx) / 2], axis=-1)
    return np.clip(smooth + amp[..., None] * (r.random((h, w, 3), np.float32) - 0.5),
                   0, 1).astype(np.float32)


def _fused_pair(quant, fusion, seed=5, **plan):
    plan = ExecutionPlan(quant=quant, fusion=fusion, **plan)
    host = SREngine.from_config(ESSRConfig(scale=4), seed=seed, plan=plan)
    fused = SREngine(host.model, plan=plan.replace(dispatch="fused"))
    return host, fused


def _entry_calls(monkeypatch):
    """Counts the C entries looked up: every kernel wrapper's launch on the
    card goes through `_build.entry`."""
    from repro_torch.kernels import _build
    calls = []
    real = _build.entry

    def spy(*args):
        calls.append(args[:2])
        return real(*args)

    monkeypatch.setattr(_build, "entry", spy)
    return calls


@pytest.mark.parametrize("quant,fusion", FUSED_MODES)
def test_fused_frame_equals_host_frame(cuda, quant, fusion):
    from repro_torch.core import pipeline as pl
    host, fused = _fused_pair(quant, fusion)
    frames = [_fused_frame(s) for s in (0, 1)]
    for f in frames:
        a, b = host.upscale(f), fused.upscale(f)
        assert b.dispatch == "fused" and b.backend == a.backend
        assert b.spill_counts == (0, 0, 0) and b.counts == a.counts
        assert all(c > 0 for c in b.counts)
        np.testing.assert_array_equal(b.ids.cpu().numpy(), a.ids)
        assert torch.equal(b.image, a.image)
    graph = next(v for v in pl._fused_frame_fn.values() if v.graph is not None)
    per = {None: {"layer": {"edge": 1, "bsconv": 2, "sfb": 10, "dsconv": 2},
                  "group": {"edge": 1, "mega": 2}}}
    for q in ("int8", "fxp10"):
        per[q] = {"layer": {"edge": 1, "quantize": 2, "qbsconv": 2, "qsfb": 10, "qdsconv": 2},
                  "group": {"edge": 1, "qmega": 2}}
    assert graph.launches == per[quant][fusion] and graph.pool_bytes > 0
    pl._fused_frame_fn.cache_clear()


def test_fused_replay_calls_no_wrapper_and_captures_nothing(cuda, monkeypatch):
    from repro_torch.core import pipeline as pl
    _, fused = _fused_pair(None, "layer")
    frame = _fused_frame(2)
    first = fused.upscale(frame)
    assert first.compiled is False
    misses = pl._fused_frame_fn.occupancy()["misses"]
    calls = _entry_calls(monkeypatch)
    ops.reset_launch_counts()
    second = fused.upscale(_fused_frame(3))
    assert second.compiled is True and calls == []
    assert pl._fused_frame_fn.occupancy()["misses"] == misses
    # the replay's launches come from the capture's deltas
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "edge": 1, "bsconv": 2,
                                   "sfb": 10, "dsconv": 2}
    again = fused.upscale(frame)
    assert torch.equal(again.image, first.image) and torch.equal(again.ids, first.ids)
    pl._fused_frame_fn.cache_clear()


@pytest.mark.parametrize("inflight", [2, 3])
def test_fused_inflight_stream_equals_sync_stream(cuda, inflight):
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import SwitchingConfig
    frames = [_fused_frame(s) for s in range(5)]
    runs = {}
    for n in (1, inflight):
        eng = SREngine.from_config(ESSRConfig(scale=4), seed=5,
                                   plan=ExecutionPlan(dispatch="fused", inflight=n),
                                   switching=SwitchingConfig(frame_high=10 ** 9, frame_low=0))
        runs[n] = list(eng.stream(frames))
    for a, b in zip(runs[1], runs[inflight]):
        assert a.counts == b.counts and a.spill_counts == b.spill_counts
        assert torch.equal(a.ids, b.ids) and torch.equal(a.image, b.image)
    assert len({r.image.data_ptr() for r in runs[inflight]}) == len(frames)
    pl._fused_frame_fn.cache_clear()


def test_fused_capture_that_fails_raises(cuda, monkeypatch):
    """A host sync inside the captured frame fails the capture, and the
    frame raises: nothing runs eagerly in its place, nothing is cached, and
    the ladder records the failure without stepping down (on the card only
    an injected fault steps down)."""
    from repro_torch.core import pipeline as pl
    real = pl._decide

    def syncing(scores, t1, t2):
        scores.sum().item()                # a host sync: refused while capturing
        return real(scores, t1, t2)

    monkeypatch.setattr(pl, "_decide", syncing)
    _, fused = _fused_pair(None, "group")
    with pytest.raises(RuntimeError):
        fused.upscale(_fused_frame(4))
    assert [e["kind"] for e in fused.guard.events] == ["failure"]
    assert fused.guard.level == 0
    assert pl._fused_frame_fn.occupancy()["size"] == 0
    torch.cuda.synchronize()
    pl._fused_frame_fn.cache_clear()


def test_fused_eviction_drops_the_graph(cuda):
    import gc
    import weakref
    from repro_torch.core import pipeline as pl
    _, fused = _fused_pair(None, "group")
    fused.upscale(_fused_frame(0))
    graph = weakref.ref(pl._fused_frame_fn.values()[0])
    pl.configure_compiled_caches(1)
    try:
        fused.upscale(_fused_frame(0, h=64, w=96))     # another geometry evicts it
        gc.collect()
        assert graph() is None and pl._fused_frame_fn.occupancy()["evictions"] >= 1
    finally:
        pl.configure_compiled_caches(128)
        pl._fused_frame_fn.cache_clear()


# ---------------------------------------------------------------------------
# one graph pool a device (fault 5), fused ticks, the ladder on the card
# ---------------------------------------------------------------------------

def test_fused_graphs_share_one_pool(cuda):
    """Four pinned capacity profiles of one 540x960 frame: four graphs, each
    frame torch.equal to host dispatch, and the reserved memory grows by far
    less than the first graph's pool per added graph (private pools grew by
    a whole pool each)."""
    from repro_torch.core import pipeline as pl
    pl._fused_frame_fn.cache_clear()
    frame = _fused_frame(0, h=540, w=960)
    host = SREngine.from_config(ESSRConfig(scale=4), seed=5)
    want = host.upscale(frame).image
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    reserved, engines = [], []
    for j in range(4):
        eng = SREngine(host.model, plan=ExecutionPlan(dispatch="fused",
                                                      capacity=(0, 256 + 64 * j, 256)))
        r = eng.upscale(frame)
        assert r.spill_counts == (0, 0, 0) and torch.equal(r.image, want)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved() - base)
        engines.append(eng)
    graphs = pl._fused_frame_fn.values()
    assert len(graphs) == 4 and graphs[0].pool_bytes > 0
    assert reserved[-1] - reserved[0] < 3 * graphs[0].pool_bytes / 4
    del engines, graphs
    pl._fused_frame_fn.cache_clear()


TICK_MODES = [(None, "layer"), (None, "group"), ("int8", "group")]


@pytest.mark.parametrize("quant,fusion", TICK_MODES)
def test_fused_tick_equals_solo_frames(cuda, monkeypatch, quant, fusion):
    """Three tenants (3, 3 and 2 frames) with pinned capacity: each tenant's
    frames torch.equal to the same tenant served solo, round-robin order,
    one graph per live count (3, then 2), and a second run replays without
    a capture or a wrapper call, its launches the captures' deltas."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import SwitchingConfig
    stable = SwitchingConfig(frame_high=10 ** 9, frame_low=0)
    tenants = [[_fused_frame(10 * s + i) for i in range(n)] for s, n in enumerate((3, 3, 2))]
    plan = ExecutionPlan(dispatch="fused", quant=quant, fusion=fusion, capacity=(0, 24, 24))
    solo = SREngine.from_config(ESSRConfig(scale=4), seed=5, plan=plan, switching=stable)
    mux = SREngine(solo.model, plan=plan.replace(streams=3), switching=stable)
    got = list(mux.serve_streams(tenants))
    assert [r.stream_id for r in got] == [0, 1, 2, 0, 1, 2, 0, 1]
    for s in range(3):
        one = SREngine(solo.model, plan=plan, switching=stable)
        for a, b in zip([r for r in got if r.stream_id == s], one.stream(tenants[s])):
            assert a.counts == b.counts and a.spill_counts == b.spill_counts == (0, 0, 0)
            assert torch.equal(a.ids, b.ids) and torch.equal(a.image, b.image)
            assert a.backend == b.backend and a.dispatch == "fused"
    ticks = pl._fused_stream_fn.values()
    assert sorted(t.streams for t in ticks) == [2, 3] and all(t.graph is not None for t in ticks)
    misses = pl._fused_stream_fn.occupancy()["misses"]
    calls = _entry_calls(monkeypatch)
    ops.reset_launch_counts()
    again = list(mux.serve_streams(tenants))
    assert calls == [] and pl._fused_stream_fn.occupancy()["misses"] == misses
    want = {}
    for t, n_ticks in zip(sorted(ticks, key=lambda t: t.streams), (1, 2)):
        for k, v in t.launches.items():
            want[k] = want.get(k, 0) + n_ticks * v
    assert {k: v for k, v in ops.launch_counts().items() if v} == want
    for a, b in zip(got, again):
        assert torch.equal(a.image, b.image)
    del ticks
    pl._fused_stream_fn.cache_clear()
    pl._fused_frame_fn.cache_clear()


def test_fused_ticks_in_flight_equal_synchronous(cuda):
    from repro_torch.core import pipeline as pl
    from repro_torch.core.adaptive import SwitchingConfig
    stable = SwitchingConfig(frame_high=10 ** 9, frame_low=0)
    tenants = [[_fused_frame(20 * s + i) for i in range(n)] for s, n in enumerate((4, 3))]
    runs = {}
    for n in (1, 2):
        eng = SREngine.from_config(ESSRConfig(scale=4), seed=5, switching=stable,
                                   plan=ExecutionPlan(dispatch="fused", streams=2, inflight=n))
        runs[n] = list(eng.serve_streams(tenants))
    assert [r.stream_id for r in runs[1]] == [r.stream_id for r in runs[2]] == [0, 1] * 3 + [0]
    for a, b in zip(runs[1], runs[2]):
        assert a.counts == b.counts and torch.equal(a.image, b.image)
    pl._fused_stream_fn.cache_clear()


def test_ladder_steps_down_on_the_card(cuda):
    """Injected backend failures on every launch: the fp32 group engine
    steps to the layer chain, then to the plain model, then retries at the
    floor; each frame says what served it, the layer frame is torch.equal
    to the group frame of an engine without faults, and the ledger equals
    the same engine's on the CPU."""
    from repro_torch.core import pipeline as pl
    from repro_torch.runtime.guard import FaultPlan
    plan = ExecutionPlan(dispatch="fused", fusion="group",
                         faults=FaultPlan(seed=4, backend_failure_rate=1.0))
    frames = [_fused_frame(s) for s in range(3)]
    card = SREngine.from_config(ESSRConfig(scale=4), seed=5, plan=plan)
    outs = [card.upscale(f) for f in frames]
    assert [o.degraded for o in outs] == [("fusion:group->layer",), ("backend:->ref",),
                                          ("retry",)]
    assert [o.backend for o in outs] == ["cuda", "ref", "ref"]
    clean = SREngine(card.model, plan=plan.replace(faults=None))
    assert torch.equal(outs[0].image, clean.upscale(frames[0]).image)
    want = clean.upscale(frames[1]).image
    np.testing.assert_allclose(outs[1].image.cpu().numpy(), want.cpu().numpy(), **CHAIN_TOL)
    assert clean.guard.level == 0 and clean.guard.events == []
    cpu = SREngine.from_config(ESSRConfig(scale=4), seed=5, plan=plan, device="cpu")
    for f in frames:
        cpu.upscale(f)
    assert card.summary()["degradations"] == cpu.summary()["degradations"]
    pl._fused_frame_fn.cache_clear()


@pytest.mark.parametrize("tenants", [1, 2])
def test_kernel_failure_without_faults_raises_on_the_card(cuda, monkeypatch, tenants):
    """A kernel entry that fails on the card, with no FaultPlan (capacity
    pinned, so the first launch is the capture's warm-up): the frame (or the
    tick) raises, the ladder stays at level 0 with one "failure"
    event, and nothing is served by the plain versions in its place."""
    from repro_torch.core import pipeline as pl
    from repro_torch.kernels import _build
    pl._fused_frame_fn.cache_clear()
    pl._fused_stream_fn.cache_clear()

    def broken(*args):
        raise RuntimeError("kernel entry failed")

    monkeypatch.setattr(_build, "entry", broken)
    eng = SREngine.from_config(ESSRConfig(scale=4), seed=5,
                               plan=ExecutionPlan(dispatch="fused", fusion="group",
                                                  streams=tenants, capacity=(0, 24, 24)))
    frames = [[_fused_frame(s)] for s in range(tenants)]
    with pytest.raises(RuntimeError, match="kernel entry failed"):
        if tenants == 1:
            eng.upscale(frames[0][0])
        else:
            list(eng.serve_streams(frames))
    assert eng.guard.level == 0 and [e["kind"] for e in eng.guard.events] == ["failure"]
    assert pl._fused_frame_fn.occupancy()["size"] == 0
    assert pl._fused_stream_fn.occupancy()["size"] == 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the sharded patch stream and training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,fusion", [(None, "layer"), (None, "group"), ("int8", "layer"),
                                          ("int8", "group")])
def test_sharded_forward_on_the_card_equals_unsplit(cuda, quant, fusion):
    """The split forward over the card named four times, at N not a
    multiple of four: torch.equal to the unsplit kernels (each patch is
    computed on its own), one launch of each kernel a chunk."""
    from repro_torch.core.pipeline import _sharded_forward, resolve_forward
    eng = SREngine.from_config(ESSRConfig(scale=2), plan=ExecutionPlan(quant=quant),
                               device="cuda")
    x = torch.rand((103, 32, 32, 3), generator=torch.Generator().manual_seed(0)).cuda()
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = _sharded_forward(eng.params, x, eng.cfg, 54, devices=("cuda:0",) * 4,
                               backend="cuda", quant=eng.qpack, fusion=fusion)
        counts = ops.launch_counts()
        want = resolve_forward("cuda", eng.qpack, fusion)(eng.params, x, eng.cfg, 54)
    assert torch.equal(got, want)
    kernel = {(None, "layer"): "bsconv", (None, "group"): "mega", ("int8", "layer"): "qbsconv",
              ("int8", "group"): "qmega"}[(quant, fusion)]
    assert counts[kernel] == 4


@pytest.mark.parametrize("quant,fusion", [(None, "layer"), (None, "group"), ("int8", "layer"),
                                          ("int8", "group")])
def test_sharded_forward_over_several_cards_equals_one_card(cuda, quant, fusion):
    """The split forward over up to four real cards, from patches on the
    last of them: each card runs its chunk (its own current device) and
    holds its weight copy, and the gathered result, back on the patches'
    card, is torch.equal to the unsplit kernels on one card."""
    from repro_torch.core.pipeline import _sharded_forward, resolve_forward
    from repro_torch.launch.mesh import make_patch_devices
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA devices or more")
    devices = make_patch_devices(min(4, cards))
    eng = SREngine.from_config(ESSRConfig(scale=2), plan=ExecutionPlan(quant=quant),
                               device="cuda:0")
    x = torch.rand((103, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got = _sharded_forward(eng.params, x.to(devices[-1]), eng.cfg, 54, devices=devices,
                               backend="cuda", quant=eng.qpack, fusion=fusion)
        want = resolve_forward("cuda", eng.qpack, fusion)(eng.params, x.cuda(), eng.cfg, 54)
    assert got.device == devices[-1]
    assert torch.equal(got.cpu(), want.cpu())
    assert all(torch.cuda.memory_allocated(d) > 0 for d in devices)


def test_megakernel_gradient_on_the_card_matches_plain(cuda):
    """The megakernel's backward (the plain forward's, recomputed) for x and
    every weight leaf at C54, N = 4 32x32, normalized atol 1e-3."""
    from repro_torch.core.tree import tree_leaves
    model = ESSR(ESSRConfig(scale=4), generator=torch.Generator().manual_seed(1)).cuda()
    params, cfg = model.tree(), model.cfg
    leaves = tree_leaves(params)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(2)).cuda()
    x.requires_grad_(True)
    ops.reset_launch_counts()
    got = torch.autograd.grad(mk.essr_forward_megakernel(params, x, cfg).square().sum(),
                              [x] + leaves)
    assert ops.launch_counts()["mega"] == 1
    want = torch.autograd.grad(essr_forward(params, x, cfg).square().sum(), [x] + leaves)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) / scale <= 1e-3


@pytest.mark.parametrize("name", ["bicubic", "fsrcnn", "rlfn_pruned", "rlfn_base"])
def test_baseline_on_the_card_matches_the_cpu(cuda, name):
    """The baselines at their published widths (library convolutions) on a
    96x128 LR frame, against the same module on the CPU, rtol 1e-3 / atol
    1e-3, as chip_smoke phase 27 holds them."""
    from repro_torch.models import fsrcnn as F
    from repro_torch.models import rlfn as R
    from repro_torch.models.layers import bicubic_resize, rgb_to_luma
    g = torch.Generator().manual_seed(0)
    module = {"bicubic": None, "fsrcnn": F.init_fsrcnn(F.FSRCNNConfig(), g),
              "rlfn_pruned": R.init_rlfn(R.RLFN_PRUNED_X4, g),
              "rlfn_base": R.init_rlfn(R.RLFN_BASE_X4, g)}[name]
    x = torch.rand((1, 96, 128, 3), generator=torch.Generator().manual_seed(1))
    if name == "bicubic":
        def fn(t):
            return bicubic_resize(t, (384, 512))
    elif name == "fsrcnn":
        def fn(t):
            return module(rgb_to_luma(t)[..., None] / 255.0)
    else:
        fn = module
    with torch.inference_mode():
        want = fn(x)
        if module is not None:
            module.to(cuda)
        got = fn(x.to(cuda)).cpu()
    assert got.shape[1:3] == (384, 512)
    torch.testing.assert_close(got, want, **CHAIN_TOL)


def test_patching_helpers_on_the_card_equal_the_geometry(cuda):
    from repro_torch.core import patching as P
    x = torch.rand((270, 480, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    geom = P.get_geometry(270, 480, 32, 2, 4, "cuda")
    patches, pos = P.extract_patches(x)
    assert torch.equal(patches, geom.extract(x)) and np.array_equal(pos, geom.pos)
    sr = torch.rand((geom.n, 128, 128, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    torch.testing.assert_close(P.fuse_patches_average(sr, pos, 4, (1080, 1920)),
                               geom.fuse_average(sr), rtol=1e-6, atol=0)


def test_supervised_supernet_replay_on_the_card_is_bit_equal(cuda, tmp_path):
    """TrainSupervisor around the supernet step at C54 x4 on the card: a run
    with an injected failure at step 10 resumes at 8 and ends torch.equal
    to an uninterrupted run (params, optimizer state, EMA)."""
    import itertools
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core import supernet
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import patch_batches
    from repro_torch.runtime import fault_tolerance as FT
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import make_supervised_step, supernet_draws
    cfg, steps = ESSRConfig(scale=4), 12
    data = patch_batches(0, batch=4, lr_patch=24, scale=4, pool=4, pool_hw=128, device=cuda)
    draws = list(itertools.islice(supernet_draws(data, cfg, 0), steps))
    out = {}
    for fail_at in (None, 10):
        model = ESSR(cfg, generator=torch.Generator().manual_seed(0)).cuda()
        opt = O.lamb(O.cosine_decay(3e-3, steps))
        tree = model.tree()
        state = {"params": tree, "opt_state": opt.init(tree), "ema": supernet.ema_init(tree)}
        sup = FT.TrainSupervisor(make_supervised_step(cfg, opt), draws.__getitem__,
                                 CheckpointManager(str(tmp_path / str(fail_at))),
                                 FT.SupervisorConfig(ckpt_every=4))
        seen = []

        def hook(step, sup=sup, seen=seen, fail_at=fail_at):
            seen.append(step)
            if step == fail_at and not sup.restarts:
                raise FT.InjectedFailure("lost the card")

        out[fail_at] = (sup.run(state, 0, steps, failure_hook=hook), sup.restarts, seen)
    (clean, r0, _), (crashed, r1, seen) = out[None], out[10]
    assert (r0, r1) == (0, 1) and seen[seen.index(10) + 1] == 8
    for k in ("params", "opt_state", "ema"):
        for a, b in zip(tree_leaves(clean[k]), tree_leaves(crashed[k])):
            assert a.device.type == "cuda" and torch.equal(a, b)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device, copy=True)          # decode writes its caches in place


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["granite-8b", "deepseek-v3-671b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b"])
def test_lm_family_on_the_card_matches_the_cpu(cuda, name):
    """One representative a family (dense, MoE + MLA, Mamba-1, the hybrid
    shared block, enc-dec, the VLM prefix), SMOKE in fp32 from one init:
    prefill and one decode step on the card within rtol/atol 1e-3 (the
    whole-chain tolerance) of the CPU, logits and every cache leaf."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import encdec as E
    from repro_torch.models.lm import transformer as T
    from repro_torch.models.lm.params import ParamTree
    cfg = get_config(name, smoke=True)
    g = torch.Generator().manual_seed(0)
    init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
    cpu = init(cfg, generator=g, device="cpu", dtype=torch.float32)
    card = ParamTree(_tree_to(cpu.tree(), cuda))
    b, s, ml = 2, 16, 24
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    src = torch.randn((b, s, cfg.d_model), generator=g)
    pe = (torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=g)
          if cfg.frontend == "vision" else None)
    off = 0 if pe is None else pe.shape[1]
    runs = []
    with torch.inference_mode():
        for dev, params in (("cpu", cpu), (cuda, card)):
            t = toks.to(dev)
            if cfg.is_encoder_decoder:
                lp, caches = E.encdec_prefill(params, cfg, src.to(dev), t[:, :s], ml)
                pre = _tree_to(caches, "cpu")
                ld, caches = E.encdec_decode_step(params, cfg, t[:, s:], caches, s)
            else:
                lp, caches = T.lm_prefill(params, cfg, t[:, :s], ml + off,
                                          None if pe is None else pe.to(dev))
                pre = _tree_to(caches, "cpu")
                ld, caches = T.lm_decode_step(params, cfg, t[:, s:], caches, s + off)
            runs.append({"prefill": lp.cpu(), "prefill caches": pre, "decode": ld.cpu(),
                         "decode caches": _tree_to(caches, "cpu")})
    for key in runs[0]:
        want, got = dict(_leaves(runs[0][key])), dict(_leaves(runs[1][key]))
        assert set(want) == set(got)
        for leaf in want:
            torch.testing.assert_close(got[leaf], want[leaf], msg=f"{key}{leaf}", **CHAIN_TOL)


def _train_step_on(dev, cfg, start, batch, remat=True, lr=1e-2):
    """One make_train_step step of chain_clip(adam(lr), 1.0) on ``dev`` from
    a copy of ``start``: (loss, gradients, params after, first moments)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps as ST
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import value_and_grad
    tree = _tree_to(start, dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    _, grads = value_and_grad(ST.make_loss_fn(cfg, remat=remat), tree, batch)
    opt = O.chain_clip(O.adam(lr), 1.0)
    state, m = ST.make_train_step(cfg, opt, remat=remat)({"params": tree, "opt": opt.init(tree)},
                                                          batch)
    return (m["loss"].cpu(), [g.cpu() for g in tree_leaves(grads)],
            [p.detach().cpu() for p in tree_leaves(state["params"])],
            [t.cpu() for t in tree_leaves(state["opt"]["m"])])


def _lm_smoke_start(name):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import encdec as E
    from repro_torch.models.lm import transformer as T
    cfg = get_config(name, smoke=True)
    g = torch.Generator().manual_seed(0)
    init = E.init_encdec if cfg.is_encoder_decoder else T.init_lm
    start = init(cfg, generator=g, device="cpu", dtype=torch.float32).tree()
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["src_embeds"] = torch.randn((2, 16, cfg.d_model), generator=g)
    if cfg.frontend == "vision":
        batch["embeds"] = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), generator=g)
    return cfg, start, batch


@pytest.mark.parametrize("name", ["granite-8b", "deepseek-v3-671b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, name):
    """One training step a family (launch/steps.py make_train_step, remat
    on, SMOKE in fp32 from one init; embedding and MoE backward sum with
    atomics on the card): the loss and every gradient leaf within rtol
    1e-3 / atol 1e-3 x the leaf's largest of the CPU's; the parameters
    after the step within rtol/atol 1e-3, except where the CPU's gradient
    is within float noise of zero (below 1e-5 of the leaf's largest: Adam's
    first step is g / (|g| + eps), its sign not determined there), held to
    the step's size; the first moments as the gradients."""
    from repro_torch.core.tree import tree_leaves
    cfg, start, batch = _lm_smoke_start(name)
    (lc, gc, pc, mc), (lg, gg, pg, mg) = (_train_step_on(d, cfg, start, batch)
                                          for d in ("cpu", cuda))
    torch.testing.assert_close(lg, lc, **CHAIN_TOL)
    for what, got, want in (("grad", gg, gc), ("m", mg, mc)):
        for i, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * b.abs().max().item() + 1e-30,
                                       msg=f"{what} leaf {i}")
    for i, (a, b, p0, g) in enumerate(zip(pg, pc, tree_leaves(start), gc)):
        noise = g.abs() < 1e-5 * g.abs().max().item()
        torch.testing.assert_close(a[~noise], b[~noise], msg=f"param leaf {i}", **CHAIN_TOL)
        assert ((a - p0).abs()[noise] <= 1e-2 * (1 + 1e-3)).all(), f"param leaf {i}"


def test_lm_train_dynamic_width_on_the_card(cuda, monkeypatch):
    """granite-8b SMOKE_DYNWIDTH trained on the card with remat: every FFN
    call (forward and recompute) routes max(1, int(t / 2)) of its t tokens
    to the full width, the highest scores, each token once; the loss and
    the gradients within the whole-chain tolerance of the CPU's."""
    import dataclasses
    from repro_torch.models.lm import ffn as FF
    cfg, start, batch = _lm_smoke_start("granite-8b")
    cfg = dataclasses.replace(cfg, dynamic_width=True)
    log, split = [], FF.dynamic_width_split

    def recorded(xf, frac):
        full, half, score = split(xf, frac)
        log.append((xf.shape[0], xf.device.type, full, half, score.detach()))
        return full, half, score

    monkeypatch.setattr(FF, "dynamic_width_split", recorded)
    (lc, gc, _, _), (lg, gg, _, _) = (_train_step_on(d, cfg, start, batch) for d in ("cpu", cuda))
    card = [r for r in log if r[1] == "cuda"]
    assert len(card) == 2 * 2 * cfg.n_layers          # value_and_grad and the step, each x2
    for t, _, full, half, score in card:
        assert full.numel() == max(1, int(t * 0.5)) and full.numel() + half.numel() == t
        assert torch.equal(torch.sort(torch.cat([full, half])).values,
                           torch.arange(t, device=full.device))
        assert score[full].min() >= score[half].max()
    torch.testing.assert_close(lg, lc, **CHAIN_TOL)
    for i, (a, b) in enumerate(zip(gg, gc)):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * b.abs().max().item() + 1e-30,
                                   msg=f"grad leaf {i}")
