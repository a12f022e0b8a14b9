"""The port's subnet-group megakernel path (``kernels/megakernel.py``,
``ExecutionPlan(fusion="group")``) against ``repro.kernels.megakernel`` and
``repro.api.SREngine`` on the same weights and inputs, on the CPU (the
wrapper takes its plain version there), plus the wrapper's operand checks,
the packed weights, the sizing report and the build key.

Tolerances: the toy chain rtol 1e-4 / atol 1e-5, as tests/test_megakernel.py
holds the JAX megakernel against its reference; the x4 chain and the golden
frame rtol 1e-3 / atol 1e-3, the whole-chain tolerance of
tests/test_kernels.py:77 (12 fp32 layers with intermediates of O(100) sum in
different orders in XLA and PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import SREngine as JEngine
from repro.core import pipeline as jpipe
from repro.data.synthetic import degrade, random_image
from repro.kernels import megakernel as jmk
from repro.models.essr import ESSR_X4, essr_forward, essr_macs_per_lr_pixel, init_essr
from repro.models.essr import ESSRConfig as JCfg
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.core import pipeline
from repro_torch.kernels import _build, ops
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels.ref import mega_ref
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.essr import ESSR_X4 as T_X4
from repro_torch.models.essr import ESSRConfig

TOY, JTOY = ESSRConfig(scale=2, n_sfb=2, channels=8), JCfg(scale=2, n_sfb=2, channels=8)
TOY_TOL = dict(rtol=1e-4, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-3, atol=1e-3)
GOLDEN_COUNTS = (10, 2, 13)


def _golden_frame(hw: int = 128, seed: int = 1234) -> np.ndarray:
    """The mixed smooth/texture frame of tests/test_fused_dispatch.py."""
    yy, xx = jnp.meshgrid(jnp.linspace(0, 1, hw), jnp.linspace(0, 1, hw), indexing="ij")
    smooth = jnp.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = degrade(jnp.asarray(random_image(seed, 2 * hw, 2 * hw)), 2)
    return np.asarray(jnp.where((yy < 0.5)[..., None], smooth, tex))


def _tree(jcfg, seed: int):
    """The reference's init with seeded non-zero biases (a halo reading
    pw(0) + b instead of 0 would show), as numpy leaves."""
    tree = jax.tree_util.tree_map(np.asarray, init_essr(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (0.1 * r.standard_normal(v.shape)).astype(np.float32) if v.ndim == 1 else v,
        tree)


def _port(tree, cfg):
    return params_from_numpy(tree, cfg).tree()


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_toy_megakernel_matches_pallas_interpret(width, n):
    tree = _tree(JTOY, 0)
    x = np.random.default_rng(n).random((n, 32, 32, 3), dtype=np.float32)
    want = jmk.essr_forward_megakernel(tree, jnp.asarray(x), JTOY, width=width, interpret=True)
    with torch.no_grad():
        got = mk.essr_forward_megakernel(_port(tree, TOY), torch.from_numpy(x), TOY, width=width)
    assert tuple(got.shape) == (n, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOY_TOL)


@pytest.mark.parametrize("width", [27, 54])
def test_x4_megakernel_matches_reference_and_layer_chain(width):
    tree = _tree(ESSR_X4, 4)
    x = np.random.default_rng(width).random((2, 16, 16, 3), dtype=np.float32)
    params = _port(tree, T_X4)
    with torch.no_grad():
        got = mk.essr_forward_megakernel(params, torch.from_numpy(x), T_X4, width=width)
        layer = ops.essr_forward_kernels(params, torch.from_numpy(x), T_X4, width=width)
    want = essr_forward(tree, jnp.asarray(x), ESSR_X4, width=width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
    np.testing.assert_allclose(got.numpy(), layer.numpy(), **CHAIN_TOL)


def test_group_engine_golden_frame_matches_reference():
    ref = JEngine.from_config(JCfg(scale=2), seed=1, backend="ref", plan=JPlan(fusion="group"))
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    eng = SREngine.from_params(tree, ESSRConfig(scale=2), plan=ExecutionPlan(fusion="group"),
                               device="cpu")
    frame = _golden_frame()
    rj, rp = ref.upscale(frame), eng.upscale(frame)
    assert rp.counts == rj.counts == GOLDEN_COUNTS
    assert rp.backend == "cuda-plain" and eng.plan.fusion == "group" and eng.summary() == {}
    np.testing.assert_array_equal(rp.ids, np.asarray(rj.ids))
    np.testing.assert_allclose(rp.image.numpy(), np.asarray(rj.image), **CHAIN_TOL)
    # the warm-up key carries the fusion: the layer plan's first frame pays again
    assert eng.upscale(frame).compiled is True
    assert eng.upscale(frame, plan=ExecutionPlan()).compiled is False


def test_resolve_forward_fusion():
    # (backend, quant, fusion): the reference's argument order
    assert pipeline.resolve_forward("cuda", fusion="group") is pipeline._forward_width_mega
    assert pipeline.resolve_forward("cuda") is pipeline._forward_width_cuda
    assert pipeline.resolve_forward("ref", None, "group") is pipeline._forward_width
    with pytest.raises(ValueError) as mine:
        pipeline.resolve_forward("cuda", fusion="tile")
    with pytest.raises(ValueError) as theirs:
        jpipe.resolve_forward("pallas", fusion="tile")
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown backend"):
        pipeline.resolve_forward("pallas", fusion="group")


@pytest.mark.parametrize("width", [27, 54])
@pytest.mark.parametrize("scale", [2, 4])
def test_group_report_fits_a_block(width, scale):
    rep = mk.group_report(width, 32, scale)
    assert rep["smem_bytes"] <= mk.SMEM_LIMIT == 232_448
    assert (rep["cluster"], rep["rows_per_cta"]) == (8, 4)
    assert 64 <= rep["threads"] <= 512 and rep["threads"] % 32 == 0
    macs = essr_macs_per_lr_pixel(JCfg(scale=scale, channels=width))
    assert rep["flops_per_patch"] == 2 * macs * 32 * 32
    assert rep["bytes_per_patch"] == 4 * 32 * 32 * (3 + 3 * scale * scale)
    assert rep["bound"] == "operations"
    assert rep["weight_floats"] == mk.WeightLayout(3, width, 3 * scale * scale, 5).size


def test_group_report_sizes_and_limits():
    # C54 x4 at 32x32 is ~1.64 ms of fp32 operations for 1024 patches at 67 TFLOP/s
    rep = mk.group_report(54, 32, 4)
    assert rep["flops_per_patch"] * 1024 / 67e12 * 1e3 == pytest.approx(1.638, abs=1e-3)
    assert rep["smem_bytes"] == 186_144 and rep["weight_bytes"] == 4 * 53_886
    odd = mk.group_report(54, (13, 21), 4)
    assert odd["rows_per_cta"] == 2 and odd["smem_bytes"] < rep["smem_bytes"]
    with pytest.raises(ValueError, match="232448 B"):
        mk.group_report(54, 64, 4)
    with pytest.raises(ValueError, match="positive"):
        mk.group_report(0, 32, 4)


def test_pack_unpack_round_trip_and_cache():
    tree = _port(_tree(ESSR_X4, 2), T_X4)
    for width in (27, 54):
        lay = mk.WeightLayout(3, width, 48, 5)
        wbuf = mk.pack_weights(tree, width)
        assert tuple(wbuf.shape) == (lay.size,) and wbuf.dtype == torch.float32
        w = mk.unpack_weights(wbuf, lay)
        first = tree["first"]
        np.testing.assert_array_equal(w["first"]["pw"].numpy(),
                                      first["pw"][0, 0, :, :width].detach().numpy())
        s = tree["sfbs"][3]
        np.testing.assert_array_equal(w["sfbs"][3]["b2_dw"].numpy(),
                                      s["b2"]["dw"][:, :, 0, :width].detach().numpy())
        np.testing.assert_array_equal(w["sfbs"][3]["fuse_b"].numpy(),
                                      s["fuse_b"][:width].detach().numpy())
        np.testing.assert_array_equal(w["recon"]["pw"].numpy(),
                                      tree["recon"]["pw"][0, 0, :width].detach().numpy())
        cp = (width + 3) // 4 * 4
        pad = wbuf[lay.first:lay.first + cp * cp].view(cp, cp)
        assert not pad[width:].any() and not pad[:, width:].any()
    a = mk.packed_weights(mk._TreeKey(tree), 54)
    assert mk.packed_weights(mk._TreeKey(tree), 54) is a
    assert mk.packed_weights(mk._TreeKey(tree), 27) is not a
    with torch.no_grad():
        tree["sfbs"][0]["fuse"].mul_(2.0)          # an in-place update repacks
    assert mk.packed_weights(mk._TreeKey(tree), 54) is not a


def test_mega_wrapper_checks_and_launches_nothing_on_cpu():
    tree = _port(_tree(ESSR_X4, 3), T_X4)
    wbuf = mk.pack_weights(tree, 27)
    x = torch.rand((2, 8, 8, 3))
    kw = dict(width=27, n_sfb=5, out_channels=48)
    ops.reset_launch_counts()
    out = mk.mega_fused(x, wbuf, **kw)
    assert tuple(out.shape) == (2, 8, 8, 48)
    np.testing.assert_allclose(out.numpy(), mega_ref(x, mk.unpack_weights(
        wbuf, mk.WeightLayout(3, 27, 48, 5))).numpy(), rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32"):
        mk.mega_fused(x.double(), wbuf, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mega_fused(x.transpose(1, 2), wbuf, **kw)
    with pytest.raises(ValueError, match="N,H,W,C"):
        mk.mega_fused(x[0], wbuf, **kw)
    with pytest.raises(ValueError, match="wbuf shape"):
        mk.mega_fused(x, wbuf[:-4], **kw)
    with pytest.raises(ValueError, match="wbuf shape"):
        mk.mega_fused(x, wbuf, width=54, n_sfb=5, out_channels=48)
    with pytest.raises(ValueError, match="1..64"):
        mk.mega_fused(x, wbuf, width=72, n_sfb=5, out_channels=48)
    with pytest.raises(ValueError, match="232448 B"):
        mk.mega_fused(torch.rand((1, 64, 64, 3)), mk.pack_weights(tree, 54), width=54,
                      n_sfb=5, out_channels=48)
    with torch.no_grad():
        empty = mk.essr_forward_megakernel(tree, torch.zeros((0, 32, 32, 3)), T_X4, width=54)
        assert tuple(empty.shape) == (0, 128, 128, 3)
        with pytest.raises(ValueError, match="bilinear"):
            mk.essr_forward_megakernel(tree, x, T_X4, width=0)
        with pytest.raises(ValueError, match="outside 1..54"):
            mk.essr_forward_megakernel(tree, x, T_X4, width=60)
    assert ops.launch_counts() == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0,
                                   "quantize": 0, "qbsconv": 0, "qsfb": 0, "qdsconv": 0,
                                   "qmega": 0, "edge": 0}


def test_build_key_of_the_megakernel():
    assert (_build.CSRC / "mega.cu").exists()
    key = _build.source_key("mega")
    assert len(key) == 16 and _build.library_path("mega").name == f"mega-{key}.so"
    assert key not in {_build.source_key(n) for n in ("bsconv", "sfb", "dsconv")}
    src = (_build.CSRC / "mega.cu").read_text()
    # the cluster launch and halo exchange live in the header shared with qmega.cu
    cluster = (_build.CSRC / "cluster.cuh").read_text()
    assert 'extern "C" int mega_forward(' in src and '#include "cluster.cuh"' in src
    assert "cudaLaunchAttributeClusterDimension" in cluster
