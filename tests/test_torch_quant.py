"""The port's PAMS quantized serving (``quant/pams.py``, ``kernels/qconv.py``,
``ExecutionPlan(quant=...)``) against ``repro.quant.pams``,
``repro.kernels.qconv`` and ``repro.api.SREngine`` on the same weights and
inputs, on the CPU (the kernel wrappers take their plain versions there).

Contracts, and why:
  * quantizer ops, weight codes, folded scales and site constants are
    bit-equal to the reference (the same float32 arithmetic);
  * calibration alphas within rtol 1e-6 (the fp forwards sum in different
    orders; measured <= 1.4e-7), as tests/test_quant.py holds its own;
  * codes of the integer chain are bit-equal at every site to the JAX
    ``essr_forward_qref`` run eagerly (``jax.disable_jit``: op by op, as
    PyTorch runs). At the small config they also equal the jit'd reference
    in all but one case; in that one (fxp10, width 4) the jit'd reference
    flips 1 code at sfb1_out and 11 at recon against its own eager run (XLA
    contracts mul + add into an FMA), so the port is held to it at |diff| <=
    1 code. At full width (C54, 5 SFBs) the jit'd reference is further from
    its eager run (up to 6 steps), so the port is held to the eager one
    only: bit-equal at every site but
    ``recon``, whose fp 1x1 sums in another order (the port's plain version
    fixes the order the CUDA kernel keeps); there |diff| <= 1 code (measured:
    1 code of 49152 in one of the four cases);
  * the fake-quant "ref" backend is held to the eager JAX forward at one
    step of ``s_recon`` (measured: 0 steps; the jit'd forward is 1 step off
    on 1 of 8640 values);
  * an engine frame equals its routed buckets run through the eager JAX
    ``essr_forward_qref`` by hand at atol ``s_recon`` (one code step), and
    quant costs < 0.6 dB PSNR-Y against the fp32 engine (the paper's
    budget, tests/test_quant_conformance.py).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.data.synthetic import degrade, random_image
from repro.kernels import qconv as jq
from repro.models.essr import ESSRConfig as JCfg
from repro.models.essr import init_essr
from repro.models.layers import bilinear_resize as j_bilinear
from repro.quant import pams as jp
from repro.train.losses import psnr_y
from repro_torch.api import ExecutionPlan, SREngine
from repro_torch.api.engine import default_calibration_batch
from repro_torch.core import pipeline
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import _build, ops
from repro_torch.kernels import qconv as tq
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.essr import ESSRConfig
from repro_torch.quant import pams as tp

TOY, JTOY = ESSRConfig(scale=2, channels=8, n_sfb=2), JCfg(scale=2, channels=8, n_sfb=2)
X2, JX2 = ESSRConfig(scale=2), JCfg(scale=2)
GOLDEN_COUNTS = (10, 2, 13)


def _with_biases(tree, seed):
    """A reference param tree with non-zero biases (a padding that read
    pw(0) + b instead of 0 would show)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k.endswith("_b") else walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return np.asarray(t)
    return walk(tree)


def _trees(jcfg, cfg, seed=3):
    tree = _with_biases(jax.tree_util.tree_map(np.asarray,
                                               init_essr(jax.random.PRNGKey(seed), jcfg)), seed)
    return tree, params_from_numpy(tree, cfg).tree()


def _port_pack(pack) -> tp.QuantPack:
    return tp.QuantPack(mode=pack.mode, bits=pack.bits,
                        per_channel_weights=pack.per_channel_weights,
                        act_percentile=pack.act_percentile, scales=pack.scales)


def _jax_pack(pack) -> jp.QuantPack:
    return jp.QuantPack(mode=pack.mode, bits=pack.bits,
                        per_channel_weights=pack.per_channel_weights,
                        act_percentile=pack.act_percentile, scales=pack.scales)


@pytest.fixture(scope="module")
def toy():
    tree, params = _trees(JTOY, TOY)
    x = np.random.default_rng(0).random((7, 12, 12, 3), dtype=np.float32)
    packs = {(m, pc): jp.build_quant_pack(tree, JTOY, m, jnp.asarray(x), per_channel_weights=pc)
             for m in ("int8", "fxp10") for pc in (True, False)}
    return tree, params, x, packs


# ---------------------------------------------------------------------------
# 1. the quantizer and the prepared operands, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qmax", [127, 511])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantizer_ops_bit_equal(qmax, per_channel):
    rng = np.random.default_rng(qmax)
    w = (0.3 * rng.standard_normal((3, 3, 5, 6))).astype(np.float32)
    x = (2.0 * rng.standard_normal((4, 6, 6, 6))).astype(np.float32)
    ja = jp.weight_alpha(jnp.asarray(w), per_channel)
    ta = tp.weight_alpha(torch.from_numpy(w), per_channel)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for alpha in (np.float32(1.3), np.float32(1e-14)):     # incl. the EPS step floor
        a_j, a_t = jnp.asarray(alpha), torch.tensor(alpha)
        np.testing.assert_array_equal(tp.int_codes(torch.from_numpy(x), a_t, qmax).numpy(),
                                      np.asarray(jp.int_codes(jnp.asarray(x), a_j, qmax)))
        np.testing.assert_array_equal(tp.quantize(torch.from_numpy(x), a_t, qmax).numpy(),
                                      np.asarray(jp.quantize(jnp.asarray(x), a_j, qmax)))
    jc, js = jq._qweight(jnp.asarray(w), per_channel, qmax)
    tc, ts = tq._qweight(torch.from_numpy(w), per_channel, qmax)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(ts.shape) == (1, 1, 1, 6)
    for raw in (0.7, -2.5, 0.0, 1e-13):
        assert tq.act_qconsts(raw, qmax) == jq.act_qconsts(raw, qmax)


@pytest.mark.parametrize("bits", [8, 10])
def test_quantize_codes_at_edge_values_equal_eager_reference(bits):
    """quantize_fused (its plain version on the CPU) against the JAX eager
    _quantize_math at the values a code can go wrong on: 0 and -0.0 (code 0,
    which the kernel writes without dividing), +-a, values past +-a, and
    half-step ties (k + 0.5) s, which round half to even; at a step that is a
    power of two (every tie exact) and at a calibrated-looking one; n % 4 != 0
    and a storage offset of one element, both code types."""
    qmax = 127 if bits <= 8 else 511
    dtype = torch.int8 if bits <= 8 else torch.int32
    for a in (qmax / 128.0, 0.7310345):
        a = float(np.float32(a))
        s = float(np.float32(a) / np.float32(qmax))
        ties = (np.arange(-qmax - 1, qmax + 1, dtype=np.float32) + np.float32(0.5)) * np.float32(s)
        special = np.array([0.0, -0.0, a, -a, 1.5 * a, -1.5 * a, 1e30, -1e30, s, -s],
                           np.float32)
        noise = (3 * a * np.random.default_rng(bits).standard_normal(37)).astype(np.float32)
        vals = np.concatenate([special, ties, noise])
        store = np.concatenate([np.float32([7.0]), vals])         # offset 1 element
        x = torch.from_numpy(store)[1:].view(1, 1, -1, 1)
        assert x.storage_offset() == 1 and x.numel() % 4 != 0
        qc = torch.tensor([a, s], dtype=torch.float32)
        got = tq.quantize_fused(x, qc, bits=bits)
        with jax.disable_jit():
            want = np.asarray(jq._quantize_math(jnp.asarray(vals), a, s, jp.code_dtype(bits)))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.view(-1).numpy(), want)
        assert got.view(-1)[:2].tolist() == [0, 0] and got.abs().max().item() == qmax
        if a == qmax / 128.0:               # exact ties: half to even, both ways
            k = np.arange(-qmax - 1, qmax + 1)
            even = np.where(k % 2 == 0, k, k + 1)
            np.testing.assert_array_equal(want[special.size:special.size + ties.size],
                                          np.clip(even, -qmax, qmax))


def test_weight_tree_and_codes_dtype():
    tree, params = _trees(JTOY, TOY)
    qcfg = jp.QuantConfig(bits=8)
    want = jp.quantize_weight_tree(tree, qcfg)
    got = tp.quantize_weight_tree(params, tp.QuantConfig(bits=8))
    for a, b in zip(tp._tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert tp.code_dtype(8) == torch.int8 and tp.code_dtype(10) == torch.int32
    assert tp._act_points(TOY) == jp._act_points(JTOY)


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("width", [8, 4])
def test_prepare_qparams_bit_equal(toy, mode, per_channel, width):
    tree, params, _, packs = toy
    pack = packs[(mode, per_channel)]
    jq_, jc = jq.prepare_qparams(tree, JTOY, width, pack)
    tq_, tc = tq.prepare_qparams(params, TOY, width, _port_pack(pack))
    assert tc == jc

    def same(mine, theirs):
        theirs = np.asarray(theirs)
        assert mine.numpy().dtype == theirs.dtype and mine.is_contiguous()
        np.testing.assert_array_equal(mine.numpy(), theirs)

    for grp in ("first", "recon"):
        for k, v in jq_[grp].items():
            same(tq_[grp][k], v)
    for mine, theirs in zip(tq_["sfbs"], jq_["sfbs"]):
        for k, v in theirs.items():
            same(mine[k], v)
    sites = jp._act_points(JTOY)
    np.testing.assert_array_equal(
        tq_["consts"].numpy(),
        np.array([jc[f"{p}_{s}"] for s in sites for p in ("a", "s")], np.float32))
    assert tq_["sfbs"][1]["qc"].tolist() == [v for v in jq._sfb_consts(jc, 1)]
    assert tq_["recon"]["qc"].tolist() == [jc["a_recon"], jc["s_recon"]]


# ---------------------------------------------------------------------------
# 2. calibration, the pack and its cache across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_valid", [None, 5])
def test_calibration_alphas_match(toy, n_valid):
    tree, params, x, _ = toy
    want = jp.calibrate_act_scales(tree, JTOY, jnp.asarray(x), n_valid=n_valid)
    got = tp.calibrate_act_scales(params, TOY, torch.from_numpy(x), n_valid=n_valid)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    jpack = jp.build_quant_pack(tree, JTOY, "fxp10", jnp.asarray(x), n_valid=n_valid)
    tpack = tp.build_quant_pack(params, TOY, "fxp10", torch.from_numpy(x), n_valid=n_valid)
    assert tpack.widths() == jpack.widths() == (4, 8)
    for w in (4, 8):
        a, b = tpack.act_scales(w), jpack.act_scales(w)
        assert list(a) == list(b)
        np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=1e-6)
    with pytest.raises(ValueError, match="n_valid"):
        tp.calibrate_act_scales(params, TOY, torch.from_numpy(x), n_valid=0)


def test_percentile_matches_reference_positions():
    for n in (2, 3, 100, 2880, 10001):
        t = np.random.default_rng(n).random(n, dtype=np.float32)
        assert float(tp._percentile(torch.from_numpy(t), 99.9)) == pytest.approx(
            float(jnp.percentile(jnp.asarray(t), 99.9)), rel=1e-6)


def test_default_calibration_batch_and_synthetic_images():
    from repro.api.engine import default_calibration_batch as j_batch
    got = default_calibration_batch(8, 2, n=4)
    want = np.asarray(j_batch(8, 2, n=4))
    assert tuple(got.shape) == want.shape == (4, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    hr = random_image(300, 64, 96)
    np.testing.assert_allclose(tsyn.random_image(300, 64, 96), hr, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tsyn.degrade(hr, 2).numpy(), np.asarray(degrade(jnp.asarray(hr), 2)),
                               atol=1e-5, rtol=0)


def test_quant_pack_shared_both_ways(toy, tmp_path):
    tree, params, x, packs = toy
    jfp = jp.params_fingerprint(tree)
    assert tp.params_fingerprint(params) == jfp
    pack = packs[("int8", True)]
    jp.save_quant_pack(str(tmp_path / "j.json"), pack, jfp)
    got = tp.load_quant_pack(str(tmp_path / "j.json"), jfp)
    assert got == _port_pack(pack) and hash(got) == hash(_port_pack(pack))
    tpack = tp.build_quant_pack(params, TOY, "fxp10", torch.from_numpy(x))
    tp.save_quant_pack(str(tmp_path / "t.json"), tpack, jfp)
    assert jp.load_quant_pack(str(tmp_path / "t.json"), jfp) == _jax_pack(tpack)
    assert (tmp_path / "t.json").read_text() == _jax_saved(tmp_path, _jax_pack(tpack), jfp)
    assert tp.load_quant_pack(str(tmp_path / "t.json"), "another") is None
    assert tp.load_quant_pack(str(tmp_path / "missing.json"), jfp) is None
    bad = json.loads((tmp_path / "t.json").read_text())
    bad["scales"]["4"]["in"] = 9.0
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.warns(UserWarning, match="corrupted"):
        assert tp.load_quant_pack(str(tmp_path / "bad.json"), jfp) is None
    with pytest.raises(ValueError, match="quant mode"):
        tp.QuantPack(mode="fp4", bits=4, per_channel_weights=True, act_percentile=99.9,
                     scales=())


def _jax_saved(tmp_path, pack, fp) -> str:
    jp.save_quant_pack(str(tmp_path / "j2.json"), pack, fp)
    return (tmp_path / "j2.json").read_text()


# ---------------------------------------------------------------------------
# 3. the integer chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("n", [1, 5, 7])
def test_chain_small_config_bit_equal(toy, mode, width, n):
    tree, params, x, packs = toy
    pack = packs[(mode, True)]
    xb = x[:n]
    with torch.no_grad():
        img, codes = tq.essr_forward_qref(params, torch.from_numpy(xb), TOY, width,
                                          pack=_port_pack(pack), return_codes=True)
        kimg = tq.essr_forward_qkernels(params, torch.from_numpy(xb), TOY, width,
                                        pack=_port_pack(pack))
    assert torch.equal(kimg, img)
    with jax.disable_jit():
        eimg, ecodes = jq.essr_forward_qref(tree, jnp.asarray(xb), JTOY, width, pack=pack,
                                            return_codes=True)
    assert list(codes) == list(ecodes)
    for site, c in codes.items():
        np.testing.assert_array_equal(c.numpy(), np.asarray(ecodes[site]), err_msg=site)
    np.testing.assert_array_equal(img.numpy(), np.asarray(eimg))
    # the jit'd reference flips a few codes of its own eager run here (fxp10
    # at width 4: 1 code at sfb1_out, 11 at recon, |diff| 1; ROADMAP queue 3)
    _, jcodes = jq.essr_forward_qref(tree, jnp.asarray(xb), JTOY, width, pack=pack,
                                     return_codes=True)
    for site, c in codes.items():
        diff = np.abs(c.numpy().astype(np.int64) - np.asarray(jcodes[site]).astype(np.int64))
        print(f"{mode} C{width} N={n} {site}: {int((diff > 0).sum())} codes differ from jit")
        assert diff.max() <= 1, site


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("width", [27, 54])
def test_chain_full_width_matches_eager_reference(mode, width):
    tree, params = _trees(JX2, X2, seed=1)
    lr = np.asarray(degrade(jnp.asarray(random_image(300, 192, 192)), 2))
    x = np.stack([lr[0:32, 0:32], lr[0:32, 32:64], lr[32:64, 0:32], lr[64:96, 64:96]])
    pack = jp.build_quant_pack(tree, JX2, mode, jnp.asarray(x))
    with torch.no_grad():
        _, codes = tq.essr_forward_qref(params, torch.from_numpy(x), X2, width,
                                        pack=_port_pack(pack), return_codes=True)
    with jax.disable_jit():
        _, ecodes = jq.essr_forward_qref(tree, jnp.asarray(x), JX2, width, pack=pack,
                                         return_codes=True)
    for site, c in codes.items():
        diff = np.abs(c.numpy().astype(np.int64) - np.asarray(ecodes[site]).astype(np.int64))
        print(f"{mode} C{width} {site}: {int((diff > 0).sum())} of {diff.size} codes differ")
        if site == "recon":
            assert diff.max() <= 1
        else:
            assert diff.max() == 0, site


def test_chain_empty_bucket_and_width_checks(toy):
    tree, params, x, packs = toy
    pack = _port_pack(packs[("int8", True)])
    ops.reset_launch_counts()
    with torch.no_grad():
        out = tq.essr_forward_qkernels(params, torch.zeros((0, 12, 12, 3)), TOY, 8, pack=pack)
        assert tuple(out.shape) == (0, 24, 24, 3)
        tq.essr_forward_qkernels(params, torch.from_numpy(x[:2]), TOY, 4, pack=pack)
        with pytest.raises(ValueError, match="bilinear"):
            tq.essr_forward_qkernels(params, torch.from_numpy(x), TOY, 0, pack=pack)
        with pytest.raises(ValueError, match="outside 1..8"):
            tq.essr_forward_qref(params, torch.from_numpy(x), TOY, 16, pack=pack)
    counts = ops.launch_counts()
    assert counts == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0,
                      "quantize": 0, "qbsconv": 0, "qsfb": 0, "qdsconv": 0,
                      "qmega": 0, "edge": 0}


def test_prepared_operands_are_cached_by_tree_version(toy):
    _, params, x, packs = toy
    pack = _port_pack(packs[("fxp10", True)])
    tq.prepared_qparams.cache_clear()
    with torch.no_grad():
        a = tq.essr_forward_qref(params, torch.from_numpy(x), TOY, 8, pack=pack)
        tq.essr_forward_qref(params, torch.from_numpy(x), TOY, 8, pack=pack)
        assert tq.prepared_qparams.cache_info().hits == 1
        params["recon"]["pw_b"].add_(1.0)            # an in-place edit is a new key
        b = tq.essr_forward_qref(params, torch.from_numpy(x), TOY, 8, pack=pack)
        params["recon"]["pw_b"].sub_(1.0)
    assert tq.prepared_qparams.cache_info().misses == 2 and not torch.equal(a, b)


def test_wrappers_check_operands():
    c = 8
    xq = torch.zeros((2, 8, 8, c), dtype=torch.int8)
    q = {k: torch.zeros((c, c), dtype=torch.int8) if k.endswith("pwq") or k == "fuseq"
         else torch.zeros((3, 3, c)) if k.endswith("dw_fq") else torch.zeros(c)
         for k in tq.QSFB_KEYS}
    qc = torch.tensor([1.0, 1 / 127, 1.0, 1 / 127, 1.0, 1 / 127])
    assert tuple(tq.qsfb_fused(xq, q, qc).shape) == (2, 8, 8, c)
    with pytest.raises(TypeError, match="int8 or int32"):
        tq.qsfb_fused(xq.float(), q, qc)
    with pytest.raises(TypeError, match="b1_pwq must be int32"):
        tq.qsfb_fused(xq.int(), q, qc)
    with pytest.raises(ValueError, match="qc shape"):
        tq.qsfb_fused(xq, q, qc[:2])
    with pytest.raises(TypeError, match="x must be float32"):
        tq.quantize_fused(xq, qc[:2], bits=8)
    with pytest.raises(TypeError, match="dwq must be int32"):
        tq.qdsconv_fused(xq, torch.zeros((3, 3, c), dtype=torch.int8), torch.zeros(c),
                         torch.zeros(c), torch.zeros((c, 12)), torch.zeros(12), qc[:2])
    with pytest.raises(ValueError, match="1..64"):
        tq.qbsconv_fused(torch.zeros((1, 4, 4, 3), dtype=torch.int8),
                         torch.zeros((3, 72), dtype=torch.int8), torch.zeros(72),
                         torch.zeros(72), torch.zeros((3, 3, 72)), torch.zeros(72), qc[:2],
                         relu=False)


def test_build_key_of_the_quantized_kernels():
    assert (_build.CSRC / "qconv.cu").exists()
    key = _build.source_key("qconv")
    assert len(key) == 16 and _build.library_path("qconv").name == f"qconv-{key}.so"
    assert key not in {_build.source_key(n) for n in ("bsconv", "sfb", "dsconv", "mega")}
    src = (_build.CSRC / "qconv.cu").read_text()
    assert 'extern "C" int quantize_forward(' in src
    # qBSConv is the BSConv band walker's codes datapath
    bs = (_build.CSRC / "bsconv.cu").read_text()
    assert 'extern "C" int qbsconv_forward(' in bs and 'extern "C" int qbsconv_forward(' not in src
    assert '#include "qmath.cuh"' in bs
    # qSFB is a band walker of its own, with its dots on the tensor cores
    qsfb = (_build.CSRC / "qsfb.cu").read_text()
    assert 'extern "C" int qsfb_forward(' in qsfb and 'extern "C" int qsfb_forward(' not in src
    # qDSConv is the DSConv band walker's codes datapath
    ds = (_build.CSRC / "dsconv.cu").read_text()
    assert 'extern "C" int qdsconv_forward(' in ds and 'extern "C" int qdsconv_forward(' not in src
    assert '#include "qmath.cuh"' in ds
    assert _build.source_key("qsfb") != key
    # the rounded fp steps and the CUDA-core integer dots live in the shared header
    math = (_build.CSRC / "qmath.cuh").read_text()
    assert '#include "qmath.cuh"' in src and '#include "qmath.cuh"' in qsfb
    assert "__fmul_rn" in math and "__fdiv_rn" in math and "__dp4a" in math


# ---------------------------------------------------------------------------
# 4. the fake-quant "ref" backend and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fxp10"])
@pytest.mark.parametrize("width", [8, 4])
def test_fake_quant_forward_matches_eager_reference(toy, mode, width):
    tree, params, x, packs = toy
    pack = packs[(mode, True)]
    scales = pack.act_scales(width)
    with jax.disable_jit():
        want = np.asarray(jp.quantized_essr_forward(
            tree, {k: jnp.asarray(v, jnp.float32) for k, v in scales.items()}, jnp.asarray(x),
            JTOY, pack.qcfg, width=width))
    with torch.no_grad():
        got = tp.quantized_essr_forward(
            params, {k: torch.tensor(v, dtype=torch.float32) for k, v in scales.items()},
            torch.from_numpy(x), TOY, _port_pack(pack).qcfg, width=width).numpy()
    step = tq.act_qconsts(scales["recon"], pack.qmax)[1]
    np.testing.assert_allclose(got, want, atol=step * 1.0001, rtol=0)


@pytest.fixture(scope="module")
def golden():
    from repro.api import SREngine as JEngine
    ref = JEngine.from_config(JX2, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, ref.params)
    yy, xx = jnp.meshgrid(jnp.linspace(0, 1, 128), jnp.linspace(0, 1, 128), indexing="ij")
    smooth = jnp.stack([yy, xx, (yy + xx) / 2], axis=-1)
    tex = degrade(jnp.asarray(random_image(1234, 256, 256)), 2)
    frame = np.asarray(jnp.where((yy < 0.5)[..., None], smooth, tex))
    fp = SREngine.from_params(tree, X2, device="cpu").upscale(frame)
    return tree, frame, fp


def _port(tree, mode, backend="cuda", **kw):
    return SREngine.from_params(tree, X2, plan=ExecutionPlan(quant=mode, **kw),
                                backend=backend, device="cpu")


def test_engine_labels_and_plan_rules(golden):
    tree, frame, _ = golden
    eng = _port(tree, "int8")
    assert eng.upscale(frame[:64, :64]).backend == "cuda-plain-int8"
    assert eng.reference(frame[:32, :32]).backend == "ref"
    assert _port(tree, "fxp10", "ref").upscale(frame[:64, :64]).backend == "ref-fxp10"
    assert eng.plan.quant == "int8" and eng.backend_label == "cuda-plain-int8"
    assert eng.summary() == {}
    with pytest.raises(ValueError, match="engine-level"):
        eng.upscale(frame, plan=eng.plan.replace(quant="fxp10"))
    with pytest.raises(ValueError, match="engine-level"):
        SREngine.from_params(tree, X2, device="cpu").upscale(frame, plan=ExecutionPlan(
            quant="int8"))
    # quant under fusion="group" serves through the quantized megakernel
    assert _port(tree, "int8", fusion="group").backend_label == "cuda-plain-int8"
    assert pipeline.resolve_forward("cuda", eng.qpack, "group").func is \
        pipeline._forward_width_quant_mega
    grp = _port(tree, "int8", "ref", fusion="group")     # "ref" ignores fusion
    r = grp.upscale(frame)
    assert r.backend == "ref-int8" and r.counts == GOLDEN_COUNTS
    np.testing.assert_array_equal(
        r.image.numpy(), _port(tree, "int8", "ref").upscale(frame).image.numpy())


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
def test_engine_golden_routing_unmoved_by_quant(golden, mode):
    tree, frame, fp = golden
    assert fp.counts == GOLDEN_COUNTS
    for backend in ("cuda", "ref"):
        r = _port(tree, mode, backend).upscale(frame)
        assert r.counts == GOLDEN_COUNTS
        np.testing.assert_array_equal(r.ids, fp.ids)


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
def test_engine_frame_equals_buckets_through_eager_reference(golden, mode):
    tree, frame, _ = golden
    eng = _port(tree, mode)
    got = eng.upscale(frame)
    pack = _jax_pack(eng.qpack)
    geom = JPlan().geometry(frame.shape[0], frame.shape[1], JX2.scale)
    patches = geom.extract(jnp.asarray(frame))
    out = np.zeros((patches.shape[0], 64, 64, 3), np.float32)
    for k, w in enumerate(JX2.subnet_widths()):
        idx = np.flatnonzero(got.ids == k)
        if idx.size == 0:
            continue
        batch = jnp.take(patches, jnp.asarray(idx), axis=0)
        if w == 0:
            out[idx] = np.asarray(j_bilinear(batch, JX2.scale))
            continue
        with jax.disable_jit():
            out[idx] = np.asarray(jq.essr_forward_qref(tree, batch, JX2, w, pack=pack))
    want = np.asarray(geom.fuse_average(jnp.asarray(out)))
    step = max(tq.act_qconsts(pack.act_scales(w)["recon"], pack.qmax)[1] for w in (27, 54))
    np.testing.assert_allclose(got.image.numpy(), want, atol=step, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "fxp10"])
def test_psnr_drop_vs_fp32_engine(golden, mode):
    tree, _, _ = golden
    fp = SREngine.from_params(tree, X2, device="cpu")
    q = _port(tree, mode)
    drops = []
    for i in range(2):
        hr = random_image(300 + i, 96, 96)
        lr = tsyn.degrade(hr, 2)
        p_fp = float(psnr_y(jnp.asarray(fp.upscale(lr).image.numpy()), jnp.asarray(hr)))
        p_q = float(psnr_y(jnp.asarray(q.upscale(lr).image.numpy()), jnp.asarray(hr)))
        drops.append(p_fp - p_q)
    assert max(drops) < 0.6, f"quant PSNR drop {drops} exceeds the 0.6 dB budget"


def test_alpha_cache_round_trip_and_warmup(golden, tmp_path):
    tree, frame, _ = golden
    a = SREngine.from_params(tree, X2, plan=ExecutionPlan(quant="int8"), device="cpu",
                             quant_cache=str(tmp_path))
    files = list(tmp_path.glob("quant_alphas_int8_x2_sfb5_p32_*.json"))
    assert len(files) == 1 and files[0].name.endswith(f"_{jp.params_fingerprint(tree)}.json")
    assert jp.load_quant_pack(str(files[0]), jp.params_fingerprint(tree)) == _jax_pack(a.qpack)
    b = SREngine.from_params(tree, X2, plan=ExecutionPlan(quant="int8"), device="cpu",
                             quant_cache=str(tmp_path))
    assert b.qpack == a.qpack
    before = b.qpack
    w = b.warmup((64, 96))
    assert w.backend == "cuda-plain-int8" and b.qpack is before and b.summary() == {}
    sample = default_calibration_batch(32, 2, n=3)
    c = SREngine.from_params(tree, X2, plan=ExecutionPlan(quant="int8"), device="cpu",
                             calibrate=sample.numpy())
    assert c.qpack == tp.build_quant_pack(c.params, X2, "int8", sample)
