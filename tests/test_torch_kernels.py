"""Port parity of the kernel wrappers on CPU tensors (their plain versions)
against the JAX Pallas kernels run in interpret mode and against the JAX
plain oracles, plus the wrappers' operand checks and the build helpers.

Tolerances: one kernel rtol 1e-4 / atol 1e-5 (tests/test_kernels.py:17,
fp32); the whole chain rtol 1e-3 / atol 1e-3 (tests/test_kernels.py:77).
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.essr import ESSR_X4, essr_forward, init_essr
from repro_torch.kernels import _build, ops
from repro_torch.kernels.bsconv import bsconv_fused
from repro_torch.kernels.dsconv import dsconv_fused
from repro_torch.kernels.sfb import SFB_KEYS, sfb_fused
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.essr import ESSR_X4 as T_X4

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(4, 8, 8), (8, 16, 16), (2, 34, 34), (1, 8, 8), (5, 8, 8), (7, 8, 8)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _operands(kind, n, h, w, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32) * 0.2
    if kind == "bsconv":
        x = r.random((n, h, w, 3), dtype=np.float32)
        return x, [f(3, 18), f(18) + 0.1, f(3, 3, 18), f(18) + 0.05]
    if kind == "dsconv":
        x = r.random((n, h, w, 12), dtype=np.float32)
        return x, [f(3, 3, 12), f(12) + 0.1, f(12, 48), f(48) + 0.05]
    x = r.random((n, h, w, 54), dtype=np.float32)
    p = jax.tree_util.tree_map(np.asarray, jops._flat_sfb(
        init_essr(jax.random.PRNGKey(seed), ESSR_X4)["sfbs"][0]))
    p = {k: (v + 0.05 if k.endswith("b") else v) for k, v in p.items()}
    return x, p


@pytest.mark.parametrize("n,h,w,relu", [s + (False,) for s in SHAPES]
                         + [(5, 8, 8, True), (2, 34, 34, True)])
def test_bsconv_wrapper_matches_pallas_and_oracle(n, h, w, relu):
    x, ws = _operands("bsconv", n, h, w, 0)
    got = bsconv_fused(_t(x), *map(_t, ws), relu=relu).numpy()
    pallas = jops.bsconv_fused(x, *ws, relu=relu, block_patches=2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.bsconv_ref(x, *ws, relu=relu)), **TOL)


@pytest.mark.parametrize("n,h,w", SHAPES)
def test_dsconv_wrapper_matches_pallas_and_oracle(n, h, w):
    x, ws = _operands("dsconv", n, h, w, 1)
    got = dsconv_fused(_t(x), *map(_t, ws)).numpy()
    pallas = jops.dsconv_fused(x, *ws, block_patches=2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.dsconv_ref(x, *ws)), **TOL)


@pytest.mark.parametrize("n,h,w", SHAPES)
def test_sfb_wrapper_matches_pallas_and_oracle(n, h, w):
    x, p = _operands("sfb", n, h, w, 2)
    got = sfb_fused(_t(x), {k: _t(v) for k, v in p.items()}).numpy()
    pallas = jops.sfb_fused(x, p, block_patches=2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(jref.sfb_ref(x, p)), **TOL)


@pytest.mark.parametrize("width,n", [(27, 4), (54, 4), (54, 5), (27, 7)])
def test_essr_forward_kernels_matches_reference(width, n):
    tree = jax.tree_util.tree_map(np.asarray, init_essr(jax.random.PRNGKey(4), ESSR_X4))
    params = params_from_numpy(tree, T_X4).tree()
    x = np.random.default_rng(width + n).random((n, 16, 16, 3), dtype=np.float32)
    with torch.no_grad():
        got = ops.essr_forward_kernels(params, _t(x), T_X4, width=width).numpy()
    want = essr_forward(tree, jnp.asarray(x), ESSR_X4, width=width)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)


def test_empty_bucket_and_cpu_path_launch_nothing():
    ops.reset_launch_counts()
    tree = jax.tree_util.tree_map(np.asarray, init_essr(jax.random.PRNGKey(0), ESSR_X4))
    params = params_from_numpy(tree, T_X4).tree()
    with torch.no_grad():
        out = ops.essr_forward_kernels(params, torch.zeros((0, 32, 32, 3)), T_X4, width=54)
        assert tuple(out.shape) == (0, 128, 128, 3)
        x, ws = _operands("bsconv", 0, 8, 8, 0)
        assert tuple(bsconv_fused(_t(x), *map(_t, ws)).shape) == (0, 8, 8, 18)
        ops.essr_forward_kernels(params, torch.rand((2, 8, 8, 3)), T_X4, width=27)
    assert ops.launch_counts() == {"bsconv": 0, "sfb": 0, "dsconv": 0, "mega": 0,
                                   "quantize": 0, "qbsconv": 0, "qsfb": 0, "qdsconv": 0,
                                   "qmega": 0, "edge": 0}
    with pytest.raises(ValueError, match="bilinear"):
        ops.essr_forward_kernels(params, torch.rand((2, 8, 8, 3)), T_X4, width=0)


def test_wrappers_reject_bad_operands():
    x, ws = _operands("bsconv", 2, 8, 8, 0)
    xt, wt = _t(x), [_t(v) for v in ws]
    with pytest.raises(TypeError, match="float32"):
        bsconv_fused(xt.double(), *wt)
    with pytest.raises(ValueError, match="contiguous"):
        bsconv_fused(xt.transpose(1, 2), *wt)
    with pytest.raises(ValueError, match="shape"):
        bsconv_fused(xt, wt[0][:, :10].contiguous(), *wt[1:])
    with pytest.raises(ValueError, match="N,H,W,C"):
        bsconv_fused(xt[0], *wt)
    c = 72
    big = torch.rand((1, 8, 8, c))
    p = {k: torch.zeros((c, c)) if k in ("b1_pw", "b2_pw", "fuse")
         else torch.zeros((3, 3, c)) if k.endswith("_dw") else torch.zeros(c) for k in SFB_KEYS}
    with pytest.raises(ValueError, match="1..64"):
        sfb_fused(big, p)
    x, ws = _operands("dsconv", 1, 8, 8, 1)
    with pytest.raises(ValueError, match="dw"):
        dsconv_fused(_t(x), _t(ws[0][..., :6]), *map(_t, ws[1:]))


def test_build_key_flags_and_missing_nvcc(monkeypatch, tmp_path):
    for name in ("bsconv", "sfb", "dsconv"):
        assert (_build.CSRC / f"{name}.cu").exists()
        key = _build.source_key(name)
        assert len(key) == 16 and _build.library_path(name).name == f"{name}-{key}.so"
    assert _build.source_key("sfb") != _build.source_key("dsconv")
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS and "-shared" in _build.FLAGS
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
