"""Sizing of the port's BSConv band walker (``csrc/bsconv.cu``, fp32 BSConv
and the quantized qBSConv) by ``kernels.bsconv.bsconv_report``, on the CPU,
and both wrappers' plain paths at a patch that the card cuts into column
bands, against the JAX reference.

The report's shared-memory bytes are the launch's: chip_smoke.py fails on
the card when ``bsconv_smem_bytes`` of the built kernel says otherwise. The
fp32 plain path is held to the JAX Pallas kernel (interpret mode) at the
kernel tolerance of tests/test_kernels.py:17 (rtol 1e-4 / atol 1e-5), the
codes with equality to the reference's math run op by op.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import qconv as jq
from repro.kernels.bsconv import bsconv_fused as jax_bsconv_fused
from repro_torch.kernels import bsconv as tbs
from repro_torch.kernels import qconv as tq
from repro_torch.kernels.bsconv import bsconv_fused, bsconv_report

PATCHES = [16, 32, 48, 64, 80, 128]
MODES = [None, 8, 10]         # fp32, int8 codes, fxp10 (int32) codes


@pytest.mark.parametrize("bits", MODES)
@pytest.mark.parametrize("cout", [27, 54])
@pytest.mark.parametrize("cin", [3, 27, 54, 64])
@pytest.mark.parametrize("p", PATCHES)
def test_bsconv_report_fits_and_bands(p, cin, cout, bits):
    r = bsconv_report(cin, cout, p, p, bits)
    assert 0 < r["smem_bytes"] <= r["smem_limit"] == 232_448
    assert 1 <= r["rows_per_step"] <= min(p, tbs.MAX_ROWS)
    assert r["threads"] % 32 == 0 and 64 <= r["threads"] <= tbs.MAX_THREADS
    assert r["bands"] == -(-p // tbs.BAND)            # bands of at most 32 px
    assert r["bands"] * r["band_width"] >= p > (r["bands"] - 1) * r["band_width"]
    assert r["blocks_per_sm"] >= 1
    assert 0 < r["pointwise_busy"] <= 1 and 0 < r["depthwise_busy"] <= 1


@pytest.mark.parametrize("bits,rows,threads,smem", [(None, 4, 256, 106_880),
                                                    (8, 8, 256, 108_224),
                                                    (10, 4, 256, 106_880)])
def test_bsconv_report_main_path_patch(bits, rows, threads, smem):
    r = bsconv_report(3, 54, 32, 32, bits)
    assert (r["rows_per_step"], r["threads"], r["smem_bytes"]) == (rows, threads, smem)
    assert r["bands"] == 1 and r["band_width"] == 32 and r["blocks_per_sm"] == 2
    # a ring of rows + 1 input rows (32 px x 3 elements), the 1x1's ring of
    # rows + 2 rows (32 px x 60 floats: 54 channels padded to 56, and to 60
    # so the depthwise's lanes miss each other's banks), two staged outputs
    # (32 px x 54 elements a row) and the weights (12 vectors of 56 floats,
    # the 1x1's 4 x 56 elements)
    sz = 1 if bits == 8 else 4
    assert smem == ((rows + 1) * 32 * 3 * sz + (rows + 2) * 32 * 60 * 4
                    + 2 * rows * 32 * 54 * sz + 48 * 56 + 4 * 56 * sz)


def test_bsconv_report_refuses(monkeypatch):
    for cin, cout, h, w in ((0, 54, 32, 32), (65, 54, 32, 32), (3, 0, 32, 32),
                            (3, 65, 32, 32), (3, 54, 0, 32), (3, 54, 32, 0)):
        with pytest.raises(ValueError, match="bsconv_report"):
            bsconv_report(cin, cout, h, w)
    monkeypatch.setattr(tbs, "SMEM_LIMIT", 20_000)
    with pytest.raises(ValueError, match="over the H100's 20000 B"):
        bsconv_report(3, 54, 32, 32)
    with pytest.raises(ValueError, match="over the H100's 20000 B"):
        bsconv_report(3, 54, 32, 32, 8)


def _weights(r, cin, cout):
    return (r.standard_normal((cin, cout)).astype(np.float32) * np.float32((2 / cin) ** 0.5),
            (0.1 * r.standard_normal(cout)).astype(np.float32),
            r.standard_normal((3, 3, cout)).astype(np.float32) * np.float32((2 / 9) ** 0.5),
            (0.1 * r.standard_normal(cout)).astype(np.float32))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 80, 80, 3, 54), (2, 9, 33, 27, 27)])
def test_bsconv_plain_path_matches_reference_across_bands(n, h, w, cin, cout, relu):
    """80x80 is three column bands on the card, 33 wide two."""
    r = np.random.default_rng(cin + w)
    x = r.random((n, h, w, cin), dtype=np.float32)
    ws = _weights(r, cin, cout)
    got = bsconv_fused(torch.from_numpy(x), *map(torch.from_numpy, ws), relu=relu).numpy()
    want = np.asarray(jax_bsconv_fused(x, *ws, relu=relu, interpret=True))
    assert bsconv_report(cin, cout, h, w)["bands"] == (3 if w == 80 else 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bits", [8, 10])
def test_qbsconv_plain_path_across_bands(bits, relu):
    """qBSConv on an 80x80 patch (three column bands on the card), codes
    spread over the lattice, non-zero biases: the plain path equals the
    reference's own math run op by op (``_qbsconv_math`` under
    ``jax.disable_jit``) bit for bit."""
    qmax = 127 if bits <= 8 else 511
    r = np.random.default_rng(bits + relu)
    cin, cout = 27, 54
    dtype = np.int8 if bits <= 8 else np.int32
    xq = r.integers(-qmax, qmax + 1, (1, 80, 80, cin)).astype(dtype)
    pwq = r.integers(-qmax, qmax + 1, (cin, cout)).astype(dtype)
    pws = (r.random(cout).astype(np.float32) + np.float32(0.5)) / np.float32(qmax * qmax * 3)
    pwb = (0.1 * r.standard_normal(cout)).astype(np.float32)
    dw = r.standard_normal((3, 3, cout)).astype(np.float32) * np.float32(0.5)
    dwb = (0.1 * r.standard_normal(cout)).astype(np.float32)
    a = np.float32(2.0)
    s = np.float32(a / np.float32(qmax))
    got = tq.qbsconv_fused(*map(torch.from_numpy, (xq, pwq, pws, pwb, dw, dwb)),
                           torch.tensor([a, s]), relu=relu).numpy()
    with jax.disable_jit():
        ref = np.asarray(jq._qbsconv_math(xq, pwq, pws, pwb, dw, dwb, relu=relu,
                                          a_out=float(a), s_out=float(s)))
    assert got.dtype == dtype and ref.dtype == dtype
    assert np.count_nonzero(got) > got.size // 4 and np.abs(got).max() == qmax
    np.testing.assert_array_equal(got, ref)
