"""Sizing of the port's DSConv band walker (``csrc/dsconv.cu``, fp32 DSConv
and the quantized qDSConv) by ``kernels.dsconv.dsconv_report``, on the CPU,
and both wrappers' plain paths at shapes that cut a patch into column bands,
against the JAX reference.

The report's shared-memory bytes are the launch's: chip_smoke.py fails on
the card when ``dsconv_smem_bytes`` of the built kernel says otherwise. The
fp32 plain path is held at the kernel tolerance of tests/test_kernels.py:17
(rtol 1e-4 / atol 1e-5), the codes with equality.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import qconv as jq
from repro.kernels import ref as jref
from repro_torch.kernels import dsconv as tds
from repro_torch.kernels import qconv as tq
from repro_torch.kernels.dsconv import dsconv_fused, dsconv_report

PATCHES = [16, 32, 48, 64, 80, 96, 128]
MODES = [None, 8, 10]         # fp32, int8 codes, fxp10 (int32) codes


@pytest.mark.parametrize("bits", MODES)
@pytest.mark.parametrize("cin,cout", [(54, 48), (27, 48), (54, 12), (27, 12)])
@pytest.mark.parametrize("p", PATCHES)
def test_dsconv_report_fits_and_bands(p, cin, cout, bits):
    r = dsconv_report(cin, cout, p, p, bits)
    assert 0 < r["smem_bytes"] <= r["smem_limit"] == 232_448
    assert 1 <= r["rows_per_step"] <= min(p, tds.MAX_ROWS)
    assert r["threads"] % 32 == 0 and 64 <= r["threads"] <= tds.MAX_THREADS
    assert r["bands"] == -(-p // tds.BAND)            # bands of at most 32 px
    assert r["bands"] * r["band_width"] >= p > (r["bands"] - 1) * r["band_width"]
    assert r["blocks_per_sm"] >= 1
    assert 0 < r["depthwise_busy"] <= 1 and 0 < r["pointwise_busy"] <= 1


@pytest.mark.parametrize("bits,rows,threads,smem", [(None, 4, 256, 110_176),
                                                    (8, 8, 256, 104_416),
                                                    (10, 4, 256, 110_176)])
def test_dsconv_report_main_path_patch(bits, rows, threads, smem):
    r = dsconv_report(54, 48, 32, 32, bits)
    assert (r["rows_per_step"], r["threads"], r["smem_bytes"]) == (rows, threads, smem)
    assert r["bands"] == 1 and r["band_width"] == 32
    # a ring of rows + 2 input rows (32 px x 54 elements), D (60 floats a
    # pixel), the staged output (32 px x 48 elements) and 13,408 B of weights
    sz = 1 if bits == 8 else 4
    assert smem == (rows + 2) * 32 * 54 * sz + rows * 32 * 60 * 4 + rows * 32 * 48 * sz + 13_408


def test_dsconv_report_refuses(monkeypatch):
    for cin, cout, h, w in ((0, 48, 32, 32), (65, 48, 32, 32), (54, 0, 32, 32),
                            (54, 48, 0, 32), (54, 48, 32, 0)):
        with pytest.raises(ValueError, match="dsconv_report"):
            dsconv_report(cin, cout, h, w)
    monkeypatch.setattr(tds, "SMEM_LIMIT", 20_000)
    with pytest.raises(ValueError, match="over the H100's 20000 B"):
        dsconv_report(54, 48, 32, 32)


def _weights(r, cin, cout):
    return (r.standard_normal((3, 3, cin)).astype(np.float32) * np.float32((2 / 9) ** 0.5),
            (0.1 * r.standard_normal(cin)).astype(np.float32),
            r.standard_normal((cin, cout)).astype(np.float32) * np.float32((2 / cin) ** 0.5),
            (0.1 * r.standard_normal(cout)).astype(np.float32))


@pytest.mark.parametrize("n,h,w,cin", [(1, 80, 80, 27), (2, 9, 33, 54)])
def test_dsconv_plain_path_matches_reference_across_bands(n, h, w, cin):
    r = np.random.default_rng(cin + w)
    x = r.random((n, h, w, cin), dtype=np.float32)
    ws = _weights(r, cin, 48)
    got = dsconv_fused(torch.from_numpy(x), *map(torch.from_numpy, ws)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.dsconv_ref(x, *ws)), rtol=1e-4, atol=1e-5)


def _qdsconv_contract(xq, dwq, dws, dwb, pw, pwb, a, s):
    """csrc/dsconv.cu's codes contract in numpy float32, op by op: exact
    int32 3x3 (zero codes off the patch), dequant, the 1x1 as an ordered sum
    over input channels from 0, + bias, clip, divide, round half to even."""
    n, h, w, _ = xq.shape
    xp = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(xp[:, dy:dy + h, dx:dx + w] * dwq[dy, dx] for dy in range(3) for dx in range(3))
    y = acc.astype(np.float32) * dws + dwb
    out = np.zeros((n, h, w, pw.shape[1]), np.float32)
    for ci in range(pw.shape[0]):
        out = out + y[..., ci:ci + 1] * pw[ci]
    return np.rint(np.clip(out + pwb, -a, a) / s).astype(xq.dtype)


@pytest.mark.parametrize("bits", [8, 10])
def test_qdsconv_plain_path_across_bands(bits):
    """qDSConv on an 80x80 patch (three column bands on the card): the plain
    path equals the kernel's contract bit for bit, and the reference's own
    math run op by op (``_qdsconv_math`` under ``jax.disable_jit``) at all
    but a few codes, each 1 apart: its fp 1x1 is a ``jnp.dot`` with no fixed
    order (ROADMAP queue 3, "Not faults")."""
    qmax = 127 if bits <= 8 else 511
    r = np.random.default_rng(bits)
    cin, cout = 27, 12
    dtype = np.int8 if bits <= 8 else np.int32
    xq = r.integers(-qmax, qmax + 1, (1, 80, 80, cin)).astype(dtype)
    dwq = r.integers(-qmax, qmax + 1, (3, 3, cin)).astype(np.int32)
    dws = (r.random(cin).astype(np.float32) + np.float32(0.5)) / np.float32(qmax * qmax * 3)
    dwb = (0.1 * r.standard_normal(cin)).astype(np.float32)
    pw = r.standard_normal((cin, cout)).astype(np.float32) * np.float32(4 / cin ** 0.5)
    pwb = (0.1 * r.standard_normal(cout)).astype(np.float32)
    a = np.float32(2.0)
    s = np.float32(a / np.float32(qmax))
    got = tq.qdsconv_fused(*map(torch.from_numpy, (xq, dwq, dws, dwb, pw, pwb)),
                           torch.tensor([a, s])).numpy()
    want = _qdsconv_contract(xq, dwq, dws, dwb, pw, pwb, a, s)
    assert got.dtype == dtype and np.count_nonzero(want) > 0
    np.testing.assert_array_equal(got, want)
    with jax.disable_jit():
        ref = np.asarray(jq._qdsconv_math(xq, dwq, dws, dwb, pw, pwb, a_out=float(a),
                                          s_out=float(s)))
    apart = np.abs(got.astype(np.int64) - ref)
    assert apart.max() <= 1 and np.count_nonzero(apart) <= got.size // 10_000
