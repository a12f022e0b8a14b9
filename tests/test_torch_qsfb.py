"""Sizing of the port's quantized SFB kernel (``csrc/qsfb.cu``, a band walker
with its 1x1 dots on the tensor cores) by ``kernels.qconv.qsfb_report``, the
wrapper's plain path at the shapes that cut a patch into column bands or end
on a ragged step against the JAX reference, and the exactness of the fxp10
route (integer dots as fp32 sums of integer-valued floats), on the CPU.

The report's shared-memory bytes are the launch's: chip_smoke.py fails on the
card when ``qsfb_smem_bytes`` of the built kernel says otherwise. Codes are
held bit for bit against the JAX reference's ``_qsfb_math`` run eagerly
(``jax.disable_jit()``): jit'd, XLA contracts multiply-adds and flips fxp10
codes (ROADMAP, "Not faults").
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import qconv as jq
from repro_torch.kernels import _build
from repro_torch.kernels import qconv as tq
from repro_torch.kernels.qconv import qsfb_fused, qsfb_report

SHAPES = [(32, 32), (17, 9), (13, 21), (40, 72)]


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("c", [54, 27, 64])
@pytest.mark.parametrize("h,w", SHAPES)
def test_qsfb_report_fits_and_counts_dots(c, h, w, bits):
    r = qsfb_report(c, h, w, bits)
    code_bytes = 1 if bits <= 8 else 4
    assert 0 < r["smem_bytes"] <= r["smem_limit"] == 232_448
    assert 1 <= r["rows_per_step"] <= min(h, tq.QSFB_MAX_ROWS)
    if r["rows_per_step"] < min(h, tq.QSFB_MAX_ROWS):     # the most rows that fit
        lay = tq._qsfb_layout(c, w, code_bytes)
        assert tq._qsfb_smem(lay, r["rows_per_step"] + 1, code_bytes) > r["smem_limit"]
    assert r["threads"] % 32 == 0 and 32 <= r["threads"] <= tq.QSFB_MAX_THREADS
    assert r["bands"] * r["band_width"] >= w > (r["bands"] - 1) * r["band_width"]
    assert r["band_width"] <= tq.QSFB_BAND
    if w <= tq.QSFB_BAND:         # one band spans the patch: no column halo
        assert r["bands"] == 1 and r["pixel_dots_per_output_px"] == 4.0
    else:                         # bands recompute a 2-px column halo, still under 8x8 tiles' 5.81
        assert r["bands"] > 1 and 4.0 < r["pixel_dots_per_output_px"] < 5.81
    assert 0 < r["dot_busy"] <= 1 and 0 < r["depthwise_busy"] <= 1
    assert r["blocks_per_sm"] >= 1


@pytest.mark.parametrize("c,bits,rows,threads,smem", [
    (54, 8, 8, 512, 228_768), (54, 10, 3, 512, 210_208),
    (27, 8, 8, 512, 148_288), (27, 10, 7, 512, 220_032)])
def test_qsfb_report_main_path_patch(c, bits, rows, threads, smem):
    r = qsfb_report(c, 32, 32, bits)
    assert (r["rows_per_step"], r["threads"], r["smem_bytes"]) == (rows, threads, smem)
    assert r["bands"] == 1 and r["blocks_per_sm"] == 1
    if (c, bits) == (54, 10):
        # x ring of 2S + 2 rows (S in flight), pw1 and pw2 rings of S + 2, Y of
        # S + 1: 32 px each; an operand pixel 240 B (56 floats, padded to an
        # odd multiple of 16 B), a ring pixel 56 floats; three 56-row weights
        assert smem == (8 * 32 * 240 + 2 * 5 * 32 * 56 * 4 + 4 * 32 * 240
                        + 3 * 56 * 240 + 27 * 56 * 4)
    if (c, bits) == (54, 8):
        # int8: a pixel is 54 B, so rows arrive unpadded in a staging ring
        # (1,728 B a row) and an operand pixel is 80 B (64 codes, 16 B pad)
        assert smem == (10 * 32 * 80 + 10 * 1728 + 2 * 10 * 32 * 56 * 4 + 9 * 32 * 80
                        + 3 * 56 * 80 + 27 * 56 * 4)


def test_qsfb_report_refuses(monkeypatch):
    for c, h, w in ((0, 32, 32), (65, 32, 32), (54, 0, 32), (54, 32, 0)):
        with pytest.raises(ValueError, match="qsfb_report"):
            qsfb_report(c, h, w, 8)
    monkeypatch.setattr(tq, "SMEM_LIMIT", 40_000)
    with pytest.raises(ValueError, match="over the H100's 40000 B"):
        qsfb_report(54, 32, 32, 10)


def _operands(r, n, h, w, c, bits):
    """Random codes and qSFB operands in numpy, as prepare_qparams shapes
    them, and the six site constants (clip, step) of sites b1, b2, out."""
    qmax = 2 ** (bits - 1) - 1
    dtype = np.int8 if bits <= 8 else np.int32
    x = r.integers(-qmax, qmax + 1, (n, h, w, c)).astype(dtype)
    q = {}
    for b in ("b1", "b2"):
        q[f"{b}_pwq"] = r.integers(-qmax, qmax + 1, (c, c)).astype(dtype)
        q[f"{b}_pw_scale"] = ((r.random(c) + 0.5) / (qmax * qmax * c ** 0.5)).astype(np.float32)
        q[f"{b}_pwb"] = (0.1 * r.standard_normal(c)).astype(np.float32)
        q[f"{b}_dw_fq"] = (r.standard_normal((3, 3, c)) * 0.4).astype(np.float32)
        q[f"{b}_dwb"] = (0.1 * r.standard_normal(c)).astype(np.float32)
    q["fuseq"] = r.integers(-qmax, qmax + 1, (c, c)).astype(dtype)
    for k in ("fuse_scale_y", "fuse_scale_x"):
        q[k] = ((r.random(c) + 0.5) / (qmax * qmax * c ** 0.5)).astype(np.float32)
    q["fuseb"] = (0.1 * r.standard_normal(c)).astype(np.float32)
    consts = [v for alpha in r.random(3) + 0.5 for v in tq.act_qconsts(alpha, qmax)]
    return x, q, consts


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("n,h,w,c", [(2, 13, 40, 27), (1, 9, 33, 54), (3, 17, 9, 54),
                                     (2, 11, 21, 27)])
def test_qsfb_wrapper_plain_path_matches_reference_across_bands(n, h, w, c, bits):
    r = np.random.default_rng(c + w + bits)
    x, q, consts = _operands(r, n, h, w, c, bits)
    before = qsfb_fused.launches
    got = qsfb_fused(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in q.items()},
                     torch.tensor(consts, dtype=torch.float32))
    assert qsfb_fused.launches == before          # the CPU takes the plain version
    jqp = dict(q, a_b1=consts[0], s_b1=consts[1], a_b2=consts[2], s_b2=consts[3])
    with jax.disable_jit():
        want = np.asarray(jq._qsfb_math(x, jqp, a_out=consts[4], s_out=consts[5]))
    assert got.dtype == (torch.int8 if bits <= 8 else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.2                # codes spread, not all clipped to 0
    assert qsfb_report(c, h, w, bits)["bands"] == (2 if w > 32 else 1)


def _fp32_dot(x: torch.Tensor, w: torch.Tensor, kstep: int) -> torch.Tensor:
    """The fxp10 route's integer dot emulated in fp32: codes as floats, one
    rounded fp32 add per product, k-steps of ``kstep`` channels in order
    (the TF32 mma's depth is 8), each step's products summed in order."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], kstep):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + kstep, x.shape[1])):
            part = part + x[:, k:k + 1] * w[k]
        acc = acc + part
    return acc


@pytest.mark.parametrize("c", [3, 54, 64])     # the depths of qSFB and qmega's dots
def test_fxp10_dot_route_is_exact_at_extreme_codes(c):
    r = np.random.default_rng(64)
    sign = lambda *s: torch.from_numpy(r.integers(0, 2, s) * 2 - 1)
    x = sign(512, c) * 511
    x[:128] = 511                                   # rows of all +511
    w = sign(c, c) * 511
    w[:, 0::3], w[:, 1::3] = 511, -511              # columns of one sign
    exact = x.long() @ w.long()
    assert exact.abs().max().item() == 511 * 511 * c < 2 ** 24
    xf, wf = x.float(), w.float()
    # TF32 keeps 10 mantissa bits: a code up to 2^11 loses none of them
    assert ((xf.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((wf.view(torch.int32) & 0x1FFF) == 0).all()
    for kstep in (8, 1, 64):                        # the TF32 k-step, FFMA order, one step
        got = _fp32_dot(xf, wf, kstep)
        assert torch.equal(got.to(torch.int64), exact)
    # the bound is what makes it exact: at +-2047 the sums of a depth past 3
    # pass 2^24 and round (at depth 3 they stay below it)
    big_x, big_w = (x // 511 * 2047).float(), (w // 511 * 2047).float()
    big = big_x.long() @ big_w.long()
    assert (big.abs().max().item() >= 2 ** 24) == (c > 3)
    assert torch.equal(_fp32_dot(big_x, big_w, 8).to(torch.int64), big) == (c <= 3)


def test_build_key_of_the_qsfb_kernel():
    assert (_build.CSRC / "qsfb.cu").exists()
    key = _build.source_key("qsfb")
    assert len(key) == 16 and _build.library_path("qsfb").name == f"qsfb-{key}.so"
    assert key not in {_build.source_key(n) for n in ("qconv", "qmega", "sfb")}
    kernel = (_build.CSRC / "qsfb.cu").read_text()
    assert 'extern "C" int qsfb_forward(' in kernel
    assert 'extern "C" long long qsfb_smem_bytes(' in kernel
    assert '#include "qmath.cuh"' in kernel and '#include "qmma.cuh"' in kernel
    # the tensor-core pieces live in qmma.cuh, shared with the quantized megakernel
    src = kernel + (_build.CSRC / "qmma.cuh").read_text()
    # the dots on the tensor cores: int8 exact integer mma, fxp10 TF32 on codes as floats
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "ldmatrix.sync.aligned" in src and "__dp4a" not in src
    # every rounded step after a dot is qmath.cuh's: dequant, mul_add_rn, fuse_combine, requant
    for fn in ("dequant(", "mul_add_rn(", "fuse_combine(", "requant<T>("):
        assert fn in src
