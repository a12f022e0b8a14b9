"""Sizing of the port's fp32 SFB kernel (``csrc/sfb.cu``, the band walker)
by ``kernels.sfb.sfb_report``, on the CPU, and the wrapper's plain path at
the shapes that cut a patch into column bands, against the JAX reference.

The report's shared-memory bytes are the launch's: chip_smoke.py fails on
the card when ``sfb_smem_bytes`` of the built kernel says otherwise. The
plain path is held at the kernel tolerance of tests/test_kernels.py:17,
rtol 1e-4 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import sfb as tsfb
from repro_torch.kernels.sfb import SFB_KEYS, sfb_fused, sfb_report

SHAPES = [(32, 32), (17, 9), (13, 21), (40, 72)]


@pytest.mark.parametrize("c", [54, 27])
@pytest.mark.parametrize("h,w", SHAPES)
def test_sfb_report_fits_and_counts_pointwise(c, h, w):
    r = sfb_report(c, h, w)
    assert 0 < r["smem_bytes"] <= r["smem_limit"] == 232_448
    assert 1 <= r["rows_per_step"] <= min(h, tsfb.MAX_ROWS)
    assert r["threads"] % 32 == 0 and 32 <= r["threads"] <= tsfb.MAX_THREADS
    assert r["bands"] * r["band_width"] >= w > (r["bands"] - 1) * r["band_width"]
    assert r["band_width"] <= tsfb.BAND
    if w <= tsfb.BAND:            # one band spans the patch: no column halo
        assert r["bands"] == 1 and r["pointwise_px_per_output_px"] == 3.0
    else:                         # bands recompute a 2-px column halo
        assert r["bands"] > 1 and 3.0 < r["pointwise_px_per_output_px"] < 4.81
    assert 0 < r["pointwise_busy"] <= 1 and 0 < r["depthwise_busy"] <= 1


@pytest.mark.parametrize("c,rows,threads,smem", [(54, 4, 224, 219_424), (27, 8, 256, 194_944)])
def test_sfb_report_main_path_patch(c, rows, threads, smem):
    r = sfb_report(c, 32, 32)
    assert (r["rows_per_step"], r["threads"], r["smem_bytes"]) == (rows, threads, smem)
    assert r["pointwise_busy"] == r["depthwise_busy"] == 1.0
    # 42,784 B of weights at C54, as csrc/sfb.cu stages them (C padded to 56)
    assert c != 54 or r["smem_bytes"] - 4 * 60 * (32 * (3 * 6 + 5)) == 42_784


def test_sfb_report_refuses(monkeypatch):
    for c, h, w in ((0, 32, 32), (65, 32, 32), (54, 0, 32), (54, 32, 0)):
        with pytest.raises(ValueError, match="sfb_report"):
            sfb_report(c, h, w)
    monkeypatch.setattr(tsfb, "SMEM_LIMIT", 40_000)
    with pytest.raises(ValueError, match="over the H100's 40000 B"):
        sfb_report(54, 32, 32)


@pytest.mark.parametrize("n,h,w,c", [(2, 13, 40, 27), (1, 9, 33, 54)])
def test_sfb_wrapper_plain_path_matches_reference_across_bands(n, h, w, c):
    r = np.random.default_rng(c + w)
    x = r.random((n, h, w, c), dtype=np.float32)
    p = {k: (r.standard_normal((c, c)) * (2 / c) ** 0.5 if k in ("b1_pw", "b2_pw", "fuse")
             else r.standard_normal((3, 3, c)) * (2 / 9) ** 0.5 if k.endswith("_dw")
             else 0.1 * r.standard_normal(c)).astype(np.float32) for k in SFB_KEYS}
    assert sfb_report(c, h, w)["bands"] == 2
    before = sfb_fused.launches
    got = sfb_fused(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    assert sfb_fused.launches == before          # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.sfb_ref(x, p)), rtol=1e-4,
                               atol=1e-5)
