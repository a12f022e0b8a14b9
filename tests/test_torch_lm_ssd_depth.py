"""Mamba-2's SSD form against its scan form at zamba2-1.2b's full depth (38
layers), in fp32 and in bf16, in both packages on the CPU.

In fp32 the two forms are one function summed in another order: the port's
SSD prefill equals its scan prefill and the reference's SSD prefill within
rtol/atol 1e-4. In bf16 every layer rounds its output, and 38 layers carry
those roundings apart: the reference's own SSD and scan logits differ, and
each form departs from its fp32 logits by more than either gap. The bf16
test holds the port's rounding to the reference's: each of the port's bf16
forms departs from the fp32 logits by no more than 1.5x the reference's
same form, and the port's SSD-vs-scan gap is no larger than that rounding.
A wrong decay, state or cast in the bf16 SSD path would show as a departure
from fp32 beyond the reference's.

The width is zamba2's SMOKE widened to d_model 256 (the gap is 0 at
SMOKE's 64, where few roundings flip), the depth FULL's, one batch of two
128-token prompts (eight SSD chunks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.lm import transformer as JT
from repro_torch.configs import zamba2_1_2b
from repro_torch.configs.registry import get_config
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.lm import transformer as T

B, S, WIDTH = 2, 128, 256
KW = dict(n_layers=zamba2_1_2b.FULL.n_layers,
          shared_attn_every=zamba2_1_2b.FULL.shared_attn_every, d_model=WIDTH)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def logits():
    """{(dtype, impl): (reference logits, port logits)} as float32 arrays,
    both packages from the reference's init at PRNGKey(0) in that dtype."""
    key = jax.random.PRNGKey(0)
    init = jax.jit(JT.init_lm, static_argnums=(1, 2))
    prefill = jax.jit(JT.lm_prefill, static_argnums=(1, 3))
    out = {}
    for name, jdt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        for impl in ("scan", "ssd"):
            jc = dataclasses.replace(jget_config("zamba2-1.2b", smoke=True), mamba2_impl=impl,
                                     **KW)
            cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True), mamba2_impl=impl,
                                      **KW)
            jp = init(key, jc, jdt)
            toks = jax.random.randint(key, (B, S), 0, jc.vocab_size)
            jl, _ = prefill(jp, jc, toks, S)
            tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg)
            with torch.no_grad():
                tl, _ = T.lm_prefill(tp, cfg, torch.from_numpy(np.asarray(toks).astype(np.int64)),
                                     S)
            out[name, impl] = (np.asarray(jl, np.float32), tl.float().numpy())
    return out


def _gap(a, b):
    return float(np.abs(a - b).max())


def test_fp32_ssd_equals_scan_and_reference_at_full_depth(logits):
    (_, scan), (ref_ssd, ssd) = logits["fp32", "scan"], logits["fp32", "ssd"]
    np.testing.assert_allclose(ssd, scan, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ssd, ref_ssd, rtol=1e-4, atol=1e-4)


def test_bf16_ssd_rounds_like_the_reference_at_full_depth(logits):
    dev = {impl: [_gap(logits["bf16", impl][i], logits["fp32", impl][i]) for i in (0, 1)]
           for impl in ("scan", "ssd")}
    port_gap = _gap(logits["bf16", "ssd"][1], logits["bf16", "scan"][1])
    for impl, (ref_dev, port_dev) in dev.items():
        assert port_dev <= 1.5 * ref_dev, (impl, port_dev, ref_dev)
    assert port_gap <= min(d for _, d in dev.values()), (port_gap, dev)
