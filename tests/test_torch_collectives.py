"""The explicit collectives over four processes against the reference
(``distributed/collectives.py``, ``distributed/moe.py``; reference
collectives.py:26-96, moe.py:58-147).

Four gloo ranks (``tests/_torch_gloo_mesh.py`` kind ``collectives``, one
launch for the file) run flash decode on a (model=4) mesh, compressed psum on
(data=4) and the shard_map MoE on (data=2, model=2), on the inputs of
``collective_inputs`` (numpy's seed 0). The reference runs on the same
inputs in one subprocess with four XLA host devices: ``decode_attention``,
``compressed_psum`` on a 4-device mesh, and for the MoE the einsum
``moe_forward`` and ``moe_forward_shardmap`` on a (2, 2) mesh, each under
``jax.value_and_grad`` of ``sum(out * ct) + 3 * aux``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_gloo_mesh import (MOE_CASES, MOE_CFS, MOE_LEAVES,  # noqa: E402
                              collective_inputs, launch)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from _torch_gloo_mesh import (FD_LEN, MOE_AUX_WEIGHT, MOE_CASES, MOE_CFS, collective_inputs,
                              moe_config, moe_params)
from repro.configs.base import LMConfig
from repro.distributed.collectives import compressed_psum, init_error_state
from repro.distributed.moe import moe_forward_shardmap
from repro.launch.mesh import make_test_mesh
from repro.models.lm import ffn as F
from repro.models.lm.attention import decode_attention

inp = {{k: jnp.asarray(v) for k, v in collective_inputs().items()}}
res = {{"fd": decode_attention(inp["fd_q"], inp["fd_k"], inp["fd_v"], jnp.asarray(FD_LEN))}}
mesh = make_test_mesh((4,), ("data",))
g1 = {{"w": inp["cp1_w"], "b": inp["cp1_b"]}}
g2 = {{"w": inp["cp2_w"], "b": inp["cp2_b"]}}
red1, err1 = compressed_psum(mesh, "data", g1, init_error_state(g1))
red2, err2 = compressed_psum(mesh, "data", g2, err1)
for n in ("w", "b"):
    res["cp_red1_" + n], res["cp_err1_" + n] = red1[n], err1[n]
    res["cp_red2_" + n], res["cp_err2_" + n] = red2[n], err2[n]

mesh = make_test_mesh((2, 2), ("data", "model"))
for name, (mode, e, shared, xshape) in MOE_CASES.items():
    ep = mode == "ep_alltoall"
    flat = {{k: jnp.asarray(v) for k, v in moe_params(collective_inputs(), name).items()}}
    x, ct = inp[name + "_x"], inp[name + "_ct"]
    even = xshape[0] % 2 == 0 and (not ep or xshape[1] % 2 == 0)
    wi = P("model", "data", None) if ep else P(None, "data", "model")
    wo = P("model", None, "data") if ep else P(None, "model", "data")

    def tree(f):
        p = {{k: v for k, v in f.items() if not k.startswith("shared_")}}
        if any(k.startswith("shared_") for k in f):
            p["shared"] = {{k[7:]: v for k, v in f.items() if k.startswith("shared_")}}
        return p

    placed = dict(flat)
    for k, spec in (("w_in", wi), ("w_gate", wi), ("w_out", wo)):
        placed[k] = jax.device_put(flat[k], NamedSharding(mesh, spec))
    xs = jax.device_put(x, NamedSharding(mesh, P("data", "model", None) if even else P()))
    for cf in MOE_CFS:
        cfg = moe_config(mode, e, shared, cf, LMConfig)

        def sm_loss(f, x):
            out, aux = moe_forward_shardmap(tree(f), x, cfg, mesh, "data", "model")
            return (out * ct).sum() + MOE_AUX_WEIGHT * aux, (out, aux)

        def es_loss(f, x):
            out, aux = F.moe_forward(tree(f), x, cfg)
            return (out * ct).sum() + MOE_AUX_WEIGHT * aux, (out, aux)

        for impl, fn, args in (("sm", sm_loss, (placed, xs)), ("es", es_loss, (flat, x))):
            (_, (out, aux)), (gf, gx) = jax.jit(jax.value_and_grad(
                fn, argnums=(0, 1), has_aux=True))(*args)
            tag = "moe_%s_cf%g_%s" % (name, cf, impl)
            res[tag + "_out"], res[tag + "_aux"], res[tag + "_grad_x"] = out, aux, gx
            for k, v in gf.items():
                res[tag + "_grad_" + k] = v
np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})
print("OK", jax.__version__)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port, reference): the four ranks' gathered results and the
    reference's, as numpy arrays by name."""
    d = tmp_path_factory.mktemp("collectives")
    launch("collectives", [], str(d / "port.json"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(REFERENCE.format(tests=TESTS, out=str(d / "ref.npz")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    return dict(np.load(d / "port.json.npz")), dict(np.load(d / "ref.npz"))


def _leaf_close(got, want, rel: float, what: str) -> None:
    """|got - want| within ``rel`` of want's largest value."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("form", ["fd", "fd_local"])
def test_flash_decode_matches_decode_attention(results, form):
    port, ref = results
    np.testing.assert_allclose(port[form], ref["fd"], rtol=1e-4, atol=1e-5)


def _codes(red: np.ndarray) -> np.ndarray:
    """The int8 codes behind a dequantized tensor: its largest code is
    +-127 (the scale is max|g| / 127), so red / (max|red| / 127) rounds back
    to them."""
    return np.rint(red / (np.abs(red).max() / np.float32(127))).astype(np.int64)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("leaf", ["w", "b"])
def test_compressed_psum_matches_the_reference(results, step, leaf):
    """Two steps, the error state carried: codes equal, the reduction and
    the residual within 1e-6 of each leaf's largest."""
    port, ref = results
    red, err = f"cp_red{step}_{leaf}", f"cp_err{step}_{leaf}"
    np.testing.assert_array_equal(_codes(port[red]), _codes(ref[red]))
    assert np.abs(_codes(port[red])).max() == 127
    _leaf_close(port[red], ref[red], 1e-6, red)
    _leaf_close(port[err], ref[err], 1e-6, err)


@pytest.mark.parametrize("leaf", ["w", "b"])
def test_compressed_psum_of_each_ranks_own_gradient(results, leaf):
    """Rank r holds (r + 1) x g: the result is the mean of the four ranks'
    dequantized tensors, each rank keeps its own residual (the plain
    formula in numpy float32)."""
    port, _ = results
    f32 = np.float32
    g = collective_inputs()[f"cp1_{leaf}"]
    deq, errs = [], []
    for r in range(4):
        gr = g * f32(r + 1)
        scale = np.abs(gr).max() / f32(127.0) + f32(1e-12)
        q = np.clip(np.rint(gr / scale), -127, 127).astype(np.int8)
        deq.append(q.astype(f32) * scale)
        errs.append(gr - deq[-1])
    red = (deq[0] + deq[1] + deq[2] + deq[3]) / f32(4)
    _leaf_close(port[f"cp_own_red_{leaf}"], red, 1e-6, "red")
    for r in range(4):
        _leaf_close(port[f"cp_own_err_{leaf}"][r], errs[r], 1e-6, f"err rank {r}")


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_shardmap_moe_matches_the_einsum_moe(results, name):
    """capacity_factor 8: no shard drops a token, so per-shard capacity is
    the global one and the output equals the einsum MoE's (the reference
    test's tolerance)."""
    port, ref = results
    np.testing.assert_allclose(port[f"moe_{name}_cf8_out"], ref[f"moe_{name}_cf8_es_out"],
                               rtol=1e-5, atol=1e-6)


def _moe_leaves(name: str):
    shared = MOE_CASES[name][2]
    return ["out", "aux", "grad_x"] + [f"grad_{n}" for n in MOE_LEAVES
                                       if shared or not n.startswith("shared_")]


@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("name", list(MOE_CASES))
def test_shardmap_moe_matches_the_reference_shardmap(results, name, cf):
    """Out, aux and the gradients of x and every weight against the
    reference's moe_forward_shardmap on a (2, 2) host mesh, at 1e-4 of each
    leaf's largest. At capacity_factor 1 per-shard capacity binds: the
    reference's own shard_map and einsum outputs differ there."""
    port, ref = results
    tag = f"moe_{name}_cf{cf:g}"
    for leaf in _moe_leaves(name):
        _leaf_close(port[f"{tag}_{leaf}"], ref[f"{tag}_sm_{leaf}"], 1e-4, f"{tag} {leaf}")
    if cf == 1.0:
        gap = np.abs(ref[f"{tag}_sm_out"] - ref[f"{tag}_es_out"]).max()
        assert gap > 1e-3, f"{tag}: no token dropped differently ({gap})"
