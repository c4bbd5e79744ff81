"""Each model layer against a plain-NumPy reference at preset widths.

Widths come from the shipped presets: the ``rectangle_pin`` logits head
(120 -> 144), the 10x10 grid conv (3x3, 3 filters), the spatial model's
component-grid conv (2x2 pin planes, 3x3 SAME), batch norm over conv
features, a 2x2 max-pool, and component self-attention (5 tokens of width
31, hidden 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from placement_tpu.models import blocks

B = 4


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _init(fn, x, *args):
    """Variables a layer creates for input ``x``."""
    s = blocks.Scope.initializing(jax.random.PRNGKey(0))
    fn(s, jnp.asarray(x), *args)
    return jax.tree_util.tree_map(np.asarray, s.variables)


def _conv_ref(x, w, b, padding):
    k = w.shape[0]
    if padding == "SAME":
        lo = (k - 1) // 2
        x = np.pad(x, ((0, 0), (lo, k - 1 - lo), (lo, k - 1 - lo), (0, 0)))
    h, wd = x.shape[1] - k + 1, x.shape[2] - k + 1
    out = np.zeros((x.shape[0], h, wd, w.shape[-1]), np.float64)
    for i in range(h):
        for j in range(wd):
            patch = x[:, i:i + k, j:j + k, :]
            out[:, i, j, :] = np.einsum("bhwc,hwco->bo", patch, w)
    return out + b


def case_dense():
    x = _rand(1, (B, 120))
    v = _init(blocks.dense, x, 144)
    p = v["params"]
    assert p["kernel"].shape == (120, 144) and not p["bias"].any()
    got, _ = _apply(blocks.dense, v, x, 144)
    return got, x @ p["kernel"] + p["bias"]


def _apply(fn, variables, x, *args, train=False):
    s = blocks.Scope.bound(variables, train=train)
    return np.asarray(fn(s, jnp.asarray(x), *args)), s.updates


def case_conv_valid():
    x = _rand(2, (B, 10, 10, 1))
    v = _init(blocks.conv, x, 3, 3, "VALID")
    got, _ = _apply(blocks.conv, v, x, 3, 3, "VALID")
    assert got.shape == (B, 8, 8, 3)
    p = v["params"]
    return got, _conv_ref(x, p["kernel"], p["bias"], "VALID")


def case_conv_same():
    x = _rand(3, (B * 5, 2, 2, 4))
    v = _init(blocks.conv, x, 3, 3, "SAME")
    got, _ = _apply(blocks.conv, v, x, 3, 3, "SAME")
    assert got.shape == (B * 5, 2, 2, 3)
    p = v["params"]
    return got, _conv_ref(x, p["kernel"], p["bias"], "SAME")


def _bn_variables(x):
    v = _init(blocks.batch_norm, x)
    feat = x.shape[-1]
    v["params"] = {"scale": _rand(5, (feat,)) + 1.0,
                   "bias": _rand(6, (feat,))}
    v["batch_stats"] = {"mean": _rand(7, (feat,)),
                        "var": np.abs(_rand(8, (feat,))) + 0.5}
    return v


def case_batch_norm_train():
    x = _rand(4, (B, 8, 8, 3), scale=2.0) + 1.0
    v = _bn_variables(x)
    got, updates = _apply(blocks.batch_norm, v, x, train=True)
    mean = x.mean(axis=(0, 1, 2))
    var = x.var(axis=(0, 1, 2))
    m = blocks.BN_MOMENTUM
    new = updates["batch_stats"]
    np.testing.assert_allclose(
        new["mean"], m * v["batch_stats"]["mean"] + (1 - m) * mean,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        new["var"], m * v["batch_stats"]["var"] + (1 - m) * var,
        rtol=1e-5, atol=1e-6)
    p = v["params"]
    ref = (x - mean) / np.sqrt(var + blocks.BN_EPSILON) * p["scale"] + p["bias"]
    return got, ref


def case_batch_norm_eval():
    x = _rand(9, (B, 8, 8, 3))
    v = _bn_variables(x)
    got, updates = _apply(blocks.batch_norm, v, x)
    assert updates == {}
    st, p = v["batch_stats"], v["params"]
    ref = ((x - st["mean"]) / np.sqrt(st["var"] + blocks.BN_EPSILON)
           * p["scale"] + p["bias"])
    return got, ref


def case_max_pool():
    x = _rand(10, (B, 10, 10, 3))
    got = np.asarray(blocks.max_pool(jnp.asarray(x), 2))
    return got, x.reshape(B, 5, 2, 5, 2, 3).max(axis=(2, 4))


def case_attention():
    x = _rand(11, (B, 5, 31))
    v = _init(blocks.self_attention, x, 16)
    got, _ = _apply(blocks.self_attention, v, x, 16)
    p = v["params"]
    q, k, val = (x @ p[f"Dense_{i}"]["kernel"] + p[f"Dense_{i}"]["bias"]
                 for i in range(3))
    w = np.einsum("bqd,bkd->bqk", q, k)
    w = np.exp(w - w.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return got, np.maximum(np.einsum("bqk,bkd->bqd", w, val), 0.0)


CASES = {f.__name__[5:]: f for f in (
    case_dense, case_conv_valid, case_conv_same, case_batch_norm_train,
    case_batch_norm_eval, case_max_pool, case_attention)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_numpy_reference(name):
    got, ref = CASES[name]()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
