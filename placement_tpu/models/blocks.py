"""Model building blocks (reference: agent/models/model_building_blocks.py).

Layers are plain functions of a ``Scope`` that holds the model's variables as
``{"params": ..., "batch_stats": ...}`` nested dicts keyed by layer name.
ConvBlock = Conv2D + BatchNorm + activation (+ optional max-pool) (:11-77);
``conv_blocks`` stacks N of them (:80-142) under the names ``Conv_i`` and
``BatchNorm_i``; ``self_attention`` is single-head QKV self-attention with a
relu output (:145-179) whose projections are ``Dense_0..2``. Convs run in
NHWC; the attention einsums accumulate in f32.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
from jax import lax

ACTIVATIONS: dict = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
}

# Keras' BatchNormalization defaults, which the reference's models use.
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3

_kernel_init = jax.nn.initializers.lecun_normal()
_zeros = jax.nn.initializers.zeros
_ones = jax.nn.initializers.ones


def get_activation(name) -> Callable:
    """String -> fn map (utils/agent/utils.py:106-151)."""
    if callable(name):
        return name
    return ACTIVATIONS[name]


def _lookup(tree: Dict, path: Tuple[str, ...]) -> Any:
    for name in path:
        tree = tree[name]
    return tree


def _insert(tree: Dict, path: Tuple[str, ...], value: Any) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


class Scope:
    """The variables one forward pass reads, addressed by layer path.

    ``Scope.initializing(key)`` starts from no variables and creates each
    one the first time a layer asks for it, drawing its initial value from
    ``key`` folded with the variable's path. ``Scope.bound(variables,
    train)`` reads existing variables; in train mode batch norm normalises
    with the batch's statistics and records the new running statistics in
    ``updates``.
    """

    def __init__(self, variables: Dict, *, train: bool = False,
                 key: Any = None, path: Tuple[str, ...] = (),
                 updates: Dict = None):
        self.variables = variables
        self.train = train
        self.key = key
        self.path = path
        self.updates = {} if updates is None else updates

    @classmethod
    def initializing(cls, key) -> "Scope":
        return cls({}, key=key)

    @classmethod
    def bound(cls, variables: Dict, train: bool = False) -> "Scope":
        return cls(variables, train=train)

    def child(self, name: str) -> "Scope":
        return Scope(self.variables, train=self.train, key=self.key,
                     path=self.path + (name,), updates=self.updates)

    def _get(self, collection: str, name: str, make: Callable) -> Any:
        path = self.path + (name,)
        if self.key is not None:
            tree = self.variables.setdefault(collection, {})
            try:
                return _lookup(tree, path)
            except KeyError:
                _insert(tree, path, make(path))
        return _lookup(self.variables[collection], path)

    def param(self, name: str, init: Callable, shape: Tuple[int, ...]
              ) -> jnp.ndarray:
        def make(path):
            salt = zlib.crc32("/".join(path).encode())
            return init(jax.random.fold_in(self.key, salt), shape,
                        jnp.float32)
        return self._get("params", name, make)

    def stat(self, name: str, value: jnp.ndarray) -> jnp.ndarray:
        return self._get("batch_stats", name, lambda _: value)

    def update_stat(self, name: str, value: jnp.ndarray) -> None:
        _insert(self.updates.setdefault("batch_stats", {}),
                self.path + (name,), value)


def dense(s: Scope, x: jnp.ndarray, features: int) -> jnp.ndarray:
    """Affine map over the last axis (kernel ``[in, features]``)."""
    kernel = s.param("kernel", _kernel_init, (x.shape[-1], features))
    bias = s.param("bias", _zeros, (features,))
    y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    return y + bias


def conv(s: Scope, x: jnp.ndarray, features: int, kernel_size: int,
         padding: str = "VALID") -> jnp.ndarray:
    """Stride-1 2-D convolution of NHWC input (kernel HWIO)."""
    k = kernel_size
    kernel = s.param("kernel", _kernel_init, (k, k, x.shape[-1], features))
    bias = s.param("bias", _zeros, (features,))
    y = lax.conv_general_dilated(x, kernel, (1, 1), padding,
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + bias


def batch_norm(s: Scope, x: jnp.ndarray) -> jnp.ndarray:
    """Batch norm over every axis but the last (features)."""
    feat = (x.shape[-1],)
    ra_mean = s.stat("mean", jnp.zeros(feat, jnp.float32))
    ra_var = s.stat("var", jnp.ones(feat, jnp.float32))
    scale = s.param("scale", _ones, feat)
    bias = s.param("bias", _zeros, feat)
    if s.train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        var = jnp.maximum(0.0, jnp.mean(jnp.square(x), axes)
                          - jnp.square(mean))
        s.update_stat("mean", BN_MOMENTUM * ra_mean + (1 - BN_MOMENTUM) * mean)
        s.update_stat("var", BN_MOMENTUM * ra_var + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = ra_mean, ra_var
    return (x - mean) * (lax.rsqrt(var + BN_EPSILON) * scale) + bias


def max_pool(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Non-overlapping ``size x size`` max-pool of NHWC input, VALID."""
    window = (1, size, size, 1)
    return lax.reduce_window(x, -jnp.inf, lax.max, window, window, "VALID")


def conv_blocks(s: Scope, x: jnp.ndarray, num_blocks: int, num_filters: int,
                kernel_size: int, activation: str = "relu",
                max_pool_size: int = 0, padding: str = "VALID",
                use_batch_norm: bool = True) -> jnp.ndarray:
    """N stacked Conv+Norm+act(+pool) blocks; auto-expands HW input to HWC
    (model_building_blocks.py:59-60). ``max_pool_size`` 0 means no pool."""
    if x.ndim == 3:  # [B, H, W] -> [B, H, W, 1]
        x = x[..., None]
    act = get_activation(activation)
    for i in range(num_blocks):
        x = conv(s.child(f"Conv_{i}"), x, num_filters, kernel_size, padding)
        if use_batch_norm:
            x = batch_norm(s.child(f"BatchNorm_{i}"), x)
        x = act(x)
        if max_pool_size:
            x = max_pool(x, max_pool_size)
    return x


def attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray
              ) -> jnp.ndarray:
    """relu(softmax(q k^T) v) with no 1/sqrt(d) scaling, as the reference
    (model_building_blocks.py:160-179)."""
    w = jnp.einsum("...qd,...kd->...qk", q, k,
                   preferred_element_type=jnp.float32)
    w = jax.nn.softmax(w, axis=-1)
    out = jnp.einsum("...qk,...kd->...qd", w, v,
                     preferred_element_type=jnp.float32)
    return jax.nn.relu(out)


def self_attention(s: Scope, x: jnp.ndarray, hidden_size: int
                   ) -> jnp.ndarray:
    """Single-head QKV self-attention over the second-to-last axis."""
    q, k, v = (dense(s.child(f"Dense_{i}"), x, hidden_size)
               for i in range(3))
    return attention(q, k, v)


def mask_logits(logits, mask) -> jnp.ndarray:
    """logits += max(log(mask), f32.min) (square_model.py:137-139)."""
    neg = jnp.finfo(jnp.float32).min
    return logits + jnp.maximum(jnp.log(jnp.maximum(mask, 0.0)), neg)
