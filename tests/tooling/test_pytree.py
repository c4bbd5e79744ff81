"""The pytree dataclass helper behind EnvState and TrainState."""

import jax
import jax.numpy as jnp
import numpy as np

from placement_tpu.utils import pytree


@pytree.dataclass
class _Node:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: str = pytree.static_field(default="x")


def _node(tag="x"):
    return _Node(a=jnp.arange(3.0), b=jnp.ones((2, 2), jnp.int32), tag=tag)


def test_leaves_roundtrip_and_static_field_stays_out():
    node = _node(tag="boards")
    leaves, treedef = jax.tree_util.tree_flatten(node)
    assert len(leaves) == 2                      # `tag` is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _Node) and back.tag == "boards"
    np.testing.assert_array_equal(back.a, node.a)
    np.testing.assert_array_equal(back.b, node.b)
    doubled = jax.tree_util.tree_map(lambda x: x * 2, node)
    assert doubled.tag == "boards"
    np.testing.assert_array_equal(doubled.a, node.a * 2)


def test_replace_returns_a_new_node():
    node = _node()
    new = node.replace(a=jnp.zeros(3))
    np.testing.assert_array_equal(new.a, np.zeros(3))
    np.testing.assert_array_equal(node.a, np.arange(3.0))   # frozen original
    assert new.tag == node.tag and new.b is node.b


def test_jit_does_not_retrace_for_new_leaf_values():
    traces = []

    @jax.jit
    def total(node):
        traces.append(node.tag)
        return node.a.sum() + node.b.sum()

    assert float(total(_node())) == 3.0 + 4.0
    assert float(total(_node().replace(a=jnp.ones(3)))) == 3.0 + 4.0
    assert traces == ["x"]
    total(_node(tag="y"))                        # static value: new trace
    assert traces == ["x", "y"]
