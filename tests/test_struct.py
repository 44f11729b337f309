"""utils/struct: frozen dataclasses registered as JAX pytrees."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from qmmx_monolithic_monte_carlo_tpu.utils import struct


@struct.dataclass
class Point:
    x: jnp.ndarray
    y: jnp.ndarray = struct.field(default_factory=lambda: jnp.float32(0.0))
    label: str = struct.field(pytree_node=False, default="p")


def test_pytree_round_trip():
    p = Point(jnp.arange(3.0), jnp.float32(2.0), "a")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, Point) and q.label == "a"
    assert jnp.array_equal(q.x, p.x) and float(q.y) == 2.0


def test_static_field_is_aux_data():
    a, b = Point(jnp.ones(2), label="a"), Point(jnp.ones(2), label="b")
    assert jax.tree_util.tree_structure(a) != jax.tree_util.tree_structure(b)
    traced = []

    @jax.jit
    def f(p):
        traced.append(p.label)             # static: a plain str under jit
        return p.x * 2

    f(a)
    f(b)
    assert traced == ["a", "b"]


def test_replace_returns_a_new_instance():
    p = Point(jnp.ones(2))
    q = p.replace(y=jnp.float32(5.0))
    assert float(p.y) == 0.0 and float(q.y) == 5.0 and q.label == p.label


def test_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        Point(jnp.ones(2)).x = jnp.zeros(2)


def test_tree_map_and_vmap():
    p = Point(jnp.arange(4.0), jnp.arange(4.0) * 2)
    doubled = jax.tree_util.tree_map(lambda v: v * 2, p)
    assert float(doubled.y[3]) == 12.0
    sums = jax.vmap(lambda q: q.x + q.y)(p)
    assert sums.tolist() == [0.0, 3.0, 6.0, 9.0]
