"""utils/pytree.py: the frozen-dataclass pytree every scene record uses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from offline_raytracer_tpu.utils import pytree


@pytree.dataclass
class Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = pytree.field(static=True, default=2)


def test_flatten_keeps_static_fields_in_treedef():
    p = Pair(jnp.ones(3), jnp.zeros(2), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.n == 5
    assert treedef != jax.tree_util.tree_structure(Pair(jnp.ones(3), jnp.zeros(2)))


def test_replace_is_functional_and_frozen():
    p = Pair(jnp.ones(3), jnp.zeros(2))
    q = p.replace(b=jnp.full(2, 7.0))
    np.testing.assert_array_equal(np.asarray(p.b), 0.0)
    np.testing.assert_array_equal(np.asarray(q.b), 7.0)
    assert q.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(3)


def test_jit_and_grad_through_replace():
    p = Pair(jnp.arange(3.0), jnp.ones(3), n=3)

    @jax.jit
    def f(p):
        # static field drives Python control flow under jit
        return sum(p.a[i] * p.b[i] for i in range(p.n))

    g = jax.grad(lambda a: f(p.replace(a=a)))(p.a)
    np.testing.assert_allclose(np.asarray(g), 1.0)
    np.testing.assert_allclose(float(f(p)), 3.0)
    out = jax.jit(lambda p: p.replace(a=p.a * 2))(p)
    assert isinstance(out, Pair) and out.n == 3
    np.testing.assert_allclose(np.asarray(out.a), [0.0, 2.0, 4.0])


def test_scene_tree_maps():
    """The real records: a Scene round-trips through tree_map with its
    BVH's static sizes intact."""
    from offline_raytracer_tpu.models.scenes import blob

    s = blob(8, 8, subdiv=1)
    t = jax.tree.map(lambda x: x, s)
    assert t.tri_bvh.n_leaves == s.tri_bvh.n_leaves
    assert t.tri_bvh.first_leaf == s.tri_bvh.n_leaves - 1
    assert t.n_lights == s.n_lights
