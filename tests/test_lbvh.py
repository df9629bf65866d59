"""LBVH build + traversal property tests: BVH == brute force (the key
oracle for the traversal we replace DXR hardware with, SURVEY.md 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import rmse
from refraction.bvh.lbvh import build_lbvh, lbvh_from_scene, lbvh_intersect
from refraction.ops.backends import xla_intersect


def _rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wf = rng.random(n) < 0.5
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf)


@pytest.mark.parametrize("scene_fixture", ["cube_scene", "sphere_scene"])
def test_lbvh_equals_brute_force(scene_fixture, request):
    scene, _ = request.getfixturevalue(scene_fixture)
    bvh = lbvh_from_scene(scene)
    o, d, wf = _rays(600, seed=3)
    tmin, tmax = jnp.float32(1e-4), jnp.float32(100.0)

    h1, t1, i1, _ = xla_intersect(
        scene, o, d, wf, jnp.ones(600, bool), tmin, tmax)
    h2, t2, i2 = jax.jit(
        lambda oo, dd, ww: lbvh_intersect(bvh, oo, dd, ww, tmin, tmax)
    )(o, d, wf)

    h1, t1, i1 = map(np.asarray, (h1, t1, i1))
    h2, t2, i2 = map(np.asarray, (h2, t2, i2))
    assert (h1 == h2).all()
    m = h1
    np.testing.assert_allclose(t1[m], t2[m], atol=1e-5)
    # idx can differ only on exact-t ties (measure zero on random rays)
    assert (i1[m] == i2[m]).mean() > 0.999


def test_lbvh_tree_structure(sphere_scene):
    scene, _ = sphere_scene
    bvh = lbvh_from_scene(scene)
    l = bvh.num_leaves
    assert (l & (l - 1)) == 0  # power of two
    lo = np.asarray(bvh.node_lo)
    hi = np.asarray(bvh.node_hi)
    # Every internal node's box contains its children's boxes.
    for node in range(l - 1):
        for child in (2 * node + 1, 2 * node + 2):
            # empty child boxes (inverted) are trivially "contained"
            if (lo[child] <= hi[child]).all():
                assert (lo[node] <= lo[child] + 1e-6).all()
                assert (hi[node] >= hi[child] - 1e-6).all()


def test_lbvh_backend_renders(sphere_scene, small_cfg):
    """Full render through the LBVH backend matches the XLA brute force."""
    from refraction.bvh.lbvh import make_lbvh_backend
    from refraction.render import render_frame

    scene, _ = sphere_scene
    cfg = small_cfg.replace(width=32, height=16, backend="xla")
    ref = np.asarray(render_frame(scene, cfg, angle=0.6))
    got = np.asarray(render_frame(
        scene, cfg, angle=0.6, intersect_fn=make_lbvh_backend(scene)))
    assert rmse(ref, got) < 1e-6


def test_lbvh_degenerate_padding():
    """Trees built from padded scenes never hit the padding triangles."""
    tri_a = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (5, 3)), jnp.float32)
    zeros = jnp.zeros((5, 3), jnp.float32)
    bvh = build_lbvh(tri_a, zeros, zeros)  # all-degenerate: no hits ever
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (8, 1))
    hit, _, _ = lbvh_intersect(
        bvh, o, d, jnp.ones(8, bool), jnp.float32(1e-4), jnp.float32(100.0))
    assert not np.asarray(hit).any()
