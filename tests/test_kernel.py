"""Intersection kernel (Pallas interpreter) vs the XLA brute force — the key
property test replacing DXR's hardware traversal oracle (SURVEY.md 4).

On the CPU the kernel runs through the Pallas interpreter, so the two
backends evaluate the same float32 formulas in the same order and must
pick exactly the same winners."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import rmse
from refraction.io.objmesh import MeshData
from refraction.io.primitives import (make_cube, make_gradient_envmap,
                                          make_nested_shell)
from refraction.kernels.intersect_pallas import pallas_intersect
from refraction.ops.backends import get_backend, xla_intersect
from refraction.ops.intersect import intersect_brute
from refraction.scene import (DEFAULT_CLUSTER_SIZE, SUB_TRIS, Instance,
                              build_instanced_scene, build_scene, load_scene)

kernel = functools.partial(pallas_intersect, interpret=True)
LIMITS = (jnp.float32(1e-4), jnp.float32(100.0))


@pytest.fixture(scope="module")
def shell_scene():
    return build_scene(make_nested_shell(), make_gradient_envmap(),
                       cluster_size=32)


def _random_rays(n, seed=0, spread=3.0):
    """Origins anywhere in a box, directions uniform: mostly incoherent."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wf = rng.random(n) < 0.5
    al = rng.random(n) < 0.8
    return o, d, wf, al


def _aimed_rays(n, seed=0):
    """Rays from a sphere of radius 4 aimed near the center, front-facing
    and alive: most hit, and neighbours travel together."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3))
    src = 4.0 * src / np.linalg.norm(src, axis=1, keepdims=True)
    dst = rng.uniform(-0.8, 0.8, (n, 3))
    d = dst - src
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (src.astype(np.float32), d.astype(np.float32),
            np.ones(n, bool), np.ones(n, bool))


RAYS = {"random": _random_rays, "aimed": _aimed_rays}


def _both(scene, o, d, wf, al, **kw):
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf), jnp.asarray(al),
            *LIMITS)
    h1, t1, i1, _ = xla_intersect(scene, *args, **kw)
    h2, t2, i2, n2 = kernel(scene, *args, **kw)
    h1 = np.asarray(h1) & al  # xla backend ignores alive; kernel enforces it
    return (h1, np.asarray(t1), np.asarray(i1),
            np.asarray(h2), np.asarray(t2), np.asarray(i2), n2)


@pytest.mark.parametrize("rays", sorted(RAYS))
@pytest.mark.parametrize("scene_fixture",
                         ["cube_scene", "sphere_scene", "shell_scene"])
def test_kernel_matches_xla(scene_fixture, rays, request):
    scene, _ = request.getfixturevalue(scene_fixture)
    o, d, wf, al = RAYS[rays](1500, seed=1)
    h1, t1, i1, h2, t2, i2, n2 = _both(scene, o, d, wf, al)
    assert n2 is None  # the integrator gathers the winner's normal
    assert h1.any()
    assert (h1 == h2).all()
    assert (i1[h1] == i2[h1]).all()
    np.testing.assert_allclose(t1[h1], t2[h1], atol=1e-5)


def test_kernel_dead_lanes_never_hit(cube_scene):
    scene, _ = cube_scene
    o, d, wf, _ = _aimed_rays(1024, seed=2)
    h, _, _, _ = kernel(scene, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(wf), jnp.zeros(1024, bool), *LIMITS)
    assert not np.asarray(h).any()


@pytest.mark.parametrize("n", [1, 777])
def test_kernel_nonmultiple_block_padding(sphere_scene, n):
    """Ray counts that are not multiples of the block pad correctly."""
    scene, _ = sphere_scene
    o, d, wf, al = _aimed_rays(n, seed=3)
    h1, t1, _, h2, t2, _, _ = _both(scene, o, d, wf, al)
    assert h2.shape == t2.shape == (n,)
    assert (h1 == h2).all()
    np.testing.assert_allclose(t1[h1], t2[h1], atol=1e-5)


def test_kernel_lowest_index_ties():
    """Two copies of every triangle tie exactly; both backends and the
    NumPy brute force keep the lower index."""
    cube = make_cube(2.0)
    twice = MeshData(*(np.concatenate([a, a]) for a in
                       (cube.positions, cube.normals, cube.uvs)))
    scene, _ = build_scene(twice, make_gradient_envmap(), cluster_size=8)
    o, d, wf, al = _aimed_rays(512, seed=4)
    h1, _, i1, h2, _, i2, _ = _both(scene, o, d, wf, al)
    hb, _, ib, _, _ = intersect_brute(
        o, d, np.asarray(scene.tri_a), np.asarray(scene.tri_e1),
        np.asarray(scene.tri_e2), np.float32(1e-4), np.float32(100.0), wf,
        np)
    assert h1.sum() > 400
    assert (hb == h1).all() and (hb == h2).all()
    assert (ib[hb] == i1[hb]).all() and (ib[hb] == i2[hb]).all()
    # Each winner has a twin with a higher index at exactly the same t.
    tris = np.concatenate([np.asarray(scene.tri_a), np.asarray(scene.tri_e1),
                           np.asarray(scene.tri_e2)], axis=1)
    for k in np.nonzero(hb)[0][:50]:
        twins = np.nonzero((tris == tris[ib[k]]).all(axis=1))[0]
        assert len(twins) == 2 and ib[k] == twins.min()


def test_kernel_instance_masks():
    """tri_mask & ray_mask decides visibility, as in xla_intersect."""
    env = make_gradient_envmap()
    tr = np.eye(3, 4, dtype=np.float32)
    left, right = tr.copy(), tr.copy()
    left[0, 3], right[0, 3] = -1.2, 1.2
    scene, _ = build_instanced_scene(
        [Instance(make_cube(2.0), left, mask=1),
         Instance(make_cube(2.0), right, mask=2)], env, cluster_size=8)
    o, d, wf, al = _aimed_rays(1024, seed=5)
    rm = np.random.default_rng(5).integers(1, 4, 1024).astype(np.int32)
    h1, t1, i1, h2, t2, i2, _ = _both(scene, o, d, wf, al,
                                      ray_mask=jnp.asarray(rm))
    assert (h1 == h2).all() and (i1[h1] == i2[h1]).all()
    hit_mask = np.asarray(scene.tri_mask)[i2[h2]]
    assert ((hit_mask & rm[h2]) != 0).all()
    # Masking changes the answer for some rays (the test is not vacuous).
    h3, _, _, _ = kernel(scene, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(wf), jnp.asarray(al), *LIMITS)
    assert (np.asarray(h3) != h2).any()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_ray_mask_without_tri_mask_raises(cube_scene, backend):
    """A per-ray mask against a scene with no instance masks is an error
    in both backends, never a silent skip of the test."""
    scene, _ = cube_scene
    scene = scene._replace(tri_mask=None)
    fn = xla_intersect if backend == "xla" else kernel
    o, d, wf, al = _aimed_rays(16)
    with pytest.raises(ValueError, match="tri_mask"):
        fn(scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf),
           jnp.asarray(al), *LIMITS, ray_mask=jnp.ones(16, jnp.int32))


def test_kernel_rejects_mismatched_layout(sphere_scene):
    scene, _ = sphere_scene
    bad = scene._replace(sub_bounds=scene.sub_bounds[:-1])
    o, d, wf, al = _aimed_rays(8)
    with pytest.raises(ValueError, match="layout"):
        kernel(bad, jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf),
               jnp.asarray(al), *LIMITS)


def test_render_pallas_backend_matches_oracle(sphere_scene, small_cfg):
    """Full 32x24 wavefront render through the kernel (interpreter)."""
    from oracle.numpy_tracer import render_oracle
    from refraction.render import render_frame

    scene, _ = sphere_scene
    cfg = small_cfg.replace(width=32, height=24)
    img_j = np.asarray(render_frame(scene, cfg, angle=0.85,
                                    intersect_fn=kernel))
    img_o = render_oracle(scene, cfg, angle=0.85)
    assert rmse(img_j, img_o) < 1e-4


def test_get_backend_on_cpu():
    """'auto' is the XLA path off a GPU; the kernel needs a GPU unless
    the interpreter is asked for."""
    assert jax.default_backend() == "cpu"
    assert get_backend("auto").name == "xla"
    assert get_backend("pallas", interpret=True).name == "pallas"
    with pytest.raises(ValueError, match="GPU"):
        get_backend("pallas")
    with pytest.raises(RuntimeError, match="GPU"):
        pallas_intersect(None, None, None, None, None, *LIMITS)
    with pytest.raises(ValueError, match="unknown"):
        get_backend("no-such-backend")


@pytest.mark.parametrize("scene_fixture",
                         ["cube_scene", "sphere_scene", "shell_scene"])
def test_cluster_boxes_enclose_triangles(scene_fixture, request):
    """The culling boxes the kernel gates on contain their triangles:
    every cluster's box holds its subclusters' boxes, and every
    subcluster's box holds its SUB_TRIS triangles' corners."""
    scene, meta = request.getfixturevalue(scene_fixture)
    a = np.asarray(scene.tri_a)
    corners = np.stack([a, a + np.asarray(scene.tri_e1),
                        a + np.asarray(scene.tri_e2)], axis=1)
    sub = np.asarray(scene.sub_bounds)
    per_sub = corners.reshape(sub.shape[0], -1, 3)
    tol = 1e-6
    assert (per_sub >= sub[:, None, :3] - tol).all()
    assert (per_sub <= sub[:, None, 3:] + tol).all()
    spc = meta.cluster_size // SUB_TRIS
    lo, hi = np.asarray(scene.cluster_lo), np.asarray(scene.cluster_hi)
    sub_c = sub.reshape(lo.shape[0], spc, 6)
    assert (sub_c[..., :3] >= lo[:, None] - tol).all()
    assert (sub_c[..., 3:] <= hi[:, None] + tol).all()


def test_auto_cluster_size_table(asset_dir):
    """One power-of-two cluster size serves every scene that does not
    name its own (the demo and the 12k-triangle stand-ins alike)."""
    import os

    from refraction.config import RenderConfig

    c = DEFAULT_CLUSTER_SIZE
    assert c & (c - 1) == 0 and c % SUB_TRIS == 0
    for name in ("cube.obj", "shell.obj", "ott.obj"):
        cfg = RenderConfig(scene_path=os.path.join(asset_dir, name),
                           envmap_path=os.path.join(asset_dir, "envmap.png"))
        scene, meta = load_scene(cfg)
        assert meta.cluster_size == c
        assert scene.num_tris % c == 0
