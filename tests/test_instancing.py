"""TLAS-with-N-instances via transform baking (scene.Instance /
build_instanced_scene): the generalization of the reference's one-
instance TLAS (RefractionDemo.cpp:325-335). Baked instancing must be
indistinguishable from a manually merged mesh, normals must follow the
inverse-transpose under non-uniform scale, and DXR mask semantics hold
under the reference's always-0xff ray mask."""

import json
import os

import numpy as np
import pytest

from conftest import rmse
from refraction.camera import orbit_camera
from refraction.config import RenderConfig
from refraction.io.primitives import (
    make_cube, make_gradient_envmap, make_icosphere)
from refraction.render import make_renderer
from refraction.scene import (
    Instance, build_instanced_scene, build_scene, instance_transform,
    load_instanced, merge_meshes, _transform_mesh)


def _render(scene, cfg, angle=0.4):
    return np.asarray(make_renderer(cfg)(scene, orbit_camera(angle, cfg)))


def test_identity_instance_matches_plain_scene():
    mesh = make_cube(2.0)
    env = make_gradient_envmap()
    plain, meta_p = build_scene(mesh, env, cluster_size=8)
    inst, meta_i = build_instanced_scene([Instance(mesh)], env,
                                         cluster_size=8)
    assert meta_i.num_real_tris == meta_p.num_real_tris
    for a, b in zip(plain, inst):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_two_instances_equal_merged_mesh():
    """Two translated cubes built via Instance == the same triangles
    merged by hand; the rendered images must agree exactly."""
    mesh = make_cube(1.0)
    env = make_gradient_envmap()
    t1 = instance_transform(translate=(-1.2, 0.0, 0.0))
    t2 = instance_transform(translate=(1.2, 0.0, 0.0), rotate_y_deg=30.0)
    inst_scene, meta = build_instanced_scene(
        [Instance(mesh, t1), Instance(mesh, t2)], env, cluster_size=8)
    assert meta.num_real_tris == 2 * mesh.num_tris

    manual = merge_meshes([_transform_mesh(mesh, t1),
                           _transform_mesh(mesh, t2)])
    manual_scene, _ = build_scene(manual, env, cluster_size=8)

    cfg = RenderConfig(width=64, height=48, backend="xla",
                       max_refract_depth=3)
    np.testing.assert_array_equal(
        _render(inst_scene, cfg), _render(manual_scene, cfg))


def test_nonuniform_scale_normals_inverse_transpose():
    """Icosphere smooth normals are unit positions; squashing by
    diag(a,b,c) must yield baked shading normals parallel to the
    analytic ellipsoid gradient (x/a^2, y/b^2, z/c^2)."""
    mesh = make_icosphere(subdiv=1, radius=1.0)
    scale = (2.0, 0.5, 1.0)
    baked = _transform_mesh(mesh, instance_transform(scale=scale))
    s = np.asarray(scale, np.float64)
    # Gradient of (x/a)^2+(y/b)^2+(z/c)^2 at the transformed point s*p
    # is (s*p)/s^2 = p/s.
    analytic = mesh.positions.astype(np.float64) / s
    analytic /= np.linalg.norm(analytic, axis=-1, keepdims=True)
    got = baked.normals.astype(np.float64)
    got /= np.linalg.norm(got, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, analytic, atol=1e-5)


def test_mask_zero_instance_invisible():
    """DXR InstanceMask: rays trace with mask 0xff (RayTracing.hlsl:60),
    so a mask-0 instance must not appear; all-masked-out scenes error."""
    mesh = make_cube(1.0)
    env = make_gradient_envmap()
    one, _ = build_instanced_scene([Instance(mesh)], env, cluster_size=8)
    with_ghost, _ = build_instanced_scene(
        [Instance(mesh),
         Instance(mesh, instance_transform(translate=(2.5, 0, 0)), mask=0)],
        env, cluster_size=8)
    cfg = RenderConfig(width=64, height=48, backend="xla",
                       max_refract_depth=2)
    assert rmse(_render(one, cfg), _render(with_ghost, cfg)) == 0.0
    with pytest.raises(ValueError, match="masked out"):
        build_instanced_scene([Instance(mesh, mask=0)], env, cluster_size=8)


def test_per_ray_inclusion_mask():
    """TraceRay's InstanceInclusionMask as a PER-RAY capability (the
    full DXR semantic, RayTracing.hlsl:60 — the reference only ever
    passes 0xff): instance visible to a ray iff
    ``InstanceMask & InstanceInclusionMask != 0``; children inherit
    their parent's mask (the shader re-passes 0xff on every recursive
    TraceRay, :106,121). Ground truth by scene surgery: rays whose mask
    excludes instance B must render exactly as if B was never built."""
    import jax.numpy as jnp

    from refraction.camera import generate_rays
    from refraction.integrator import render_pixels
    from refraction.ops.backends import xla_intersect
    from refraction.ops.shade import envmap_color

    mesh = make_cube(1.0)
    env = make_gradient_envmap()
    tA = instance_transform(translate=(-1.2, 0.0, 0.0))
    tB = instance_transform(translate=(1.2, 0.0, 0.0), rotate_y_deg=30.0)
    both, _ = build_instanced_scene(
        [Instance(mesh, tA, mask=1), Instance(mesh, tB, mask=2)], env,
        cluster_size=8)
    only_a, _ = build_instanced_scene([Instance(mesh, tA, mask=1)], env,
                                      cluster_size=8)
    only_b, _ = build_instanced_scene([Instance(mesh, tB, mask=2)], env,
                                      cluster_size=8)
    cfg = RenderConfig(width=64, height=48, backend="xla",
                       max_refract_depth=3)
    frame = orbit_camera(0.4, cfg)
    o, d = generate_rays(frame, cfg.width, cfg.height, xp=np)
    o, d = jnp.asarray(o), jnp.asarray(d)
    n = o.shape[0]

    def rp(scene, mask):
        if mask is not None and np.ndim(mask) == 0:
            mask = np.full((n,), mask, np.int32)
        return np.asarray(render_pixels(
            scene, o, d, cfg, xla_intersect,
            ray_mask=None if mask is None else jnp.asarray(mask)))

    full = rp(both, None)
    # 0xff (the reference's constant) admits every instance — identical
    # winners, identical float math, bit-identical image.
    np.testing.assert_array_equal(rp(both, 0xFF), full)
    # Masking out B == B never existed (same per-(ray, tri) math, same
    # unique winners; only the triangle table order differs).
    np.testing.assert_allclose(rp(both, 1), rp(only_a, None),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(rp(both, 2), rp(only_b, None),
                               atol=1e-6, rtol=0)
    # A mask matching no instance: the pure envmap image (all rays miss
    # at the primary round with weight 1).
    env_img = np.asarray(envmap_color(d, both.envmap, jnp))
    np.testing.assert_allclose(rp(both, 4), env_img, atol=1e-6, rtol=0)
    # Heterogeneous per-ray masks: left half sees A only, right half B
    # only — each half must match its homogeneous render exactly.
    per_ray = np.where(np.arange(n) % cfg.width < cfg.width // 2,
                       1, 2).astype(np.int32)
    mixed = rp(both, per_ray).reshape(cfg.height, cfg.width, 3)
    a_img = rp(both, 1).reshape(cfg.height, cfg.width, 3)
    b_img = rp(both, 2).reshape(cfg.height, cfg.width, 3)
    half = cfg.width // 2
    np.testing.assert_array_equal(mixed[:, :half], a_img[:, :half])
    np.testing.assert_array_equal(mixed[:, half:], b_img[:, half:])


def test_singular_transform_rejected():
    m = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError, match="singular"):
        _transform_mesh(make_cube(1.0), m)


def test_load_instanced_spec(tmp_path, asset_dir):
    """CLI spec loader: obj paths resolve against the asset dir, the
    convenience transform fields compose, and the result renders."""
    spec = [
        {"obj": "cube.obj", "translate": [-1.5, 0, 0], "scale": 0.8},
        {"obj": "cube.obj", "rotate_y_deg": 45.0, "translate": [1.5, 0, 0]},
    ]
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    cfg = RenderConfig(width=48, height=32, backend="xla",
                       max_refract_depth=2,
                       scene_path=os.path.join(asset_dir, "shell.obj"),
                       envmap_path=os.path.join(asset_dir, "envmap.png"))
    scene, meta = load_instanced(str(path), cfg)
    assert meta.num_real_tris == 24  # two cubes
    img = _render(scene, cfg)
    assert np.isfinite(img).all() and img.max() > 0
