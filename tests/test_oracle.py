"""Physical sanity checks on the NumPy oracle tracer (SURVEY.md 3.3)."""

import numpy as np

from oracle.numpy_tracer import render_oracle, trace_batch
from refraction.camera import generate_rays, orbit_camera
from refraction.config import RenderConfig
from refraction.ops.shade import envmap_color


def test_miss_pixels_equal_envmap(cube_scene, small_cfg):
    scene, _ = cube_scene
    cfg = small_cfg
    img = render_oracle(scene, cfg, angle=0.3)
    frame = orbit_camera(0.3, cfg)
    _, dirs = generate_rays(frame, cfg.width, cfg.height, xp=np)
    env = envmap_color(dirs, scene.envmap, np).reshape(cfg.height, cfg.width, 3)

    # Corner pixels miss the unit cube from orbit radius 5 -> pure envmap.
    for py, px in [(0, 0), (0, -1), (-1, 0), (-1, -1)]:
        np.testing.assert_allclose(img[py, px], env[py, px], atol=1e-6)

    # The object must actually appear: center differs from raw envmap.
    cy, cx = cfg.height // 2, cfg.width // 2
    assert np.abs(img[cy, cx] - env[cy, cx]).max() > 1e-3


def test_energy_bound(cube_scene, small_cfg):
    """Branch weights satisfy (1-R) + R <= 1 along every path, so no pixel
    exceeds the envmap maximum."""
    scene, _ = cube_scene
    img = render_oracle(scene, small_cfg, angle=0.7)
    assert img.min() >= 0.0
    assert img.max() <= scene.envmap.max() + 1e-5


def test_zero_bounce_cap_blackens_object(cube_scene, small_cfg):
    scene, _ = cube_scene
    cfg = small_cfg.replace(max_refract_depth=0)
    img = render_oracle(scene, cfg, angle=0.3)
    cy, cx = cfg.height // 2, cfg.width // 2
    np.testing.assert_allclose(img[cy, cx], 0.0, atol=1e-7)


def test_sphere_refraction_visible(sphere_scene, small_cfg):
    """A dielectric sphere inverts/distorts the background: the image seen
    through the sphere differs from the direct envmap but stays lit (not
    black), proving entry/exit refraction and the Fresnel split work."""
    scene, _ = sphere_scene
    cfg = small_cfg
    img = render_oracle(scene, cfg, angle=0.1)
    cy, cx = cfg.height // 2, cfg.width // 2
    center = img[cy - 2:cy + 2, cx - 2:cx + 2]
    assert center.max() > 0.05
    frame = orbit_camera(0.1, cfg)
    _, dirs = generate_rays(frame, cfg.width, cfg.height, xp=np)
    env = envmap_color(dirs, scene.envmap, np).reshape(cfg.height, cfg.width, 3)
    assert np.abs(center - env[cy - 2:cy + 2, cx - 2:cx + 2]).max() > 1e-2


def test_reflection_contribution(sphere_scene, small_cfg):
    """Disabling reflection splits must change hit-pixel radiance."""
    scene, _ = sphere_scene
    img_with = render_oracle(scene, small_cfg, angle=0.1)
    img_without = render_oracle(
        scene, small_cfg.replace(max_reflect_depth=0), angle=0.1
    )
    assert np.abs(img_with - img_without).max() > 1e-4


def test_trace_batch_empty(cube_scene, small_cfg):
    scene, _ = cube_scene
    out = trace_batch(
        scene,
        np.zeros((0, 3), np.float32),
        np.zeros((0, 3), np.float32),
        np.zeros(0, bool),
        0,
        small_cfg,
        1e-4,
        100.0,
    )
    assert out.shape == (0, 3)
