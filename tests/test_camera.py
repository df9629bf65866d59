"""Camera matrix-chain + ray-gen tests vs an independent reimplementation
of RefractionDemo.cpp:559-565 and RayTracing.hlsl:27-40."""

import numpy as np

from refraction.camera import (
    generate_rays,
    look_at_lh,
    orbit_camera,
    perspective_fov_lh,
    translation,
)
from refraction.config import RenderConfig


def test_perspective_matrix_values():
    m = perspective_fov_lh(np.pi / 2, 2.0, 1.0, 100.0)
    assert np.isclose(m[1, 1], 1.0)          # cot(45deg)
    assert np.isclose(m[0, 0], 0.5)
    assert np.isclose(m[2, 2], 100 / 99)
    assert np.isclose(m[3, 2], -100 / 99)
    assert m[2, 3] == 1.0 and m[3, 3] == 0.0


def test_look_at_identity_like():
    # eye at -z looking at origin: view should map eye to origin.
    eye = np.array([0.0, 0.0, -3.0])
    m = look_at_lh(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]))
    # row-vector convention: [eye, 1] @ m == origin
    out = np.append(eye, 1.0) @ m
    np.testing.assert_allclose(out, [0, 0, 0, 1], atol=1e-12)
    # forward (+z in view space): a point further along -z -> larger view z?
    p = np.append([0.0, 0.0, 1.0], 1.0) @ m
    assert p[2] > 3.0  # in front, beyond the eye distance


def test_translation_row_layout():
    m = translation(np.array([1.0, 2.0, 3.0, 9.0]))
    np.testing.assert_allclose(m[3], [1, 2, 3, 1])
    out = np.array([0, 0, 0, 1.0]) @ m
    np.testing.assert_allclose(out, [1, 2, 3, 1])


def _rays_independent(angle, cfg, width, height):
    """Scalar per-pixel reimplementation (float64) of the whole chain."""
    fov = cfg.fov_y_deg / 180.0 * 3.1415
    h = np.cos(fov / 2) / np.sin(fov / 2)
    w = h / cfg.resolved_aspect
    rng = cfg.z_far / (cfg.z_far - cfg.z_near)
    proj = np.array(
        [[w, 0, 0, 0], [0, h, 0, 0], [0, 0, rng, 1], [0, 0, -rng * cfg.z_near, 0]]
    )
    loc = np.array([5 * np.cos(angle), 0, 5 * np.sin(angle)])
    world = np.eye(4)
    world[3, :3] = loc
    eye = np.array([np.cos(-angle), 0.0, np.sin(-angle)])
    z = -eye / np.linalg.norm(eye)
    x = np.cross([0, 1, 0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.zeros((4, 4))
    view[:3, 0] = x
    view[:3, 1] = y
    view[:3, 2] = z
    view[3] = [-x @ eye, -y @ eye, -z @ eye, 1]
    a = proj @ world @ view
    dirs = np.zeros((height, width, 3))
    for py in range(height):
        for px in range(width):
            sx = (px + 0.5) / width * 2 - 1
            sy = -((py + 0.5) / height * 2 - 1)
            r = np.linalg.solve(a, np.array([sx, sy, 0.0, 1.0]))
            dirs[py, px] = r[:3] / np.linalg.norm(r[:3])
    return loc, dirs


def test_generate_rays_matches_independent():
    cfg = RenderConfig()
    angle = 0.37
    w, h = 8, 6
    frame = orbit_camera(angle, cfg)
    origins, dirs = generate_rays(frame, w, h, xp=np)
    loc, dirs_ref = _rays_independent(angle, cfg, w, h)
    np.testing.assert_allclose(origins[0], loc, rtol=1e-6)
    np.testing.assert_allclose(
        dirs.reshape(h, w, 3), dirs_ref, rtol=0, atol=5e-6
    )
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=-1), 1.0, atol=1e-6)


def test_rays_hit_scene_region():
    """Primary rays should converge toward the origin region (the orbit
    looks inward) — a sanity check that the quirky matrix chain still
    produces an inward-looking camera, as the demo's rendered output
    implies."""
    cfg = RenderConfig()
    frame = orbit_camera(0.01, cfg)
    origins, dirs = generate_rays(frame, 32, 24, xp=np)
    # distance from origin to each ray line
    o = origins.astype(np.float64)
    d = dirs.astype(np.float64)
    tclosest = -np.sum(o * d, axis=-1)
    assert (tclosest > 0).all()  # origin is in front of the camera
    closest = o + tclosest[:, None] * d
    dist = np.linalg.norm(closest, axis=-1)
    # center ray passes near the origin
    center = dist.reshape(24, 32)[12, 16]
    assert center < 0.5
    # a unit-ish object at the origin is inside the frustum
    assert dist.min() < 0.2


def test_jitter_offsets():
    cfg = RenderConfig()
    frame = orbit_camera(0.2, cfg)
    n = 4 * 3
    j_center = np.full((n, 2), 0.5, np.float32)
    o1, d1 = generate_rays(frame, 4, 3, xp=np)
    o2, d2 = generate_rays(frame, 4, 3, jitter=j_center, xp=np)
    np.testing.assert_allclose(d1, d2, atol=1e-7)
    j_other = np.zeros((n, 2), np.float32)
    _, d3 = generate_rays(frame, 4, 3, jitter=j_other, xp=np)
    assert np.abs(d3 - d1).max() > 1e-4
