"""Unit tests for the shading math vs closed-form (RayTracing.hlsl:66-76,92-93,127-137)."""

import numpy as np

from refraction.io.primitives import make_gradient_envmap
from refraction.ops.shade import (
    envmap_color,
    fresnel_r,
    normalize,
    reflect_dir,
    refract_dir,
)


def test_reflect_basic():
    i = np.array([[0.0, -1.0, 0.0]], np.float32)
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    np.testing.assert_allclose(reflect_dir(i, n, np), [[0, 1, 0]], atol=1e-7)
    # 45 degrees
    i = normalize(np.array([[1.0, -1.0, 0.0]], np.float32), np)
    r = reflect_dir(i, n, np)
    np.testing.assert_allclose(r, normalize(np.array([[1.0, 1.0, 0.0]]), np), atol=1e-7)


def test_refract_snell():
    """Refracted direction satisfies Snell's law for eta = 1/1.3."""
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    for deg in (10, 30, 55, 70):
        th = np.radians(deg)
        i = np.array([[np.sin(th), -np.cos(th), 0.0]], np.float32)
        ok, r = refract_dir(i, n, np.array([1 / 1.3], np.float32), np)
        assert ok.all()
        sin_out = np.abs(r[0, 0])
        np.testing.assert_allclose(sin_out, np.sin(th) / 1.3, rtol=1e-5)
        assert r[0, 1] < 0  # continues downward
        np.testing.assert_allclose(np.linalg.norm(r[0]), 1.0, atol=1e-6)


def test_refract_tir():
    """Inside->outside at grazing angle: total internal reflection."""
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    crit = np.arcsin(1 / 1.3)
    th = crit + 0.05
    i = np.array([[np.sin(th), -np.cos(th), 0.0]], np.float32)
    ok, _ = refract_dir(i, -n, np.array([1.3], np.float32), np)
    # hitting from below the surface with eta=1.3 beyond critical angle
    ok2, _ = refract_dir(i, n, np.array([1.3], np.float32), np)
    assert not ok2.any()
    th = crit - 0.05
    i = np.array([[np.sin(th), -np.cos(th), 0.0]], np.float32)
    ok3, _ = refract_dir(i, n, np.array([1.3], np.float32), np)
    assert ok3.all()


def test_fresnel_reference_formula():
    """R = R0(1-R0)(1-dot)^5 with R0 = (0.2/2.2)^2 — NOT canonical Schlick."""
    r0 = np.float32((0.2 / 2.2) ** 2)
    for dot in (-1.0, -0.5, 0.0, 0.3):
        expected = r0 * (1 - r0) * (1 - dot) ** 5
        np.testing.assert_allclose(
            fresnel_r(np.float32(dot), r0), expected, rtol=1e-6
        )
    # head-on from outside: dot = -1 -> R = R0(1-R0)*32 ~ 0.262
    assert 0.25 < fresnel_r(np.float32(-1.0), r0) < 0.27


def test_envmap_axis_directions():
    env = make_gradient_envmap(64, 128)
    h, w = env.shape[:2]
    dirs = np.array(
        [
            [0, 0, 1],   # +z: atan2(0,1)=0   -> theta = w/2
            [1, 0, 0],   # +x: atan2(1,0)=pi/2 -> theta = 3w/4
            [0, 1, 0],   # +y: acos(1)=0      -> phi = 0 (top row)
            [0, -1, 0],  # -y: acos(-1)=pi    -> phi ~ h (clamped to h-1)
        ],
        np.float32,
    )
    out = envmap_color(dirs, env, np)
    np.testing.assert_allclose(out[0], env[32, 64])
    np.testing.assert_allclose(out[1], env[32, 96])
    np.testing.assert_allclose(out[2], env[0, 64])
    np.testing.assert_allclose(out[3], env[63, 64])


def test_envmap_truncation_not_rounding():
    env = make_gradient_envmap(64, 128)
    # a direction giving theta = 64.99 must pick texel 64, not 65
    pi = 3.14159
    theta_target = 64.99
    az = (theta_target * 2 / 128 - 1) * pi
    d = np.array([[np.sin(az), 0.0, np.cos(az)]], np.float32)
    out = envmap_color(d, env, np)
    np.testing.assert_allclose(out[0], env[32, 64])
