"""Shading math shared by the oracle (numpy) and the device path (jax.numpy).

Every function reproduces the corresponding HLSL exactly (RayTracing.hlsl):

- ``reflect_dir``      <- ReflectRay            (RayTracing.hlsl:66-68)
- ``refract_dir``      <- RefractRay            (RayTracing.hlsl:70-76) —
  GLSL-style, returns a TIR mask instead of a bool, result normalized.
- ``fresnel_r``        <- the *nonstandard* Schlick at RayTracing.hlsl:92-93:
  ``R = R0 * (1 - R0) * (1 - dot(D, N'))^5`` (canonical Schlick would be
  ``R0 + (1-R0)(...)``; reproduced as written for pixel parity).
- ``envmap_color``     <- Miss                  (RayTracing.hlsl:127-137):
  equirect *texel index* fetch (no filtering; the declared sampler s0 is
  never used), theta from atan2(x, z), phi from acos(y), pi = 3.14159.
  Deviation (documented): D3D12 typed-buffer out-of-bounds reads return 0
  for the measure-zero directions where the index rounds to W or H; we
  clamp to the edge texel instead.

``xp`` is numpy or jax.numpy; all math is float32 in both backends.
"""

from __future__ import annotations

from refraction.config import REF_PI_ENVMAP


def dot3(a, b, xp):
    return xp.sum(a * b, axis=-1)


def normalize(v, xp):
    return v / xp.sqrt(xp.sum(v * v, axis=-1, keepdims=True))


def reflect_dir(i, n, xp):
    """ReflectRay: I - 2 dot(N, I) N   (RayTracing.hlsl:66-68)."""
    return i - 2.0 * dot3(n, i, xp)[..., None] * n


def refract_dir(i, n, eta, xp):
    """RefractRay (RayTracing.hlsl:70-76).

    Returns (ok_mask, refracted_unit_dir). Where ok is False (total internal
    reflection, k < 0) the direction is garbage and must be masked out.
    ``eta`` may be per-ray, shaped (...,).
    """
    cosi = dot3(n, i, xp)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    ok = k >= 0.0
    k_safe = xp.where(ok, k, 0.0)
    r = eta[..., None] * i - (eta * cosi + xp.sqrt(k_safe))[..., None] * n
    # Reference normalizes the refracted direction (RayTracing.hlsl:74).
    denom = xp.sqrt(xp.sum(r * r, axis=-1, keepdims=True))
    r = r / xp.where(denom > 0, denom, 1.0)
    return ok, r


def fresnel_r(dot_d_n, r0):
    """Nonstandard Schlick (RayTracing.hlsl:92-93); dot_d_n = dot(D, N')."""
    base = 1.0 - dot_d_n
    return (r0 * (1.0 - r0)) * (base * base) * (base * base) * base


def envmap_color(dirs, envmap, xp, int_dtype=None):
    """Miss shader (RayTracing.hlsl:130-135): mask is always (1,1,1)."""
    h, w = envmap.shape[0], envmap.shape[1]
    pi = xp.float32(REF_PI_ENVMAP)
    theta = w * (xp.arctan2(dirs[..., 0], dirs[..., 2]) / pi + 1.0) / 2.0
    phi = h * (xp.arccos(xp.clip(dirs[..., 1], -1.0, 1.0)) / pi)
    idt = int_dtype if int_dtype is not None else xp.int32
    ix = xp.clip(theta.astype(idt), 0, w - 1)
    iy = xp.clip(phi.astype(idt), 0, h - 1)
    return envmap[iy, ix]
