"""Slow, trivially-correct NumPy path tracer — the behavioral oracle.

A direct transcription of the reference's recursive GPU ray program
(SURVEY.md 3.3; RayTracing.hlsl RayGen:42 / ClosestHit:79 / Miss:127) using
real recursion over batched rays, with none of the wavefront
restructuring. The wavefront integrator and the intersection kernel are
validated against this by
image diff (tests/test_golden.py).

Semantics per ray (payload {color, mask=1, outside, count}):

  trace(O, D, outside, count):
      hit <- closest hit, culling BACK faces when outside else FRONT
      if miss:           return envmap(D)                      (hlsl:127-137)
      if count >= 5:     return black                          (hlsl:82)
      N  <- normalize(barycentric lerp of vertex normals)      (hlsl:83-86)
      N' <- outside ? N : -N
      R  <- R0(1-R0)(1 - dot(D, N'))^5                         (hlsl:92-93)
      c  <- 0
      if refract(D, N', outside ? 1/1.3 : 1.3) succeeds:       (hlsl:95-108)
          c += (1-R) * trace(hit, refr, !outside, count+1)
      if count < 2:                                            (hlsl:110-123)
          c += R * trace(hit, normalize(reflect(D, N')), outside, count+1)
      return c

Child rays use TMin 1e-3 / TMax 1000 (hlsl:99-100,114-115); primaries
1e-4 / 100 (hlsl:52-53). Children traced from the uninitialized-color
payload contribute 0 when they hit at the depth cap — we define the DXR
undefined value as black.
"""

from __future__ import annotations

import numpy as np

from refraction.camera import CameraFrame, generate_rays, orbit_camera
from refraction.config import RenderConfig
from refraction.ops.intersect import closest_hit_chunked
from refraction.ops.shade import (
    envmap_color,
    fresnel_r,
    normalize,
    reflect_dir,
    refract_dir,
)
from refraction.scene import Scene


def trace_batch(
    scene: Scene,
    origins: np.ndarray,
    dirs: np.ndarray,
    outside: np.ndarray,
    count: int,
    cfg: RenderConfig,
    tmin: float,
    tmax: float,
) -> np.ndarray:
    """Recursive trace of a batch of rays; returns (N, 3) colors."""
    n = origins.shape[0]
    colors = np.zeros((n, 3), np.float32)
    if n == 0:
        return colors

    hit, t, idx, u, v = closest_hit_chunked(
        origins, dirs, scene, np.float32(tmin), np.float32(tmax),
        want_front=outside, xp=np,
    )

    miss = ~hit
    if miss.any():
        colors[miss] = envmap_color(dirs[miss], scene.envmap, np)

    live = hit & (count < cfg.max_refract_depth)
    if not live.any():
        return colors

    o = origins[live]
    d = dirs[live]
    outs = outside[live]
    tt = t[live]
    tri = idx[live]
    uu = u[live][:, None]
    vv = v[live][:, None]

    norms = scene.tri_norm[tri]  # (M, 3, 3)
    nsh = normalize(
        norms[:, 0] + uu * (norms[:, 1] - norms[:, 0]) + vv * (norms[:, 2] - norms[:, 0]),
        np,
    )
    nprime = np.where(outs[:, None], nsh, -nsh)
    hit_p = o + tt[:, None] * d

    dot_dn = np.sum(d * nprime, axis=-1)
    r = fresnel_r(dot_dn, np.float32(cfg.fresnel_r0))[:, None]

    eta = np.where(outs, np.float32(1.0 / cfg.ior), np.float32(cfg.ior))
    ok, refr = refract_dir(d, nprime, eta, np)

    acc = np.zeros_like(hit_p)
    if ok.any():
        child = trace_batch(
            scene, hit_p[ok], refr[ok], ~outs[ok], count + 1, cfg,
            cfg.secondary_tmin, cfg.secondary_tmax,
        )
        acc[ok] += (1.0 - r[ok]) * child
    if count < cfg.max_reflect_depth:
        refl = normalize(reflect_dir(d, nprime, np), np)
        child = trace_batch(
            scene, hit_p, refl, outs, count + 1, cfg,
            cfg.secondary_tmin, cfg.secondary_tmax,
        )
        acc += r * child
    colors[live] = acc
    return colors


def render_oracle(
    scene: Scene,
    cfg: RenderConfig,
    angle: float = 0.01,
    frame: CameraFrame | None = None,
    jitter: np.ndarray | None = None,
) -> np.ndarray:
    """Render one frame, (H, W, 3) float32."""
    if frame is None:
        frame = orbit_camera(angle, cfg)
    origins, dirs = generate_rays(frame, cfg.width, cfg.height, jitter=jitter, xp=np)
    outside = np.ones(origins.shape[0], bool)
    colors = trace_batch(
        scene, origins.astype(np.float32), dirs.astype(np.float32), outside, 0,
        cfg, cfg.primary_tmin, cfg.primary_tmax,
    )
    return colors.reshape(cfg.height, cfg.width, 3)
