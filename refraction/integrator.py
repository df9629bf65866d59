"""Wavefront integrator: the DXR recursion flattened into static rounds.

The reference's per-pixel recursive ray *tree* (SURVEY.md 3.3) has a bounded,
statically known shape: the refraction chain is at most ``max_refract_depth``
deep (RayTracing.hlsl:82) and reflection branches split only while
``count < max_reflect_depth`` (RayTracing.hlsl:110). Flattened
level-synchronously, the live ray front at count k therefore has width
exactly ``N * 2^min(k, max_reflect_depth)``:

    count:   0    1     2     3     4     5
    width:   N    2N    4N    4N    4N    4N      (defaults 5/2)

which lets the whole integrator run as an *unrolled* loop over counts with
fully static shapes — no dynamic allocation, no scatter: a refraction child
overwrites its parent's slot, a reflection child lands at ``slot + width``.
Dead rays are masked lanes. Because children always occupy
``slot mod N == pixel``, the final radiance is just a masked
weight * envmap accumulation reshaped to (k, N, 3) and summed — the
wavefront equivalent of DXR's recursive payload propagation.

Wavefront invariant: every state update and accumulation is routed through
``where(alive, ...)`` so dead lanes can never poison live ones with NaN/Inf.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from refraction.config import RenderConfig
from refraction.ops.intersect import recompute_uv
from refraction.ops.shade import (
    envmap_color,
    fresnel_r,
    normalize,
    reflect_dir,
    refract_dir,
)
from refraction.scene import Scene

# An intersect backend maps
#   (scene, origins (W,3), dirs (W,3), want_front (W,), alive (W,), tmin, tmax)
#   -> (hit (W,), t (W,), tri_idx (W,), normal (W,3) | None)
# where normal, if provided, is the winning triangle's interpolated
# (unnormalized) shading normal — kernels that already touch the winning
# triangle report it directly, sparing the integrator a per-ray gather.
IntersectFn = Callable[..., tuple]

_SAFE_DIR = (0.0, 1.0, 0.0)


def _shade_hits(scene: Scene, o, d, outside, t, tri_idx, cfg: RenderConfig,
                knorm=None):
    """ClosestHit math (RayTracing.hlsl:79-123) for a batch of hit rays.

    Returns (hit_point, n_prime, fresnel_R, refract_ok, refract_dir).
    Only meaningful where the caller's hit mask is True. ``knorm`` is the
    backend-provided interpolated normal, if any.
    """
    if knorm is not None:
        nsh = normalize(knorm, jnp)
    else:
        u, v = recompute_uv(o, d, scene.tri_a, scene.tri_e1, scene.tri_e2,
                            tri_idx, jnp)
        # Gather the 9 normal components as flat (W,) arrays rather than
        # one (W, 3, 3) block: each gather's result is a plain vector that
        # fuses straight into the interpolation below.
        tn = scene.tri_norm  # (T, 3, 3)
        comp = [tn[:, c, x][tri_idx] for c in range(3) for x in range(3)]
        a_n = jnp.stack(comp[0:3], axis=-1)
        b_n = jnp.stack(comp[3:6], axis=-1)
        c_n = jnp.stack(comp[6:9], axis=-1)
        nsh = normalize(
            a_n + u[:, None] * (b_n - a_n) + v[:, None] * (c_n - a_n),
            jnp,
        )
    nprime = jnp.where(outside[:, None], nsh, -nsh)
    hit_p = o + t[:, None] * d
    dot_dn = jnp.sum(d * nprime, axis=-1)
    r = fresnel_r(dot_dn, jnp.float32(cfg.fresnel_r0))
    eta = jnp.where(outside, jnp.float32(1.0 / cfg.ior), jnp.float32(cfg.ior))
    ok, refr = refract_dir(d, nprime, eta, jnp)
    return hit_p, nprime, r, ok, refr


def render_pixels(
    scene: Scene,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    cfg: RenderConfig,
    intersect_fn: IntersectFn,
    collect_stats: bool = False,
    ray_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Trace N primary rays to completion; returns (N, 3) linear radiance.

    Misses shade with the envmap texel gather (``ops/shade.envmap_color``),
    which XLA fuses into the miss math. With ``collect_stats`` returns
    (radiance, {'rays_traced': int32 scalar, 'slot_rounds': int,
    'pixel_rays': (N,) int32}) where rays_traced counts *live* lanes
    entering each trace round (the honest Mrays/s numerator),
    slot_rounds the dense slot count, and pixel_rays the per-pixel live
    ray-tree size (every pool width is N*2^k and lane i belongs to pixel
    i % N, so the per-pixel count is a reshape-sum — the bounce-heatmap
    source, SURVEY §5 metrics row).

    ``ray_mask`` ((N,) int32): per-ray DXR InstanceInclusionMask
    (TraceRay's mask parameter, RayTracing.hlsl:60 — the reference
    passes 0xff on every call). Children inherit their parent ray's
    mask, matching the shader's recursion (every recursive TraceRay
    re-passes 0xff). Both intersect backends take it.
    """
    n = origins.shape[0]
    f32 = jnp.float32
    safe_dir = jnp.asarray(_SAFE_DIR, f32)

    o = origins.astype(f32)
    d = dirs.astype(f32)
    weight = jnp.ones((n,), f32)
    outside = jnp.ones((n,), bool)
    alive = jnp.ones((n,), bool)
    mask_pool = (None if ray_mask is None
                 else jnp.asarray(ray_mask, jnp.int32))
    radiance = jnp.zeros((n, 3), f32)
    rays_traced = jnp.zeros((), jnp.int32)
    pixel_rays = jnp.zeros((n,), jnp.int32)
    slot_rounds = 0

    for count in range(cfg.max_refract_depth + 1):
        if collect_stats:
            rays_traced = rays_traced + jnp.sum(alive.astype(jnp.int32))
            pixel_rays = pixel_rays + alive.reshape(-1, n).sum(
                axis=0, dtype=jnp.int32)
            slot_rounds += int(o.shape[0])
        tmin = f32(cfg.primary_tmin if count == 0 else cfg.secondary_tmin)
        tmax = f32(cfg.primary_tmax if count == 0 else cfg.secondary_tmax)

        if ray_mask is None:
            res = intersect_fn(scene, o, d, outside, alive, tmin, tmax)
        else:
            res = intersect_fn(scene, o, d, outside, alive, tmin, tmax,
                               ray_mask=mask_pool)
        hit, t, tri_idx = res[0], res[1], res[2]
        knorm = res[3] if len(res) > 3 else None
        hit = hit & alive

        # Miss shading (RayTracing.hlsl:127-137): weight * envmap.
        miss_weight = jnp.where(alive & ~hit, weight, f32(0.0))
        miss_contrib = jnp.where(
            miss_weight[:, None] > 0,
            miss_weight[:, None] * envmap_color(d, scene.envmap, jnp), 0.0)
        radiance = radiance + miss_contrib.reshape(-1, n, 3).sum(axis=0)

        if count == cfg.max_refract_depth:
            break  # hits at the cap contribute black (RayTracing.hlsl:82)

        hit_p, nprime, r, refr_ok, refr = _shade_hits(
            scene, o, d, outside, t, tri_idx, cfg, knorm=knorm
        )
        safe_o = jnp.where(hit[:, None], hit_p, o)

        # Refraction child replaces its parent's slot (hlsl:95-108):
        # weight *= (1-R), outside flips, dies on TIR.
        refr_alive = hit & refr_ok
        new_d = jnp.where(refr_alive[:, None], refr, safe_dir)
        new_weight = jnp.where(refr_alive, weight * (f32(1.0) - r), f32(0.0))
        new_outside = jnp.where(hit, ~outside, outside)

        if count < cfg.max_reflect_depth:
            # Reflection child in fresh slots (hlsl:110-123): spawned on
            # every hit (even under TIR), weight *= R, same outside flag.
            refl = normalize(reflect_dir(d, nprime, jnp), jnp)
            refl_d = jnp.where(hit[:, None], refl, safe_dir)
            refl_weight = jnp.where(hit, weight * r, f32(0.0))
            o = jnp.concatenate([safe_o, safe_o])
            d = jnp.concatenate([new_d, refl_d])
            weight = jnp.concatenate([new_weight, refl_weight])
            outside = jnp.concatenate([new_outside, outside])
            alive = jnp.concatenate([refr_alive, hit])
            if mask_pool is not None:
                # Both children inherit the parent's inclusion mask
                # (the shader re-passes 0xff on every recursive
                # TraceRay — RayTracing.hlsl:106,121).
                mask_pool = jnp.concatenate([mask_pool, mask_pool])
        else:
            o, d = safe_o, new_d
            weight, outside, alive = new_weight, new_outside, refr_alive

    if collect_stats:
        return radiance, {"rays_traced": rays_traced,
                          "slot_rounds": slot_rounds,
                          "pixel_rays": pixel_rays}
    return radiance
