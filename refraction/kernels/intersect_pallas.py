"""Closest-hit intersection kernel for Hopper GPUs (Pallas, Triton route).

The software replacement for DXR's hardware ``TraceRay`` traversal. It
implements the ``IntersectFn`` contract of ``integrator.py`` and agrees
with ``ops/intersect.py`` (same Möller–Trumbore formulas, same facing,
interval and instance-mask rules, same lowest-index tie-break).

Design:

- One program traces a block of ``BLOCK`` consecutive pool slots. The
  render layer orders pixels in 32x32 image tiles (``render.tile_order``)
  and every wavefront round keeps a child in its parent's slot order, so a
  block is a compact image patch whose rays travel together.
- The scene's triangles are sorted into equal-size clusters, each split
  into subclusters of ``scene.SUB_TRIS`` triangles, with a box for each
  (``scene.build_scene``). The program walks clusters in ascending order
  with ``lax.fori_loop``. A cluster is visited only when some *live* ray
  of the block enters its box nearer than that ray's current best hit
  (``lax.cond``); inside, each subcluster is gated the same way, and a
  visited subcluster is tested against the whole block as one
  ``(BLOCK, SUB_TRIS)`` tile. Blocks with no live ray skip everything.
- A strict ``t < best`` update over ascending triangle order keeps the
  lowest triangle index on exact ties, as ``argmin`` does in the brute
  force.
- Boxes are widened by a small scene-relative margin so that rounding in
  the slab test can never cull a box that holds a hit the brute force
  would report.
- The kernel returns no shading normal: the integrator gathers it for
  the winner.

The geometry is passed as separate float32 columns, because the Triton
route loads only power-of-two shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from refraction.scene import SUB_TRIS, Scene

# Rays per program and warps per program: the fastest pair of a sweep on
# an H100 at both stand-in sizes (PERF.md). Likely why one warp wins: the
# block-wide "any ray enters this box" reduction needs no barrier then.
BLOCK = 64
NUM_WARPS = 1
NUM_STAGES = 1

_BIG = 3.0e38
# Box margin, relative to the scene's largest coordinate magnitude.
_BOX_PAD = 1e-5
# Direction components smaller than this are clamped before the slab
# test's reciprocal, so (lo - o) * inv is never 0 * inf.
_TINY_DIR = 1e-20

_ALIVE = 1
_WANT_FRONT = 2


def _kernel(lim_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            flags_ref, *refs, n_clusters, subs_per_cluster, masked):
    if masked:
        rmask_ref, *refs = refs
    (ax_ref, ay_ref, az_ref, e1x_ref, e1y_ref, e1z_ref, e2x_ref, e2y_ref,
     e2z_ref, clx_ref, cly_ref, clz_ref, chx_ref, chy_ref, chz_ref,
     slx_ref, sly_ref, slz_ref, shx_ref, shy_ref, shz_ref, *refs) = refs
    if masked:
        tmask_ref, *refs = refs
    t_out, i_out = refs

    f32 = jnp.float32
    tmin = lim_ref[0]
    tmax = lim_ref[1]
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    flags = flags_ref[...]
    live = (flags & _ALIVE) != 0
    want_front = (flags & _WANT_FRONT) != 0
    rmask = rmask_ref[...] if masked else None

    def inv(d):
        return f32(1.0) / jnp.where(jnp.abs(d) < _TINY_DIR, f32(_TINY_DIR), d)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    def any_enters(lx, ly, lz, hx, hy, hz, best):
        # Slab test of every ray against one box, limited to
        # [tmin, min(best, tmax)]; true if some live ray enters it.
        ax0, ax1 = (lx - ox) * ix, (hx - ox) * ix
        ay0, ay1 = (ly - oy) * iy, (hy - oy) * iy
        az0, az1 = (lz - oz) * iz, (hz - oz) * iz
        enter = jnp.maximum(
            jnp.maximum(jnp.minimum(ax0, ax1), jnp.minimum(ay0, ay1)),
            jnp.maximum(jnp.minimum(az0, az1), tmin))
        leave = jnp.minimum(
            jnp.minimum(jnp.maximum(ax0, ax1), jnp.maximum(ay0, ay1)),
            jnp.minimum(jnp.maximum(az0, az1), jnp.minimum(best, tmax)))
        ok = live & (enter <= leave)
        return jnp.max(ok.astype(jnp.int32)) > 0

    # Ray columns as (block, 1) for the (block, SUB_TRIS) triangle tile.
    rox, roy, roz = ox[:, None], oy[:, None], oz[:, None]
    rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]
    rwf = want_front[:, None]
    rlive = live[:, None]

    def test_sub(s, carry):
        best_t, best_i = carry
        win = pl.ds(s * SUB_TRIS, SUB_TRIS)
        ax, ay, az = ax_ref[win][None], ay_ref[win][None], az_ref[win][None]
        e1x, e1y, e1z = (e1x_ref[win][None], e1y_ref[win][None],
                         e1z_ref[win][None])
        e2x, e2y, e2z = (e2x_ref[win][None], e2y_ref[win][None],
                         e2z_ref[win][None])
        # Möller–Trumbore, term for term as ops/intersect.intersect_closest.
        px = rdy * e2z - rdz * e2y
        py = rdz * e2x - rdx * e2z
        pz = rdx * e2y - rdy * e2x
        det = e1x * px + e1y * py + e1z * pz
        accept = jnp.where(rwf, det > 0, det < 0)
        if masked:
            tm = tmask_ref[win][None]
            accept = accept & ((tm & rmask[:, None]) != 0)
        inv_det = f32(1.0) / jnp.where(det == 0, f32(1.0), det)
        tx, ty, tz = rox - ax, roy - ay, roz - az
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = (rlive & accept & (det != 0) & (u >= 0) & (v >= 0)
               & (u + v <= 1) & (t >= tmin) & (t <= tmax))
        t_sel = jnp.where(hit, t, f32(_BIG))
        t_min = jnp.min(t_sel, axis=1)
        i_min = jnp.argmin(t_sel, axis=1).astype(jnp.int32)
        better = t_min < best_t
        return (jnp.where(better, t_min, best_t),
                jnp.where(better, s * SUB_TRIS + i_min, best_i))

    def visit_sub(s, carry):
        hit_box = any_enters(slx_ref[s], sly_ref[s], slz_ref[s],
                             shx_ref[s], shy_ref[s], shz_ref[s], carry[0])
        return jax.lax.cond(hit_box, test_sub, lambda s, c: c, s, carry)

    def test_cluster(c, carry):
        first = c * subs_per_cluster
        return jax.lax.fori_loop(first, first + subs_per_cluster, visit_sub,
                                 carry)

    def visit_cluster(c, carry):
        hit_box = any_enters(clx_ref[c], cly_ref[c], clz_ref[c],
                             chx_ref[c], chy_ref[c], chz_ref[c], carry[0])
        return jax.lax.cond(hit_box, test_cluster, lambda c, k: k, c, carry)

    def traverse(carry):
        return jax.lax.fori_loop(0, n_clusters, visit_cluster, carry)

    init = (jnp.full(ox.shape, _BIG, f32), jnp.zeros(ox.shape, jnp.int32))
    any_live = jnp.max(live.astype(jnp.int32)) > 0
    best_t, best_i = jax.lax.cond(any_live, traverse, lambda c: c, init)
    t_out[...] = best_t
    i_out[...] = best_i


def _columns(x):
    return [x[:, k] for k in range(x.shape[1])]


def _pad(x, n, fill):
    return jnp.concatenate([x, jnp.full((n - x.shape[0],) + x.shape[1:],
                                        fill, x.dtype)])


def pallas_intersect(scene: Scene, origins, dirs, want_front, alive, tmin,
                     tmax, ray_mask=None, *, interpret: bool = False):
    """Closest hit of every live ray: the ``IntersectFn`` contract
    (``integrator.py``), returning ``(hit, t, tri_idx, None)``.

    Dead lanes (``alive`` False) never hit. ``ray_mask`` ((N,) int32) is
    DXR's per-ray InstanceInclusionMask: triangle j is testable by ray i
    iff ``scene.tri_mask[j] & ray_mask[i] != 0``.

    ``interpret=True`` runs the kernel through the Pallas interpreter
    (CPU tests). Otherwise it compiles through Triton and needs a GPU.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "pallas_intersect compiles for a GPU only; "
            f"the default backend is {jax.default_backend()!r} "
            "(pass interpret=True to run the kernel in the interpreter)")
    if SUB_TRIS & (SUB_TRIS - 1):
        raise ValueError(f"SUB_TRIS={SUB_TRIS} must be a power of two")
    n_tris = scene.tri_a.shape[0]
    n_clusters = scene.cluster_lo.shape[0]
    cluster_size = n_tris // max(n_clusters, 1)
    if (n_clusters == 0 or cluster_size * n_clusters != n_tris
            or cluster_size % SUB_TRIS
            or scene.sub_bounds.shape[0] * SUB_TRIS != n_tris):
        raise ValueError(
            f"scene layout does not fit the kernel: {n_tris} triangles, "
            f"{n_clusters} clusters, {scene.sub_bounds.shape[0]} "
            f"subclusters of {SUB_TRIS}")
    masked = ray_mask is not None
    if masked and scene.tri_mask is None:
        raise ValueError(
            "ray_mask given but the scene has no tri_mask to test it against")

    f32 = jnp.float32
    n = origins.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    o = _pad(jnp.asarray(origins, f32), n_pad, 0.0)
    d = _pad(jnp.asarray(dirs, f32), n_pad, 1.0)
    flags = (jnp.asarray(alive, bool).astype(jnp.int32) * _ALIVE
             + jnp.asarray(want_front, bool).astype(jnp.int32) * _WANT_FRONT)
    flags = _pad(flags, n_pad, 0)
    lim = jnp.stack([jnp.asarray(tmin, f32), jnp.asarray(tmax, f32)])

    lo = jnp.asarray(scene.cluster_lo, f32)
    hi = jnp.asarray(scene.cluster_hi, f32)
    sub = jnp.asarray(scene.sub_bounds, f32)
    pad = f32(_BOX_PAD) * jnp.maximum(
        f32(1.0), jnp.maximum(jnp.max(jnp.abs(lo)), jnp.max(jnp.abs(hi))))
    geometry = (
        _columns(jnp.asarray(scene.tri_a, f32))
        + _columns(jnp.asarray(scene.tri_e1, f32))
        + _columns(jnp.asarray(scene.tri_e2, f32))
        + _columns(lo - pad) + _columns(hi + pad)
        + _columns(sub[:, :3] - pad) + _columns(sub[:, 3:] + pad))

    rays = _columns(o) + _columns(d) + [flags]
    if masked:
        rays.append(_pad(jnp.asarray(ray_mask, jnp.int32), n_pad, 0))
    args = [lim, *rays, *geometry]
    if masked:
        geometry.append(jnp.asarray(scene.tri_mask, jnp.int32))
        args.append(geometry[-1])

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,))

    t, idx = pl.pallas_call(
        partial(_kernel, n_clusters=n_clusters,
                subs_per_cluster=cluster_size // SUB_TRIS, masked=masked),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), f32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        grid=(n_pad // BLOCK,),
        in_specs=[whole(lim)] + [ray_spec] * len(rays)
        + [whole(g) for g in geometry],
        out_specs=(ray_spec, ray_spec),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="closest_hit",
    )(*args)
    t, idx = t[:n], idx[:n]
    return t < f32(_BIG), t, idx, None
